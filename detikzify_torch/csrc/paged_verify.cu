// K4: speculative verify-window attention straight from the paged KV pool,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// detikzify_tpu/ops/paged.py::decode_verify_attend_paged_pallas
// (-> _verify_kernel). Slot b has K1 = K + 1 query rows per head
// (q [B, K1, NH, Hd]: the last accepted token and K drafts, whose K/V rows
// the caller has already written at pool rows starts[b] .. starts[b] + K);
// row j attends rows [0, starts[b] + j + 1) of the slot's sequence, read
// through its page table, and every limit is clamped to the table's
// m * page rows exactly as the TPU kernel clamps it (paged.py:244-249). A
// dead slot arrives with start 0 and sees rows [0, j + 1): its output
// stays finite. The TPU kernel reads a pool of any dtype; this one takes
// bf16 pools (detikzify_paged_verify) and float32 pools
// (detikzify_paged_verify_f32, every product an fp32 FFMA and p kept in
// fp32, the keys streamed through a ring of 16-row chunks, and no merge
// launch where the table holds one 128-row split), at head_dim 32, 64 and
// 128 (the JAX package sends head_dim 32 to XLA; the same function here).
//
// What bounds it on the H100: every valid K/V row is read once and used
// for 2 * G * K1 * Hd FLOP per element pair (G * K1 = 20 query rows at
// v2-8b with K = 4), still far below the card's ~295 FLOP/byte ridge, so it
// is bound by device-memory bytes: sum_b min(starts[b] + K1, m * page)
// * NKV * Hd * 2 (K and V) * 2 bytes.
//
// What the design does about it: K2's split-and-merge body
// (decode_split.cuh). The query rows of one (slot, KV head) are the GQA
// group times K1 (flat row r = g * K1 + j, as the TPU kernel lays them
// out), each with its own key limit; the keys are cut into 128-row splits,
// one block each, sized from the table width (the host never reads
// starts), so K/V is read once per group and never gathered. The limits
// bite only in the one or two splits that hold rows [start, start + K1);
// there a row that sees no key of the split writes a partial of weight 0.
// Up to 24 rows run as one block per split with their accumulators in
// registers (3 query tiles of the mma.sync n8 side); more rows (up to 64)
// run in passes of at most 3 tiles, one block each. The fp32 partials
// (R * (Hd + 2) floats per live split and head) go to scratch that the
// wrapper allocates and are merged by a programmatic dependent kernel.
//
// Interface: plain C, launched on the caller's stream; returns a
// cudaError_t so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

namespace ds = detikzify_decode_split;

constexpr int WARPS = 4;         // per split block, 32 key rows each
constexpr int SPLIT = WARPS * ds::WROWS;
constexpr int MAXR = 64;         // query rows per (slot, KV head): G * K1
constexpr int MAXK1 = 8;         // verify-window rows per slot
constexpr int PAGE_ALIGN = 64;   // the wrapper's page rule

template <class T>
struct Args {
  const T *q, *pool_k, *pool_v;
  const int *tab, *starts;
  T* out;
  int K1, NH, NKV, page, m, tab_stride;
};

// KV head h of slot b: rows r = g * K1 + j, row j of the window seeing
// keys [0, min(start + j + 1, m * page)); K/V rows through the page table.
struct VerifySlot {
  int b, h, nkv, R, length;
  const int* tab_row;
  int page, rs, head_off, NH, K1, G, start, width;
  __device__ __forceinline__ size_t qrow(int r) const {
    return ((size_t)b * K1 + r % K1) * NH + h * G + r / K1;
  }
  __device__ __forceinline__ int limit(int r) const {
    return min(start + r % K1 + 1, width);
  }
  __device__ __forceinline__ size_t kv(int row0) const {
    const int pid = tab_row[row0 / page];
    return ((size_t)pid * page + row0 % page) * rs + head_off;
  }
};

template <int HD, class T>
__device__ __forceinline__ VerifySlot slot(const Args<T>& a, int b, int h) {
  const int G = a.NH / a.NKV, width = a.m * a.page;
  const int start = max(a.starts[b], 0);
  return {b, h, a.NKV, G * a.K1, min(start + a.K1, width),
          a.tab + (size_t)b * a.tab_stride, a.page, a.NKV * HD, h * HD,
          a.NH, a.K1, G, start, width};
}

template <class T, int HD, int NTP>
__global__ void __launch_bounds__(WARPS * 32, ds::min_blocks(NTP, WARPS))
verify_split_kernel(Args<T> a, ds::Partials part, int nsplit, int npass,
                    float sl) {
  const int h = blockIdx.y / npass, pass = blockIdx.y % npass;
  ds::split_block<HD, NTP, WARPS>(a.q, a.pool_k, a.pool_v, a.out, part,
                                  blockIdx.x, nsplit, pass * 8 * NTP, sl,
                                  slot<HD>(a, blockIdx.z, h));
}

template <class T, int HD>
__global__ void __launch_bounds__(HD)
verify_merge_kernel(Args<T> a, ds::Partials part, int nsplit) {
  ds::merge_partials<HD, WARPS>(part, a.out, nsplit, blockIdx.x,
                                slot<HD>(a, blockIdx.z, blockIdx.y));
}

template <class T, int HD, int NTP>
int launch_tiles(const Args<T>& a, ds::Partials part, int B, int R,
                 int nsplit, int npass, float sl, cudaStream_t st) {
  return ds::launch_split_merge<HD, NTP, WARPS, T>(
      verify_split_kernel<T, HD, NTP>, verify_merge_kernel<T, HD>, a, part,
      B, a.NKV, R, nsplit, npass, sl, st);
}

template <class T, int HD>
int launch(const Args<T>& a, ds::Partials part, int B, int R, int nsplit,
           float sl, cudaStream_t st) {
  const ds::RowPlan p = ds::plan_rows(R);
  if (p.ntp == 1)
    return launch_tiles<T, HD, 1>(a, part, B, R, nsplit, p.npass, sl, st);
  if (p.ntp == 2)
    return launch_tiles<T, HD, 2>(a, part, B, R, nsplit, p.npass, sl, st);
  return launch_tiles<T, HD, 3>(a, part, B, R, nsplit, p.npass, sl, st);
}

// the entry points' body, for T = bf16 or float
template <class T>
int paged_verify(const void* q, const void* pool_k, const void* pool_v,
                 const void* tab, const void* starts, void* out,
                 void* scratch, long long scratch_floats, int B, int K1,
                 int NH, int NKV, int Hd, int page, int m, int tab_stride,
                 float scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (NKV <= 0 || NH % NKV != 0 || K1 <= 0 || K1 > MAXK1 ||
      (NH / NKV) * K1 > MAXR || page % PAGE_ALIGN != 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  const int R = (NH / NKV) * K1;
  const int nsplit = (int)(((long long)m * page + SPLIT - 1) / SPLIT);
  const long long recs = (long long)B * NKV * nsplit * R;
  if (scratch == nullptr || scratch_floats < recs * (Hd + 2))
    return (int)cudaErrorInvalidValue;
  float* f = static_cast<float*>(scratch);
  const ds::Partials part{f, f + recs * Hd};
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(pool_k),
                  static_cast<const T*>(pool_v),
                  static_cast<const int*>(tab),
                  static_cast<const int*>(starts), static_cast<T*>(out),
                  K1, NH, NKV, page, m, tab_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl = scale * ds::LOG2E;
  if (Hd == 128) return launch<T, 128>(a, part, B, R, nsplit, sl, st);
  if (Hd == 64) return launch<T, 64>(a, part, B, R, nsplit, sl, st);
  if (Hd == 32) return launch<T, 32>(a, part, B, R, nsplit, sl, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B,K1,NH,Hd] contiguous, pool_k/pool_v [P,page,NKV,Hd] contiguous,
// out [B,K1,NH,Hd]: bf16 (detikzify_paged_verify) or float32
// (detikzify_paged_verify_f32); tab [B, >= m] int32 with row stride
// tab_stride, starts [B] int32, scratch fp32 of at least
// B * NKV * ceil(m * page / 128) * (NH / NKV) * K1 * (Hd + 2) floats
// (`scratch_floats`). Hd in {32, 64, 128}; page a multiple of 64; K1 <= 8
// and (NH / NKV) * K1 <= 64.
int detikzify_paged_verify(const void* q, const void* pool_k,
                           const void* pool_v, const void* tab,
                           const void* starts, void* out, void* scratch,
                           long long scratch_floats, int B, int K1, int NH,
                           int NKV, int Hd, int page, int m, int tab_stride,
                           float scale, void* stream) {
  return paged_verify<__nv_bfloat16>(q, pool_k, pool_v, tab, starts, out,
                                     scratch, scratch_floats, B, K1, NH, NKV,
                                     Hd, page, m, tab_stride, scale, stream);
}

int detikzify_paged_verify_f32(const void* q, const void* pool_k,
                               const void* pool_v, const void* tab,
                               const void* starts, void* out, void* scratch,
                               long long scratch_floats, int B, int K1,
                               int NH, int NKV, int Hd, int page, int m,
                               int tab_stride, float scale, void* stream) {
  return paged_verify<float>(q, pool_k, pool_v, tab, starts, out, scratch,
                             scratch_floats, B, K1, NH, NKV, Hd, page, m,
                             tab_stride, scale, stream);
}

const char* detikzify_paged_verify_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

const char* detikzify_paged_verify_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
