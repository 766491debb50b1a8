// K2: single-token decode attention straight from the paged KV pool, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// detikzify_tpu/ops/paged.py::decode_attend_paged_pallas (-> _paged_kernel).
// Each slot b has one query row per head (q [B, NH, Hd]) and attends rows
// [0, lengths[b]) of its sequence, whose row r lives in pool page
// tab[b, r / page] at row r % page. Scores and softmax in fp32, p rounded to
// bf16 for the PV product (as the plain version rounds it) with fp32 sums,
// and out = acc / max(l, 1e-30), as the TPU kernel does. The TPU kernel
// reads a pool of any dtype; this one takes bf16 pools
// (detikzify_paged_decode) and float32 pools (detikzify_paged_decode_f32,
// every product an fp32 FFMA and p kept in fp32, the keys streamed through
// a ring of 16-row chunks, and no merge launch where the table holds one
// 128-row split), at head_dim 32, 64 and 128 (the JAX package sends
// head_dim 32 to XLA; the same function here).
//
// What bounds it on the H100: every live K/V row is read once and used for
// only 2 * G * Hd FLOP per element pair (G = NH / NKV query rows), so it is
// bound by device-memory bytes: sum_b lengths[b] * NKV * Hd * 2 (K and V)
// * 2 bytes. Reaching the memory rate takes many bytes in flight on every
// SM; one block per (slot, KV head) gives 64 blocks at 8 slots, and the
// longest slot sets the time.
//
// What the design does about it (body in decode_split.cuh, shared with K3
// and K4): the rows of each (slot, KV head) are split into blocks of 128
// rows (flash-decoding), so 8 slots of up to 2048 rows make up to 1024
// blocks; the split count comes from the table width m, never from the
// values of `lengths` (the host never reads them), and splits past a
// slot's length leave at once. Each block reads its page ids from the
// table itself (there is no scalar prefetch) and puts all of its rows in
// flight at once with cp.async, 32 rows per warp, K before V. Both products
// run on the tensor cores (mma.sync, the GQA group as the 8-wide side), so
// the arithmetic stays far below the copy time; K/V are read once per group
// and never gathered into a contiguous copy. Each block writes an fp32
// partial to scratch that the wrapper allocates; a merge kernel, launched
// as a programmatic dependent of the split kernel, combines the live
// splits in a fixed order and writes the pool's type. The pool stays in its native
// [P, page, NKV, Hd] layout.
//
// Interface: plain C, launched on the caller's stream; returns a
// cudaError_t so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

namespace ds = detikzify_decode_split;

constexpr int WARPS = 4;                     // 128-row splits
constexpr int SPLIT = WARPS * ds::WROWS;
constexpr int MAXG = 8;                      // query rows per KV head

template <class T>
struct Args {
  const T *q, *pool_k, *pool_v;
  const int *tab, *lengths;
  T* out;
  int NH, NKV, page, m, tab_stride;
};

// KV head h of slot b: the GQA group's G rows, all seeing the slot's
// length (clamped to the table); K/V rows through the slot's page table
// (the 32 rows a warp copies share a page, since page % 32 == 0).
struct PagedSlot {
  int b, h, nkv, R, length;
  const int* tab_row;
  int page, rs, head_off, NH;
  __device__ __forceinline__ size_t qrow(int r) const {
    return (size_t)b * NH + h * R + r;
  }
  __device__ __forceinline__ int limit(int) const { return length; }
  __device__ __forceinline__ size_t kv(int row0) const {
    const int pid = tab_row[row0 / page];
    return ((size_t)pid * page + row0 % page) * rs + head_off;
  }
};

template <int HD, class T>
__device__ __forceinline__ PagedSlot slot(const Args<T>& a, int b, int h) {
  const int G = a.NH / a.NKV;
  return {b, h, a.NKV, G, max(0, min(a.lengths[b], a.m * a.page)),
          a.tab + (size_t)b * a.tab_stride, a.page, a.NKV * HD, h * HD, a.NH};
}

template <class T, int HD>
__global__ void __launch_bounds__(WARPS * 32, ds::min_blocks(1, WARPS))
paged_split_kernel(Args<T> a, ds::Partials part, int nsplit, int, float sl) {
  ds::split_block<HD, 1, WARPS>(a.q, a.pool_k, a.pool_v, a.out, part,
                                blockIdx.x, nsplit, 0, sl,
                                slot<HD>(a, blockIdx.z, blockIdx.y));
}

template <class T, int HD>
__global__ void __launch_bounds__(HD)
paged_merge_kernel(Args<T> a, ds::Partials part, int nsplit) {
  ds::merge_partials<HD, WARPS>(part, a.out, nsplit, blockIdx.x,
                                slot<HD>(a, blockIdx.z, blockIdx.y));
}

template <class T, int HD>
int launch(const Args<T>& a, ds::Partials part, int B, int nsplit, float sl,
           cudaStream_t st) {
  return ds::launch_split_merge<HD, 1, WARPS, T>(
      paged_split_kernel<T, HD>, paged_merge_kernel<T, HD>, a, part, B, a.NKV,
      a.NH / a.NKV, nsplit, 1, sl, st);
}

// the entry points' body, for T = bf16 or float
template <class T>
int paged_decode(const void* q, const void* pool_k, const void* pool_v,
                 const void* tab, const void* lengths, void* out,
                 void* scratch, long long scratch_floats, int B, int NH,
                 int NKV, int Hd, int page, int m, int tab_stride,
                 float scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (NKV <= 0 || NH % NKV != 0 || NH / NKV > MAXG ||
      page % ds::ROW_ALIGN != 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (int)(((long long)m * page + SPLIT - 1) / SPLIT);
  const long long recs = (long long)B * NH * nsplit;
  if (scratch == nullptr || scratch_floats < recs * (Hd + 2))
    return (int)cudaErrorInvalidValue;
  float* f = static_cast<float*>(scratch);
  const ds::Partials part{f, f + recs * Hd};
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(pool_k),
                  static_cast<const T*>(pool_v),
                  static_cast<const int*>(tab),
                  static_cast<const int*>(lengths), static_cast<T*>(out),
                  NH, NKV, page, m, tab_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl = scale * ds::LOG2E;
  if (Hd == 128) return launch<T, 128>(a, part, B, nsplit, sl, st);
  if (Hd == 64) return launch<T, 64>(a, part, B, nsplit, sl, st);
  if (Hd == 32) return launch<T, 32>(a, part, B, nsplit, sl, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B,NH,Hd], pool_k/pool_v [P,page,NKV,Hd] contiguous, out [B,NH,Hd]:
// bf16 (detikzify_paged_decode) or float32 (detikzify_paged_decode_f32);
// tab [B, >= m] int32 with row stride tab_stride, lengths [B] int32,
// scratch fp32 of at least
// B * NKV * ceil(m * page / 128) * NH / NKV * (Hd + 2) floats
// (`scratch_floats`). Hd in {32, 64, 128}; page a multiple of 32; NH / NKV
// at most 8.
int detikzify_paged_decode(const void* q, const void* pool_k,
                           const void* pool_v, const void* tab,
                           const void* lengths, void* out, void* scratch,
                           long long scratch_floats, int B, int NH, int NKV,
                           int Hd, int page, int m, int tab_stride,
                           float scale, void* stream) {
  return paged_decode<__nv_bfloat16>(q, pool_k, pool_v, tab, lengths, out,
                                     scratch, scratch_floats, B, NH, NKV, Hd,
                                     page, m, tab_stride, scale, stream);
}

int detikzify_paged_decode_f32(const void* q, const void* pool_k,
                               const void* pool_v, const void* tab,
                               const void* lengths, void* out, void* scratch,
                               long long scratch_floats, int B, int NH,
                               int NKV, int Hd, int page, int m,
                               int tab_stride, float scale, void* stream) {
  return paged_decode<float>(q, pool_k, pool_v, tab, lengths, out, scratch,
                             scratch_floats, B, NH, NKV, Hd, page, m,
                             tab_stride, scale, stream);
}

const char* detikzify_paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

const char* detikzify_paged_decode_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
