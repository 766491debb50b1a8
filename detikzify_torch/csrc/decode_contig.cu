// K3: single-token decode attention over a contiguous KV cache, reading
// only the rows each slot holds, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// detikzify_tpu/ops/decode_flash.py::decode_attend_pallas (-> _decode_kernel).
// Each slot b has one query row per head (q [B, NH, Hd]) and attends rows
// [0, lengths[b]) of its cache k/v [B, L, NKV, Hd]; lengths are clamped to
// [0, L]. Scores and softmax in fp32, p rounded to bf16 for the PV product
// with fp32 sums, out = acc / max(l, 1e-30). The TPU kernel reads a cache
// of any dtype; this one takes bf16 caches (detikzify_decode_contig) and
// float32 caches (detikzify_decode_contig_f32, every product an fp32 FFMA
// and p kept in fp32, the keys streamed through a ring of 16-row chunks,
// and no merge launch where L <= 128), at head_dim 32, 64 and 128.
//
// What bounds it on the H100: as K2, device-memory bytes,
// sum_b min(lengths[b], L) * NKV * Hd * 2 (K and V) * 2 bytes; the rows
// beyond a slot's length are never read.
//
// What the design does about it: K2's split-and-merge body
// (decode_split.cuh) with contiguous addressing. The rows of each (slot, KV
// head) are cut into 128-row splits, one block each, their count sized
// from L (the host never reads lengths); splits past a slot's length leave
// at once; fp32 partials go to scratch that the wrapper allocates, and a
// merge kernel launched as a programmatic dependent combines them in a
// fixed order. The per-slot batch stride is an argument, so a view
// kc[:, :kv_limit] of a longer cache is read in place: the caller never
// copies the cache to make it contiguous. Any L: the merge stages the split
// weights in chunks.
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
  const T *q, *k, *v;
  const int* lengths;
  T* out;
  int NH, NKV, L;
  long long stride_b;
};

// KV head h of slot b: the GQA group's G rows, all seeing the slot's
// length (clamped to L); row r of the slot at r * NKV * Hd past its base.
struct ContigSlot {
  int b, h, nkv, R, length;
  size_t base;
  int rs, NH;
  __device__ __forceinline__ size_t qrow(int r) const {
    return (size_t)b * NH + h * R + r;
  }
  __device__ __forceinline__ int limit(int) const { return length; }
  __device__ __forceinline__ size_t kv(int row0) const {
    return base + (size_t)row0 * rs;
  }
};

template <int HD, class T>
__device__ __forceinline__ ContigSlot slot(const Args<T>& a, int b, int h) {
  return {b, h, a.NKV, a.NH / a.NKV, max(0, min(a.lengths[b], a.L)),
          (size_t)b * (size_t)a.stride_b + (size_t)h * HD, a.NKV * HD, a.NH};
}

template <class T, int HD>
__global__ void __launch_bounds__(WARPS * 32, ds::min_blocks(1, WARPS))
contig_split_kernel(Args<T> a, ds::Partials part, int nsplit, int,
                    float sl) {
  ds::split_block<HD, 1, WARPS>(a.q, a.k, a.v, a.out, part, blockIdx.x,
                                nsplit, 0, sl,
                                slot<HD>(a, blockIdx.z, blockIdx.y));
}

template <class T, int HD>
__global__ void __launch_bounds__(HD)
contig_merge_kernel(Args<T> a, ds::Partials part, int nsplit) {
  ds::merge_partials<HD, WARPS>(part, a.out, nsplit, blockIdx.x,
                                slot<HD>(a, blockIdx.z, blockIdx.y));
}

template <class T, int HD>
int launch(const Args<T>& a, ds::Partials part, int B, int nsplit, float sl,
           cudaStream_t st) {
  return ds::launch_split_merge<HD, 1, WARPS, T>(
      contig_split_kernel<T, HD>, contig_merge_kernel<T, HD>, a, part, B,
      a.NKV, a.NH / a.NKV, nsplit, 1, sl, st);
}

// the entry points' body, for T = bf16 or float; stride_b keeps rows
// 16-byte aligned
template <class T>
int decode_contig(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, void* scratch,
                  long long scratch_floats, int B, int NH, int NKV, int Hd,
                  int L, long long stride_b, float scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (NKV <= 0 || NH % NKV != 0 || NH / NKV > MAXG || L <= 0 ||
      stride_b % (16 / (long long)sizeof(T)) != 0)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (L + SPLIT - 1) / SPLIT;
  const long long recs = (long long)B * NH * nsplit;
  if (scratch == nullptr || scratch_floats < recs * (Hd + 2))
    return (int)cudaErrorInvalidValue;
  float* f = static_cast<float*>(scratch);
  const ds::Partials part{f, f + recs * Hd};
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const int*>(lengths),
                  static_cast<T*>(out), NH, NKV, L, stride_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl = scale * ds::LOG2E;
  if (Hd == 128) return launch<T, 128>(a, part, B, nsplit, sl, st);
  if (Hd == 64) return launch<T, 64>(a, part, B, nsplit, sl, st);
  if (Hd == 32) return launch<T, 32>(a, part, B, nsplit, sl, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B,NH,Hd] contiguous; k/v [B,L,NKV,Hd] with strides (stride_b,
// NKV*Hd, Hd, 1) in elements, 16-byte aligned rows; out [B,NH,Hd]: bf16
// (detikzify_decode_contig) or float32 (detikzify_decode_contig_f32);
// lengths [B] int32; scratch fp32 of at least
// B * NKV * ceil(L / 128) * NH / NKV * (Hd + 2) floats (`scratch_floats`).
// Hd in {32, 64, 128}; NH / NKV at most 8.
int detikzify_decode_contig(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* scratch,
                            long long scratch_floats, int B, int NH, int NKV,
                            int Hd, int L, long long stride_b, float scale,
                            void* stream) {
  return decode_contig<__nv_bfloat16>(q, k, v, lengths, out, scratch,
                                      scratch_floats, B, NH, NKV, Hd, L,
                                      stride_b, scale, stream);
}

int detikzify_decode_contig_f32(const void* q, const void* k, const void* v,
                                const void* lengths, void* out,
                                void* scratch, long long scratch_floats,
                                int B, int NH, int NKV, int Hd, int L,
                                long long stride_b, float scale,
                                void* stream) {
  return decode_contig<float>(q, k, v, lengths, out, scratch, scratch_floats,
                              B, NH, NKV, Hd, L, stride_b, scale, stream);
}

const char* detikzify_decode_contig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

const char* detikzify_decode_contig_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
