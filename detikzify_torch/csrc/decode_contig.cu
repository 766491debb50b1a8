// K3: single-token decode attention over a contiguous KV cache, reading
// only the rows each slot holds, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// detikzify_tpu/ops/decode_flash.py::decode_attend_pallas (-> _decode_kernel).
// Each slot b has one query row per head (q [B, NH, Hd]) and attends rows
// [0, lengths[b]) of its cache k/v [B, L, NKV, Hd]; lengths are clamped to
// [0, L]. Online softmax in fp32, out = acc / max(l, 1e-30).
//
// What bounds it on the H100: as K2, device-memory bytes,
// sum_b min(lengths[b], L) * NKV * Hd * 2 (K and V) * 2 bytes; the rows
// beyond a slot's length are never read.
//
// What the design does about it: the body of K2 (decode_attn.cuh) with
// contiguous addressing. One block per (slot, KV head) walks
// ceil(len / 64) chunks of 64 rows and computes the whole GQA group per
// loaded row. The per-slot batch stride is an argument, so a view
// kc[:, :kv_limit] of a longer cache is read in place: the caller never
// copies the cache to make it contiguous.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attn.cuh"

namespace {

using detikzify_decode::MAXG;
using detikzify_decode::THREADS;

// Element offset of row row0 of KV head h of one slot.
struct ContigRows {
  size_t base;
  int rs;
  __device__ __forceinline__ size_t operator()(int row0) const {
    return base + (size_t)row0 * rs;
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
contig_decode_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out,
                     int NH, int NKV, int L, long long stride_b, float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int length = max(0, min(lengths[b], L));
  const ContigRows rows{(size_t)b * (size_t)stride_b + (size_t)h * HD,
                        NKV * HD};
  detikzify_decode::decode_group<HD>(q, k, v, out, b, h, NH, NKV, length,
                                     scale, rows);
}

}  // namespace

extern "C" {

// q [B,NH,Hd] bf16 contiguous; k/v [B,L,NKV,Hd] bf16 with strides
// (stride_b, NKV*Hd, Hd, 1) in elements, 16-byte aligned rows;
// lengths [B] int32; out [B,NH,Hd] bf16. Hd in {64, 128}; NH / NKV at
// most 8.
int detikzify_decode_contig(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, int B, int NH,
                            int NKV, int Hd, int L, long long stride_b,
                            float scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (NKV <= 0 || NH % NKV != 0 || NH / NKV > MAXG || L <= 0 ||
      stride_b % 8 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(B, NKV);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kk = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vv = static_cast<const __nv_bfloat16*>(v);
  const int* ln = static_cast<const int*>(lengths);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (Hd == 128)
    contig_decode_kernel<128><<<grid, THREADS, 0, st>>>(
        qq, kk, vv, ln, o, NH, NKV, L, stride_b, scale);
  else if (Hd == 64)
    contig_decode_kernel<64><<<grid, THREADS, 0, st>>>(
        qq, kk, vv, ln, o, NH, NKV, L, stride_b, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* detikzify_decode_contig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
