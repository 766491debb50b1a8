// K2: single-token decode attention straight from the paged KV pool, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// detikzify_tpu/ops/paged.py::decode_attend_paged_pallas (-> _paged_kernel).
// Each slot b has one query row per head (q [B, NH, Hd]) and attends rows
// [0, lengths[b]) of its sequence, whose row r lives in pool page
// tab[b, r / page] at row r % page. Online softmax in fp32, p and V in fp32
// for the PV sum, and out = acc / max(l, 1e-30), as the TPU kernel does.
//
// What bounds it on the H100: every live K/V row is read once and used for
// only 2 * G * Hd FLOP per element pair (G = NH / NKV query rows), so it is
// bound by device-memory bytes: sum_b lengths[b] * NKV * Hd * 2 (K and V)
// * 2 bytes.
//
// What the design does about it: one block per (slot, KV head) reads the
// slot's page ids from the table itself (there is no scalar prefetch),
// walks only ceil(lengths[b] / 64) chunks of 64 rows, and loads each chunk
// of K and V once into shared memory with 16-byte coalesced loads (each
// row's head slice is Hd contiguous bf16). The whole GQA group (4 query rows
// at v2-8b) is computed against each loaded row, so K/V is read once per
// group and never gathered into a contiguous copy. The pool stays in its
// native [P, page, NKV, Hd] layout. A single pass over the chunks keeps the
// kernel simple; splitting long sequences across blocks is later work. The
// body is shared with K3 (decode_attn.cuh); this file supplies the
// page-table addressing.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attn.cuh"

namespace {

using detikzify_decode::CHUNK;
using detikzify_decode::MAXG;
using detikzify_decode::THREADS;

// Element offset of row row0 of KV head h of slot b: through the slot's
// page table (rows of one chunk share a page, since page % CHUNK == 0).
struct PagedRows {
  const int* tab_row;
  int page, rs, head_off;
  __device__ __forceinline__ size_t operator()(int row0) const {
    const int pid = tab_row[row0 / page];
    return ((size_t)pid * page + row0 % page) * rs + head_off;
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ pool_k,
                    const __nv_bfloat16* __restrict__ pool_v,
                    const int* __restrict__ tab,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out,
                    int NH, int NKV, int page, int m, int tab_stride,
                    float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int length = max(0, min(lengths[b], m * page));
  const PagedRows rows{tab + (size_t)b * tab_stride, page, NKV * HD, h * HD};
  detikzify_decode::decode_group<HD>(q, pool_k, pool_v, out, b, h, NH, NKV,
                                     length, scale, rows);
}

}  // namespace

extern "C" {

// q [B,NH,Hd] bf16, pool_k/pool_v [P,page,NKV,Hd] bf16 contiguous,
// tab [B, >= m] int32 with row stride tab_stride, lengths [B] int32,
// out [B,NH,Hd] bf16. Hd in {64, 128}; page a multiple of 64;
// NH / NKV at most 8.
int detikzify_paged_decode(const void* q, const void* pool_k,
                           const void* pool_v, const void* tab,
                           const void* lengths, void* out, int B, int NH,
                           int NKV, int Hd, int page, int m, int tab_stride,
                           float scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (NKV <= 0 || NH % NKV != 0 || NH / NKV > MAXG || page % CHUNK != 0 ||
      m <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(B, NKV);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* pk = static_cast<const __nv_bfloat16*>(pool_k);
  const __nv_bfloat16* pv = static_cast<const __nv_bfloat16*>(pool_v);
  const int* tb = static_cast<const int*>(tab);
  const int* ln = static_cast<const int*>(lengths);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (Hd == 128)
    paged_decode_kernel<128><<<grid, THREADS, 0, st>>>(
        qq, pk, pv, tb, ln, o, NH, NKV, page, m, tab_stride, scale);
  else if (Hd == 64)
    paged_decode_kernel<64><<<grid, THREADS, 0, st>>>(
        qq, pk, pv, tb, ln, o, NH, NKV, page, m, tab_stride, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* detikzify_paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
