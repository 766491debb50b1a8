// K2: single-token decode attention straight from the paged KV pool, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// detikzify_tpu/ops/paged.py::decode_attend_paged_pallas (-> _paged_kernel).
// Each slot b has one query row per head (q [B, NH, Hd]) and attends rows
// [0, lengths[b]) of its sequence, whose row r lives in pool page
// tab[b, r / page] at row r % page. Scores and softmax in fp32, p rounded to
// bf16 for the PV product (as the plain version rounds it) with fp32 sums,
// and out = acc / max(l, 1e-30), as the TPU kernel does.
//
// What bounds it on the H100: every live K/V row is read once and used for
// only 2 * G * Hd FLOP per element pair (G = NH / NKV query rows), so it is
// bound by device-memory bytes: sum_b lengths[b] * NKV * Hd * 2 (K and V)
// * 2 bytes. Reaching the memory rate takes many bytes in flight on every
// SM; one block per (slot, KV head) gives 64 blocks at 8 slots, and the
// longest slot sets the time.
//
// What the design does about it (body in decode_split.cuh): the rows of each
// (slot, KV head) are split into blocks of 128 rows (flash-decoding), so 8
// slots of up to 2048 rows make up to 1024 blocks; the split count comes
// from the table width m, never from the values of `lengths` (the host
// never reads them), and splits past a slot's length leave at once. Each
// block reads its page ids from the table itself (there is no scalar
// prefetch) and puts all of its rows in flight at once with cp.async, 32
// rows per warp, K before V; a warp computes its scores as soon as its K
// rows land, with its V rows still in flight. Both products run on the
// tensor cores (mma.sync, the GQA group as the 8-wide side), so the
// arithmetic stays far below the copy time; K/V are read once per group
// and never gathered into a contiguous copy. Each block writes an fp32
// partial (max, sum, acc[G, Hd]) to scratch that the wrapper allocates; a
// merge kernel, launched by the same entry point as a programmatic
// dependent of the split kernel (its launch overlaps the split kernel's
// tail), combines the live splits in a fixed order and writes bf16. The
// pool stays in its native [P, page, NKV, Hd] layout.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

using detikzify_decode_split::LOG2E;
using detikzify_decode_split::MAXG;
using detikzify_decode_split::MAX_SPLITS;
using detikzify_decode_split::ROW_ALIGN;
using detikzify_decode_split::Partials;
using detikzify_decode_split::SPLIT;
using detikzify_decode_split::Smem;
using detikzify_decode_split::THREADS;

// Element offset of row row0 of KV head h of slot b: through the slot's
// page table (the 32 rows a warp copies share a page, since
// page % ROW_ALIGN == 0).
struct PagedRows {
  const int* tab_row;
  int page, rs, head_off;
  __device__ __forceinline__ size_t operator()(int row0) const {
    const int pid = tab_row[row0 / page];
    return ((size_t)pid * page + row0 % page) * rs + head_off;
  }
};

__device__ __forceinline__ int clamped_length(const int* lengths, int b,
                                              int m, int page) {
  return max(0, min(lengths[b], m * page));
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 3)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ pool_k,
                   const __nv_bfloat16* __restrict__ pool_v,
                   const int* __restrict__ tab,
                   const int* __restrict__ lengths, Partials part, int NH,
                   int NKV, int page, int m, int tab_stride, int nsplit,
                   float scale_log2) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const PagedRows rows{tab + (size_t)b * tab_stride, page, NKV * HD, h * HD};
  detikzify_decode_split::split_partial<HD>(
      q, pool_k, pool_v, part, b, h, split, nsplit, NH, NKV,
      clamped_length(lengths, b, m, page), scale_log2, rows);
}

template <int HD>
__global__ void __launch_bounds__(HD)
paged_merge_kernel(Partials part, const int* __restrict__ lengths,
                   __nv_bfloat16* __restrict__ out, int NH, int NKV, int page,
                   int m, int nsplit) {
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the partials
  detikzify_decode_split::merge_partials<HD>(
      part, out, b, h, g, nsplit, NH, NKV,
      clamped_length(lengths, b, m, page));
}

template <int HD>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* pk,
           const __nv_bfloat16* pv, const int* tab, const int* lengths,
           __nv_bfloat16* out, Partials part, int B, int NH, int NKV,
           int page, int m, int tab_stride, int nsplit, float scale_log2,
           cudaStream_t st) {
  constexpr size_t smem = sizeof(Smem<HD>);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  paged_split_kernel<HD><<<dim3(nsplit, NKV, B), THREADS, smem, st>>>(
      q, pk, pv, tab, lengths, part, NH, NKV, page, m, tab_stride, nsplit,
      scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the merge may be scheduled as the split blocks start; it waits for
  // their grid to finish (programmatic dependent launch), so its launch
  // overlaps the split kernel's tail
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NH / NKV, NKV, B);
  cfg.blockDim = dim3(HD);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, paged_merge_kernel<HD>, part, lengths,
                                 out, NH, NKV, page, m, nsplit);
}

}  // namespace

extern "C" {

// q [B,NH,Hd] bf16, pool_k/pool_v [P,page,NKV,Hd] bf16 contiguous,
// tab [B, >= m] int32 with row stride tab_stride, lengths [B] int32,
// out [B,NH,Hd] bf16, scratch fp32 of at least
// B * NKV * ceil(m * page / 128) * NH / NKV * (Hd + 2) floats
// (`scratch_floats`). Hd in {64, 128}; page a multiple of 32; NH / NKV at
// most 8; m * page at most 32768 rows.
int detikzify_paged_decode(const void* q, const void* pool_k,
                           const void* pool_v, const void* tab,
                           const void* lengths, void* out, void* scratch,
                           long long scratch_floats, int B, int NH, int NKV,
                           int Hd, int page, int m, int tab_stride,
                           float scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (NKV <= 0 || NH % NKV != 0 || NH / NKV > MAXG ||
      page % ROW_ALIGN != 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = NH / NKV;
  const int nsplit = (m * page + SPLIT - 1) / SPLIT;
  if (nsplit > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  const long long recs = (long long)B * NKV * nsplit * G;
  if (scratch == nullptr || scratch_floats < recs * (Hd + 2))
    return (int)cudaErrorInvalidValue;
  float* f = static_cast<float*>(scratch);
  const Partials part{f, f + recs * Hd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* pk = static_cast<const __nv_bfloat16*>(pool_k);
  const auto* pv = static_cast<const __nv_bfloat16*>(pool_v);
  const int* tb = static_cast<const int*>(tab);
  const int* ln = static_cast<const int*>(lengths);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const float sl = scale * LOG2E;
  if (Hd == 128)
    return launch<128>(qq, pk, pv, tb, ln, o, part, B, NH, NKV, page, m,
                       tab_stride, nsplit, sl, st);
  if (Hd == 64)
    return launch<64>(qq, pk, pv, tb, ln, o, part, B, NH, NKV, page, m,
                      tab_stride, nsplit, sl, st);
  return (int)cudaErrorInvalidValue;
}

const char* detikzify_paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
