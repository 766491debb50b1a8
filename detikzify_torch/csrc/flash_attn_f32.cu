// K1 in float32: fused multi-head attention forward for Hopper (sm_90a),
// with every product and sum in full fp32 (FFMA; no TF32, no tensor core).
//
// Replaces the Pallas TPU kernel detikzify_tpu/ops/flash.py::flash_attention
// (-> _flash_impl -> _fused_attn_kernel) for float32 inputs. The JAX kernel
// takes any dtype: its QK^T and softmax run in fp32 and its PV product in
// the input dtype, so for fp32 inputs the whole function is fp32. K1's
// bf16 path (flash_attn.cu) runs on wgmma, which has no fp32 operand, so
// fp32 is this separate kernel. It computes the same function with the
// same three mask kinds (a [B, T] key-padding mask, causal with the queries
// the last S of T keys, and the per-batch window t <= q_offsets[b] + i &&
// t < kv_limits[b]), GQA, and the same finite sentinel (-0.7 * FLT_MAX) for
// masked logits, so a fully masked row averages V uniformly as the plain
// version does. head_dim is any multiple of 4 up to 128 (16-byte rows),
// tiled at the next multiple of 32 with the pad columns zero in shared
// memory and never written.
//
// What bounds it on the H100: at ClipScore's vision shape (4 x 729 x 729,
// 16 heads of 72) the work is 4 * B * NH * S * T * Hd FLOP against
// (q + k + v + out) bytes in fp32, far above the ~20 FLOP/byte ridge of
// the card's 67 TFLOP/s fp32 FFMA rate, so it is bound by operations; the
// spec model's short causal prefills (hd 32) and the MAP head (S = 1) are
// bound by bytes and launch time.
//
// What the design does about it: a simple, correct tile kernel first. One
// block of 128 threads per (batch, head, BQ query rows); key tiles of 64
// rows. Q^T (pre-scaled by scale * log2 e), K^T and V of the tile and the
// tile's P sit in shared memory; each thread owns RPT query rows (ty + 8i)
// by 4 keys (tx + 16j) of the score tile and the same rows by HDP / 16
// output columns (tx + 16j), so every inner step is a register-blocked
// outer product: RPT + 4 shared reads for 4 RPT FFMA (scores) and
// RPT + HDP / 16 for RPT * HDP / 16 (PV), all reads broadcast or on
// consecutive banks. BQ = 64 (RPT 8); at most 16 query rows (the MAP
// head's one, a short prefill) take BQ = 16 (RPT 2), so a block does not
// compute 63 padding rows for one real one. The online softmax keeps each
// row's max and sum in registers, reduced over the 16 threads of a row
// with shuffles. Key tiles beyond what any row of the block can see
// (causal, window) are skipped, as on the bf16 path. A tile's loads are
// all issued before its first shared store, but not overlapped with the
// previous tile's products (no ring): speed is later work.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using detikzify_sm90::ex2;

constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 128;     // 8 row groups (ty) x 16 columns (tx)
constexpr int KPT = 4;           // keys per thread: tx + 16 j
constexpr int SMALL_S = 16;      // S at or below takes 16-row blocks
constexpr int MAX_HD = 128;
constexpr float NEG_SENTINEL = -2.3819765e38f;   // -0.7 * FLT_MAX
constexpr float LOG2E = 1.4426950408889634f;

struct Masks {
  const unsigned char* kv_mask;  // [B, T] or null
  const int* q_off;              // [B] or null (per_batch)
  const int* kv_lim;             // [B] or null (per_batch)
  int causal, per_batch;
};

// Keys [0, kv_end) can be visible to some query row <= i_last of batch b
// (flash_attn.cu's rule: exact only without a key mask).
__device__ __forceinline__ int visible_end(const Masks& mk, int b, int i_last,
                                           int S, int T) {
  int kv_end = T;
  if (mk.kv_mask == nullptr) {
    if (mk.causal) kv_end = min(kv_end, i_last + (T - S) + 1);
    if (mk.per_batch) {
      const int lim = mk.kv_lim[b];
      if (lim > 0) kv_end = min(kv_end, min(lim, mk.q_off[b] + i_last + 1));
    }
  }
  return kv_end;
}

__device__ __forceinline__ bool visible(const Masks& mk, int b, int i, int t,
                                        int S, int T, int off, int lim) {
  if (mk.kv_mask != nullptr && !mk.kv_mask[(size_t)b * T + t]) return false;
  if (mk.causal && t > i + (T - S)) return false;
  if (mk.per_batch && (t > off + i || t >= lim)) return false;
  return true;
}

template <int HDP, int BQ>
struct Smem {
  float qt[HDP][BQ];             // Q^T, scaled by scale * log2 e
  float kt[HDP][BK];             // K^T of the tile
  float v[BK][HDP];              // V of the tile
  float p[BQ][BK + 1];           // P of the tile (padded: rows on new banks)
};

// rows [row0, row0 + ROWS) of a [rows, Hd] slice with row stride `ld`
// (floats) into dst[col][row] (transposed), times `mul`; rows at or beyond
// `nrows` and columns [Hd, HDP) are zero. Every load of the thread is
// issued before the first store, so they are all in flight at once.
// Consecutive threads take consecutive rows, so the transposed shared
// stores hit consecutive banks.
template <int HDP, int ROWS>
__device__ __forceinline__ void load_transposed(float (*dst)[ROWS],
                                                const float* src, int row0,
                                                int nrows, size_t ld, int Hd,
                                                float mul, int tid) {
  constexpr int N = ROWS * (HDP / 4) / THREADS;
  static_assert(N * THREADS == ROWS * (HDP / 4), "whole steps");
  float4 x[N];
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int e = tid + it * THREADS;
    const int r = e % ROWS, col = 4 * (e / ROWS);
    x[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows && col < Hd)
      x[it] = *reinterpret_cast<const float4*>(
          src + (size_t)(row0 + r) * ld + col);
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int e = tid + it * THREADS;
    const int r = e % ROWS, col = 4 * (e / ROWS);
    dst[col][r] = x[it].x * mul;
    dst[col + 1][r] = x[it].y * mul;
    dst[col + 2][r] = x[it].z * mul;
    dst[col + 3][r] = x[it].w * mul;
  }
}

// the V tile row-major, 16 bytes a thread, consecutive threads along a
// row, every load in flight before the first store
template <int HDP>
__device__ __forceinline__ void load_rows(float (*dst)[HDP], const float* src,
                                          int row0, int nrows, size_t ld,
                                          int Hd, int tid) {
  constexpr int C4 = HDP / 4, N = BK * C4 / THREADS;
  static_assert(N * THREADS == BK * C4, "whole steps");
  float4 x[N];
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int e = tid + it * THREADS;
    const int r = e / C4, col = 4 * (e % C4);
    x[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows && col < Hd)
      x[it] = *reinterpret_cast<const float4*>(
          src + (size_t)(row0 + r) * ld + col);
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int e = tid + it * THREADS;
    *reinterpret_cast<float4*>(&dst[e / C4][4 * (e % C4)]) = x[it];
  }
}

// RPT query rows a thread (ty + 8 i), BQ = 8 RPT a block
template <int HDP, bool MASKED, int RPT>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 Masks mk, int S, int T, int NH, int NKV, int Hd,
                 float scale_log2) {
  constexpr int BQ = 8 * RPT;
  constexpr int DPT = HDP / 16;            // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HDP, BQ>& sm = *reinterpret_cast<Smem<HDP, BQ>*>(smem_raw);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (NH / NKV);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = qt * BQ;
  const float* qb = q + ((size_t)b * S * NH + h) * Hd;
  const float* kb = k + ((size_t)b * T * NKV + kvh) * Hd;
  const float* vb = v + ((size_t)b * T * NKV + kvh) * Hd;
  const size_t ldq = (size_t)NH * Hd, ldkv = (size_t)NKV * Hd;

  const int kv_end = visible_end(mk, b, min(i0 + BQ, S) - 1, S, T);
  const int ntiles = (kv_end + BK - 1) / BK;
  const int off = MASKED && mk.per_batch ? mk.q_off[b] : 0;
  const int lim = MASKED && mk.per_batch ? mk.kv_lim[b] : T;

  load_transposed<HDP, BQ>(sm.qt, qb, i0, S, ldq, Hd, scale_log2, tid);

  float acc[RPT][DPT];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_SENTINEL;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < ntiles; ++kt) {
    const int t0 = kt * BK;
    __syncthreads();                 // every thread is done with the last tile
    load_transposed<HDP, BK>(sm.kt, kb, t0, T, ldkv, Hd, 1.f, tid);
    load_rows<HDP>(sm.v, vb, t0, T, ldkv, Hd, tid);
    __syncthreads();

    // S = Q K^T (log2 domain) over the real head dims
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Hd; ++d) {
      float a[RPT], c[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = sm.qt[d][ty + 8 * i];
#pragma unroll
      for (int j = 0; j < KPT; ++j) c[j] = sm.kt[d][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    // masks, then the online softmax: a row's 64 keys are spread over the
    // 16 threads of its half-warp
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = i0 + ty + 8 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int t = t0 + tx + 16 * j;
        float x = s[i][j];
        if (t >= T) {
          x = -INFINITY;             // not a key: weight 0
        } else if (MASKED && !visible(mk, b, row, t, S, T, off, lim)) {
          x = NEG_SENTINEL;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = ex2(s[i][j] - mn);
        sm.p[ty + 8 * i][tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + ps;      // this thread's share; summed at the end
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // O += P V
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = sm.p[ty + 8 * i][c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = sm.v[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float li = l[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) li += __shfl_xor_sync(0xffffffffu, li, o);
    const int row = i0 + ty + 8 * i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float* o = out + (((size_t)b * S + row) * NH + h) * Hd;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < Hd) o[d] = acc[i][j] * inv;
    }
  }
}

template <int HDP, bool MASKED, int RPT>
int launch(const float* q, const float* k, const float* v, float* out,
           const Masks& mk, int B, int S, int T, int NH, int NKV, int Hd,
           float scale_log2, cudaStream_t stream) {
  constexpr int BQ = 8 * RPT;
  constexpr size_t smem = sizeof(Smem<HDP, BQ>);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<HDP, MASKED, RPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((S + BQ - 1) / BQ, NH, B);
  flash_f32_kernel<HDP, MASKED, RPT><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, mk, S, T, NH, NKV, Hd, scale_log2);
  return (int)cudaGetLastError();
}

template <int HDP, bool MASKED>
int launch_rows(const float* q, const float* k, const float* v, float* out,
                const Masks& mk, int B, int S, int T, int NH, int NKV,
                int Hd, float scale_log2, cudaStream_t stream) {
  return S <= SMALL_S
             ? launch<HDP, MASKED, 2>(q, k, v, out, mk, B, S, T, NH, NKV, Hd,
                                      scale_log2, stream)
             : launch<HDP, MASKED, 8>(q, k, v, out, mk, B, S, T, NH, NKV, Hd,
                                      scale_log2, stream);
}

template <int HDP>
int launch_any(const float* q, const float* k, const float* v, float* out,
               const Masks& mk, int B, int S, int T, int NH, int NKV, int Hd,
               float scale_log2, cudaStream_t stream) {
  const bool masked = mk.kv_mask != nullptr || mk.causal || mk.per_batch;
  return masked ? launch_rows<HDP, true>(q, k, v, out, mk, B, S, T, NH, NKV,
                                         Hd, scale_log2, stream)
                : launch_rows<HDP, false>(q, k, v, out, mk, B, S, T, NH, NKV,
                                          Hd, scale_log2, stream);
}

}  // namespace

extern "C" {

// q [B,S,NH,Hd], k/v [B,T,NKV,Hd], out [B,S,NH,Hd]: contiguous float32,
// 16-byte aligned. kv_mask [B,T] bool or NULL; q_off/kv_lim [B] int32
// (per_batch) or NULL. Hd a multiple of 4, at most 128 (tiled at the next
// multiple of 32).
int detikzify_flash_attention_f32(const void* q, const void* k, const void* v,
                                  void* out, const void* kv_mask,
                                  const void* q_off, const void* kv_lim,
                                  int B, int S, int T, int NH, int NKV,
                                  int Hd, float scale, int causal,
                                  int per_batch, void* stream) {
  const Masks mk{static_cast<const unsigned char*>(kv_mask),
                 static_cast<const int*>(q_off),
                 static_cast<const int*>(kv_lim), causal, per_batch};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || T <= 0) return (int)cudaSuccess;
  if (NKV <= 0 || NH % NKV != 0 || Hd <= 0 || Hd % 4 != 0 || Hd > MAX_HD)
    return (int)cudaErrorInvalidValue;
  if (per_batch && (q_off == nullptr || kv_lim == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(v);
  auto* oo = static_cast<float*>(out);
  const float sl = scale * LOG2E;
  switch ((Hd + 31) / 32) {
    case 1:
      return launch_any<32>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, Hd, sl, st);
    case 2:
      return launch_any<64>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, Hd, sl, st);
    case 3:
      return launch_any<96>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, Hd, sl, st);
    default:
      return launch_any<128>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, Hd, sl,
                             st);
  }
}

const char* detikzify_flash_attention_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
