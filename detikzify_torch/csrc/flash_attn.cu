// K1: fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel detikzify_tpu/ops/flash.py::flash_attention
// (-> _flash_impl -> _fused_attn_kernel). Computes
//     out = softmax(q k^T * scale + masks) v
// with GQA (kv_head = head / (NH / NKV)) and the three mask kinds of the
// JAX kernel: a [B, T] key-padding mask, causal (queries are the last S of
// T keys), and the per-batch window  t <= q_offsets[b] + i  &&  t < kv_limits[b]
// used by the offset prefill. Masked logits take the same finite sentinel
// as the JAX package (-0.7 * FLT_MAX), so a fully masked row averages V
// uniformly exactly as the plain version does.
//
// What bounds it on the H100: at the main path's shapes (vision 900x900 at
// head_dim 72, prefill 512x640 at head_dim 128) the work is
// 4*B*NH*S*T*Hd FLOP against only (q + k + v + out) bytes, far above the
// card's ~295 FLOP/byte ridge, so it is bound by tensor-core operations.
//
// What the design does about it: the TPU kernel keeps a whole (batch,
// kv-head) of K/V resident in VMEM and pads Hd, S and T to 128; none of that
// carries over. Here one block of 4 warps owns one (batch, head, 64-query
// tile) and streams K/V in 64-row tiles through shared memory with an online
// softmax (running max / sum per row in fp32). Both products run on the
// tensor cores through WMMA 16x16x16 bf16 fragments with fp32 accumulation.
// head_dim is tiled at the next multiple of 16 (72 -> 80): the loads are
// masked and the pad columns are zero-filled in shared memory only, never
// in device memory. Key tiles that no query row of the block can see
// (beyond the causal diagonal or the per-batch window) are skipped.
// Probabilities enter the PV product as bf16 (unnormalised, in (0, 1]) and
// are normalised once at the end; the TPU kernel normalises before the
// bf16 cast, so the two differ by bf16 rounding of p and of the output.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;           // query rows per block (4 warps x 16 rows)
constexpr int BK = 64;           // key rows per shared-memory tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_SENTINEL = -2.3819765e38f;   // -0.7 * FLT_MAX

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HDP>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * HDP + 2 * BK * HDP + BQ * BK) * sizeof(__nv_bfloat16) +
         (size_t)(BQ * BK + BQ * HDP + 2 * BQ) * sizeof(float);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out,
                 const unsigned char* __restrict__ kv_mask,
                 const int* __restrict__ q_off,
                 const int* __restrict__ kv_lim,
                 int S, int T, int NH, int NKV, int Hd, float scale,
                 int causal, int per_batch) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);   // BQ x HDP
  __nv_bfloat16* sK = sQ + BQ * HDP;                             // BK x HDP
  __nv_bfloat16* sV = sK + BK * HDP;                             // BK x HDP
  __nv_bfloat16* sP = sV + BK * HDP;                             // BQ x BK
  float* sS = reinterpret_cast<float*>(sP + BQ * BK);            // BQ x BK
  float* sO = sS + BQ * BK;                                      // BQ x HDP
  float* sM = sO + BQ * HDP;                                     // BQ
  float* sL = sM + BQ;                                           // BQ

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (NH / NKV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = qt * BQ;
  constexpr int CH = HDP / 8;          // 16-byte chunks per smem row
  const int hd_ch = Hd / 8;            // chunks that hold real data
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH, i = i0 + r;
    uint4 val = zero;
    if (i < S && cc < hd_ch)
      val = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * S + i) * NH + h) * Hd + cc * 8);
    *reinterpret_cast<uint4*>(sQ + r * HDP + cc * 8) = val;
  }
  for (int c = tid; c < BQ * HDP; c += THREADS) sO[c] = 0.f;
  if (tid < BQ) {
    sM[tid] = NEG_SENTINEL;
    sL[tid] = 0.f;
  }

  // Key range any row of this block can see. Skipping the keys beyond it
  // is exact only when every row sees at least one key (their weight is
  // then exp(sentinel - real max) == 0), which holds for causal and for a
  // window with kv_limits > 0, but not under an arbitrary key mask.
  const int i_last = min(i0 + BQ, S) - 1;
  const int off = per_batch ? q_off[b] : 0;
  const int lim = per_batch ? kv_lim[b] : T;
  int kv_end = T;
  if (kv_mask == nullptr) {
    if (causal) kv_end = min(kv_end, i_last + (T - S) + 1);
    if (per_batch && lim > 0) kv_end = min(kv_end, min(lim, off + i_last + 1));
  }
  const int ntiles = (kv_end + BK - 1) / BK;
  __syncthreads();

  for (int kt = 0; kt < ntiles; ++kt) {
    const int t0 = kt * BK;
    if (kt > 0) __syncthreads();       // all warps done with the last tile
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH, cc = c % CH, t = t0 + r;
      uint4 kval = zero, vval = zero;
      if (t < T && cc < hd_ch) {
        const size_t base = (((size_t)b * T + t) * NKV + kvh) * Hd + cc * 8;
        kval = *reinterpret_cast<const uint4*>(k + base);
        vval = *reinterpret_cast<const uint4*>(v + base);
      }
      *reinterpret_cast<uint4*>(sK + r * HDP + cc * 8) = kval;
      *reinterpret_cast<uint4*>(sV + r * HDP + cc * 8) = vval;
    }
    __syncthreads();

    // logits for this warp's 16 rows against the 64 keys of the tile
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
      for (int kf = 0; kf < BK / 16; ++kf) {
        wmma::fill_fragment(fc, 0.f);
#pragma unroll
        for (int ds = 0; ds < HDP / 16; ++ds) {
          wmma::load_matrix_sync(fa, sQ + (warp * 16) * HDP + ds * 16, HDP);
          wmma::load_matrix_sync(fb, sK + (kf * 16) * HDP + ds * 16, HDP);
          wmma::mma_sync(fc, fa, fb, fc);
        }
        wmma::store_matrix_sync(sS + (warp * 16) * BK + kf * 16, fc, BK,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // online softmax over the tile, one row at a time, 2 keys per lane
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr, i = i0 + r;
      float s[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u, t = t0 + j;
        float x = sS[r * BK + j] * scale;
        if (t >= T) {
          x = __int_as_float(0xff800000);  // -inf: not a key, weight 0
        } else {
          bool vis = true;
          if (kv_mask != nullptr && !kv_mask[(size_t)b * T + t]) vis = false;
          if (causal && t > i + (T - S)) vis = false;
          if (per_batch && (t > off + i || t >= lim)) vis = false;
          if (!vis) x = NEG_SENTINEL;
        }
        s[u] = x;
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      const float p0 = __expf(s[0] - m_new), p1 = __expf(s[1] - m_new);
      const float psum = warp_sum(p0 + p1);
      const float alpha = __expf(m_old - m_new);
      sP[r * BK + lane] = __float2bfloat16(p0);
      sP[r * BK + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < HDP; d += 32) sO[r * HDP + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + psum;
      }
    }
    __syncwarp();

    // O (this warp's 16 rows) += P V
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
      for (int df = 0; df < HDP / 16; ++df) {
        wmma::load_matrix_sync(fc, sO + (warp * 16) * HDP + df * 16, HDP,
                               wmma::mem_row_major);
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          wmma::load_matrix_sync(fa, sP + (warp * 16) * BK + ks * 16, BK);
          wmma::load_matrix_sync(fb, sV + (ks * 16) * HDP + df * 16, HDP);
          wmma::mma_sync(fc, fa, fb, fc);
        }
        wmma::store_matrix_sync(sO + (warp * 16) * HDP + df * 16, fc, HDP,
                                wmma::mem_row_major);
      }
    }
  }
  __syncwarp();

  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr, i = i0 + r;
    if (i >= S) break;
    const float inv = 1.f / fmaxf(sL[r], 1e-30f);
    __nv_bfloat16* o = out + (((size_t)b * S + i) * NH + h) * Hd;
    for (int d = lane; d < Hd; d += 32)
      o[d] = __float2bfloat16(sO[r * HDP + d] * inv);
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* out,
           const unsigned char* kv_mask, const int* q_off, const int* kv_lim,
           int B, int S, int T, int NH, int NKV, int Hd, float scale,
           int causal, int per_batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, NH, B);
  flash_fwd_kernel<HDP><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      kv_mask, q_off, kv_lim, S, T, NH, NKV, Hd, scale, causal, per_batch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,S,NH,Hd], k/v [B,T,NKV,Hd], out [B,S,NH,Hd]: contiguous bf16.
// kv_mask [B,T] bool or NULL; q_off/kv_lim [B] int32 (per_batch) or NULL.
// Hd must be 64, 72 or 128: the head dims of the port's models (72 is
// tiled at 80); no other tile is built.
int detikzify_flash_attention(const void* q, const void* k, const void* v,
                              void* out, const void* kv_mask,
                              const void* q_off, const void* kv_lim, int B,
                              int S, int T, int NH, int NKV, int Hd,
                              float scale, int causal, int per_batch,
                              void* stream) {
  const unsigned char* mask = static_cast<const unsigned char*>(kv_mask);
  const int* off = static_cast<const int*>(q_off);
  const int* lim = static_cast<const int*>(kv_lim);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || T <= 0) return (int)cudaSuccess;
  if (NKV <= 0 || NH % NKV != 0) return (int)cudaErrorInvalidValue;
  switch (Hd) {
    case 64:
      return launch<64>(q, k, v, out, mask, off, lim, B, S, T, NH, NKV, Hd,
                        scale, causal, per_batch, st);
    case 72:
      return launch<80>(q, k, v, out, mask, off, lim, B, S, T, NH, NKV, Hd,
                        scale, causal, per_batch, st);
    case 128:
      return launch<128>(q, k, v, out, mask, off, lim, B, S, T, NH, NKV, Hd,
                         scale, causal, per_batch, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* detikzify_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
