// Shared body of the one-row decode kernels K2 (paged_decode.cu) and K3
// (decode_contig.cu), for Hopper (sm_90a).
//
// One thread block computes one KV head of one slot: the G = NH / NKV query
// rows of that head's GQA group, one query row per head, against `length`
// K/V rows. Online softmax in fp32, p and V in fp32 for the PV sum, and
// out = acc / max(l, 1e-30), as the TPU kernels do.
//
// The rows are streamed in chunks of CHUNK rows with 16-byte coalesced
// loads into shared memory; only ceil(length / CHUNK) chunks are read. The
// whole GQA group is computed against each loaded row, so K/V is read once
// per group. Where a chunk lives is the caller's business: `row_base(row0)`
// gives the element offset of row `row0` of this head (rows of a chunk are
// contiguous with a stride of NKV * HD elements). K2 resolves it through
// the slot's page table, K3 from the slot's base and the batch stride.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace detikzify_decode {

constexpr int CHUNK = 64;        // K/V rows per shared-memory chunk
constexpr int THREADS = 128;
constexpr int MAXG = 8;          // query rows per KV head
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

// q [B, NH, HD], out [B, NH, HD]; k / v addressed through row_base.
template <int HD, class RowBase>
__device__ __forceinline__ void decode_group(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int b, int h, int NH, int NKV, int length, float scale,
    const RowBase& row_base) {
  // K rows padded by 8 bf16 so 16-byte row reads by neighbouring threads
  // fall on distinct banks
  __shared__ __align__(16) __nv_bfloat16 sK[CHUNK][HD + 8];
  __shared__ __align__(16) __nv_bfloat16 sV[CHUNK][HD];
  __shared__ float sQ[MAXG][HD];
  __shared__ float sP[MAXG][CHUNK];
  __shared__ float sM[MAXG], sL[MAXG], sA[MAXG];

  const int G = NH / NKV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rs = NKV * HD;                     // row stride in elements

  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD, d = e % HD;
    sQ[g][d] = __bfloat162float(q[((size_t)b * NH + h * G + g) * HD + d]) *
               scale;
  }
  if (tid < G) {
    sM[tid] = NEG_SENTINEL;
    sL[tid] = 0.f;
  }

  constexpr int GSTEP = THREADS / HD;          // 1 at Hd 128, 2 at Hd 64
  const int d_own = tid % HD, g0 = tid / HD;
  float acc[MAXG];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) acc[gi] = 0.f;

  constexpr int CH = HD / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int nchunks = (length + CHUNK - 1) / CHUNK;
  __syncthreads();

  for (int c = 0; c < nchunks; ++c) {
    const int row0 = c * CHUNK;
    const size_t base0 = row_base(row0);
    for (int e = tid; e < CHUNK * CH; e += THREADS) {
      const int r = e / CH, cc = e % CH;
      uint4 kval = zero, vval = zero;
      if (row0 + r < length) {
        const size_t base = base0 + (size_t)r * rs + cc * 8;
        kval = *reinterpret_cast<const uint4*>(k + base);
        vval = *reinterpret_cast<const uint4*>(v + base);
      }
      *reinterpret_cast<uint4*>(&sK[r][cc * 8]) = kval;
      *reinterpret_cast<uint4*>(&sV[r][cc * 8]) = vval;
    }
    __syncthreads();

    // logits: thread -> one key row, query rows strided by THREADS / CHUNK
    {
      const int j = tid % CHUNK;
      for (int g = tid / CHUNK; g < G; g += THREADS / CHUNK) {
        float dot = 0.f;
#pragma unroll
        for (int cc = 0; cc < CH; ++cc) {
          const uint4 raw = *reinterpret_cast<const uint4*>(&sK[j][cc * 8]);
          const __nv_bfloat162* p2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 f = __bfloat1622float2(p2[u]);
            dot += sQ[g][cc * 8 + 2 * u] * f.x + sQ[g][cc * 8 + 2 * u + 1] * f.y;
          }
        }
        sP[g][j] = (row0 + j < length) ? dot : NEG_SENTINEL;
      }
    }
    __syncthreads();

    // online softmax update: one warp per query row
    for (int g = warp; g < G; g += THREADS / 32) {
      const float s0 = sP[g][lane], s1 = sP[g][lane + 32];
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = __expf(s0 - m_new), p1 = __expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      const float alpha = __expf(m_old - m_new);
      sP[g][lane] = p0;
      sP[g][lane + 32] = p1;
      if (lane == 0) {
        sM[g] = m_new;
        sL[g] = sL[g] * alpha + psum;
        sA[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p V, thread -> one head-dim column
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      const int g = g0 + gi * GSTEP;
      if (g < G) {
        float a = acc[gi] * sA[g];
        for (int j = 0; j < CHUNK; ++j)
          a += sP[g][j] * __bfloat162float(sV[j][d_own]);
        acc[gi] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    const int g = g0 + gi * GSTEP;
    if (g < G)
      out[((size_t)b * NH + h * G + g) * HD + d_own] =
          __float2bfloat16(acc[gi] / fmaxf(sL[g], 1e-30f));
  }
}

}  // namespace detikzify_decode
