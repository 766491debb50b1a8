// K4: speculative verify-window attention straight from the paged KV pool,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// detikzify_tpu/ops/paged.py::decode_verify_attend_paged_pallas
// (-> _verify_kernel). Slot b has K1 = K + 1 query rows per head
// (q [B, K1, NH, Hd]: the last accepted token and K drafts, whose K/V rows
// the caller has already written at pool rows starts[b] .. starts[b] + K);
// row j attends rows [0, starts[b] + j + 1) of the slot's sequence, read
// through its page table, and the walk is clamped to the table's m * page
// rows exactly as the TPU kernel clamps it (paged.py:244-249). A dead slot
// arrives with start 0 and sees rows [0, j + 1): its output stays finite.
//
// What bounds it on the H100: every valid K/V row is read once and used
// for 2 * G * K1 * Hd FLOP per element pair (G * K1 = 20 query rows at
// v2-8b with K = 4), still far below the card's ~295 FLOP/byte ridge, so it
// is bound by device-memory bytes: sum_b min(starts[b] + K1, m * page)
// * NKV * Hd * 2 (K and V) * 2 bytes.
//
// What the design does about it: one block of 4 warps per (slot, KV head)
// reads its own page ids from the table and streams 64-row tiles of K and V
// once into shared memory (16-byte coalesced loads; a page holds whole
// tiles since page % 64 == 0). The block's query rows are the GQA group
// times K1 (flat row r = g * K1 + j, as the TPU kernel lays them out), up
// to 64 rows in 16-row tiles, so K/V is read once per group and never
// gathered. Both products run on the tensor cores through WMMA 16x16x16
// bf16 fragments with fp32 accumulation; the softmax is online in fp32 per
// row. Probabilities enter the PV product as bf16 (unnormalised, in
// (0, 1]) and are normalised once at the end; the plain version keeps them
// in fp32, so the two differ by the bf16 rounding of p and of the output.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BK = 64;           // pool rows per shared-memory tile
constexpr int MAXR = 64;         // query rows per block: G * K1
constexpr int MAXK1 = 8;         // verify-window rows per slot
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

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(MAXR * HD + 2 * BK * HD + MAXR * BK) *
             sizeof(__nv_bfloat16) +
         (size_t)(MAXR * BK + MAXR * HD + 2 * MAXR) * sizeof(float) +
         (size_t)MAXR * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
paged_verify_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ pool_k,
                    const __nv_bfloat16* __restrict__ pool_v,
                    const int* __restrict__ tab,
                    const int* __restrict__ starts,
                    __nv_bfloat16* __restrict__ out,
                    int K1, int NH, int NKV, int page, int m, int tab_stride,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);   // MAXR x HD
  __nv_bfloat16* sK = sQ + MAXR * HD;                            // BK x HD
  __nv_bfloat16* sV = sK + BK * HD;                              // BK x HD
  __nv_bfloat16* sP = sV + BK * HD;                              // MAXR x BK
  float* sS = reinterpret_cast<float*>(sP + MAXR * BK);          // MAXR x BK
  float* sO = sS + MAXR * BK;                                    // MAXR x HD
  float* sM = sO + MAXR * HD;                                    // MAXR
  float* sL = sM + MAXR;                                         // MAXR
  int* sLim = reinterpret_cast<int*>(sL + MAXR);                 // MAXR

  const int b = blockIdx.x, h = blockIdx.y;
  const int G = NH / NKV, R = G * K1, RT = (R + 15) / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int CH = HD / 8;            // 16-byte chunks per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int start = max(starts[b], 0);
  // rows any query row may see, clamped to the table's m columns
  const int length = min(start + K1, m * page);
  const int* tab_row = tab + (size_t)b * tab_stride;

  // query rows r = g * K1 + j: q[b, j, h * G + g, :]; the rows that pad
  // the last 16-row tile are zero
  for (int c = tid; c < RT * 16 * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    uint4 val = zero;
    if (r < R) {
      const int g = r / K1, j = r % K1;
      val = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * K1 + j) * NH + h * G + g) * HD + cc * 8);
    }
    *reinterpret_cast<uint4*>(sQ + r * HD + cc * 8) = val;
  }
  for (int c = tid; c < RT * 16 * HD; c += THREADS) sO[c] = 0.f;
  for (int c = tid; c < RT * 16 * BK; c += THREADS)
    sP[c] = __float2bfloat16(0.f);
  if (tid < MAXR) {
    sM[tid] = NEG_SENTINEL;
    sL[tid] = 0.f;
    sLim[tid] = start + (tid % K1) + 1;
  }
  const int ntiles = (length + BK - 1) / BK;
  __syncthreads();

  for (int kt = 0; kt < ntiles; ++kt) {
    const int row0 = kt * BK;
    const int pid = tab_row[row0 / page];
    const size_t base0 = ((size_t)pid * page + row0 % page) * NKV * HD +
                         (size_t)h * HD;
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH, cc = c % CH;
      uint4 kval = zero, vval = zero;
      if (row0 + r < length) {
        const size_t off = base0 + (size_t)r * NKV * HD + cc * 8;
        kval = *reinterpret_cast<const uint4*>(pool_k + off);
        vval = *reinterpret_cast<const uint4*>(pool_v + off);
      }
      *reinterpret_cast<uint4*>(sK + r * HD + cc * 8) = kval;
      *reinterpret_cast<uint4*>(sV + r * HD + cc * 8) = vval;
    }
    __syncthreads();

    // S = Q K^T: RT x (BK / 16) fragments of 16 x 16, spread over the warps
    for (int f = warp; f < RT * (BK / 16); f += WARPS) {
      const int rt = f / (BK / 16), kf = f % (BK / 16);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
      wmma::fill_fragment(fc, 0.f);
#pragma unroll
      for (int ds = 0; ds < HD / 16; ++ds) {
        wmma::load_matrix_sync(fa, sQ + (rt * 16) * HD + ds * 16, HD);
        wmma::load_matrix_sync(fb, sK + (kf * 16) * HD + ds * 16, HD);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(sS + (rt * 16) * BK + kf * 16, fc, BK,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax, one row per warp at a time, 2 keys per lane; row r
    // sees keys t < sLim[r] (and t < length, the clamp to the table)
    for (int r = warp; r < R; r += WARPS) {
      float s[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jj = lane + 32 * u, t = row0 + jj;
        const bool vis = t < length && t < sLim[r];
        s[u] = vis ? sS[r * BK + jj] * scale : NEG_SENTINEL;
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      const float p0 = __expf(s[0] - m_new), p1 = __expf(s[1] - m_new);
      const float psum = warp_sum(p0 + p1);
      const float alpha = __expf(m_old - m_new);
      sP[r * BK + lane] = __float2bfloat16(p0);
      sP[r * BK + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < HD; d += 32) sO[r * HD + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + psum;
      }
    }
    __syncthreads();

    // O += P V: RT x (HD / 16) fragments, spread over the warps
    for (int f = warp; f < RT * (HD / 16); f += WARPS) {
      const int rt = f / (HD / 16), df = f % (HD / 16);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
      wmma::load_matrix_sync(fc, sO + (rt * 16) * HD + df * 16, HD,
                             wmma::mem_row_major);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        wmma::load_matrix_sync(fa, sP + (rt * 16) * BK + ks * 16, BK);
        wmma::load_matrix_sync(fb, sV + (ks * 16) * HD + df * 16, HD);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(sO + (rt * 16) * HD + df * 16, fc, HD,
                              wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int r = warp; r < R; r += WARPS) {
    const int g = r / K1, j = r % K1;
    const float inv = 1.f / fmaxf(sL[r], 1e-30f);
    __nv_bfloat16* o = out + (((size_t)b * K1 + j) * NH + h * G + g) * HD;
    for (int d = lane; d < HD; d += 32)
      o[d] = __float2bfloat16(sO[r * HD + d] * inv);
  }
}

template <int HD>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const int* tab, const int* starts, void* out, int B, int K1,
           int NH, int NKV, int page, int m, int tab_stride, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_verify_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, NKV);
  paged_verify_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), tab, starts,
      static_cast<__nv_bfloat16*>(out), K1, NH, NKV, page, m, tab_stride,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,K1,NH,Hd] bf16 contiguous, pool_k/pool_v [P,page,NKV,Hd] bf16
// contiguous, tab [B, >= m] int32 with row stride tab_stride, starts [B]
// int32, out [B,K1,NH,Hd] bf16. Hd in {64, 128}; page a multiple of 64;
// K1 <= 8 and (NH / NKV) * K1 <= 64.
int detikzify_paged_verify(const void* q, const void* pool_k,
                           const void* pool_v, const void* tab,
                           const void* starts, void* out, int B, int K1,
                           int NH, int NKV, int Hd, int page, int m,
                           int tab_stride, float scale, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (NKV <= 0 || NH % NKV != 0 || K1 <= 0 || K1 > MAXK1 ||
      (NH / NKV) * K1 > MAXR || page % BK != 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tab);
  const int* st = static_cast<const int*>(starts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hd == 128)
    return launch<128>(q, pool_k, pool_v, tb, st, out, B, K1, NH, NKV, page,
                       m, tab_stride, scale, s);
  if (Hd == 64)
    return launch<64>(q, pool_k, pool_v, tb, st, out, B, K1, NH, NKV, page,
                      m, tab_stride, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* detikzify_paged_verify_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
