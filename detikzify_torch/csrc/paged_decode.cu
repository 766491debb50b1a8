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
// kernel simple; splitting long sequences across blocks is later work.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 64;        // pool rows per shared-memory chunk
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
  // K rows padded by 8 bf16 so 16-byte row reads by neighbouring threads
  // fall on distinct banks
  __shared__ __align__(16) __nv_bfloat16 sK[CHUNK][HD + 8];
  __shared__ __align__(16) __nv_bfloat16 sV[CHUNK][HD];
  __shared__ float sQ[MAXG][HD];
  __shared__ float sP[MAXG][CHUNK];
  __shared__ float sM[MAXG], sL[MAXG], sA[MAXG];

  const int b = blockIdx.x, h = blockIdx.y;
  const int G = NH / NKV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int length = lengths[b];
  length = max(0, min(length, m * page));

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
    const int pid = tab[(size_t)b * tab_stride + row0 / page];
    const int prow0 = row0 % page;
    for (int e = tid; e < CHUNK * CH; e += THREADS) {
      const int r = e / CH, cc = e % CH;
      uint4 kval = zero, vval = zero;
      if (row0 + r < length) {
        const size_t base =
            (((size_t)pid * page + prow0 + r) * NKV + h) * HD + cc * 8;
        kval = *reinterpret_cast<const uint4*>(pool_k + base);
        vval = *reinterpret_cast<const uint4*>(pool_v + base);
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
