// Split-sequence body of the one-row decode kernel K2 (paged_decode.cu), for
// Hopper (sm_90a).
//
// The rows of one (slot, KV head) are cut into splits of SPLIT rows, one
// thread block each (flash-decoding). A block computes the G = NH / NKV
// query rows of its head's GQA group, one query row per head, against the
// rows of its split below `length`, and writes a partial result in fp32:
// per query row the row max (log2 domain), the sum of exp2(x - max) and the
// unnormalised acc = sum_j p_j V_j. A split that starts at or beyond
// `length` leaves at once and writes nothing; the merge reads only the
// ceil(length / SPLIT) live splits. The merge kernel combines the partials
// of one (slot, KV head) in split order with no atomics, so repeated runs
// give the same bits, and writes out = acc / max(l, 1e-30) in bf16, as the
// TPU kernel does.
//
// Inside a block each of the 4 warps owns 32 rows of the split. A warp
// issues its own cp.async copies of its K rows, then of its V rows (two
// groups, all of the block's rows in flight at once), computes the scores
// as soon as its K rows land while its V rows are still in flight, and
// needs no barrier with the other warps until the end. Both products run
// on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 out) with the GQA
// group as the 8-wide side: S^T[key, g] = K q^T with q held in registers,
// and acc^T[d, g] = V^T P^T with V read transposed by ldmatrix. P is
// rounded to bf16 for the second product, as the plain version rounds it.
// The 4 warps' partials are combined in shared memory into the block's
// one partial. Where a row lives is the caller's business: `row_base(row0)`
// gives the element offset of row `row0` of this head (32 rows from a
// 32-aligned row0 are contiguous with a stride of NKV * HD elements).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace detikzify_decode_split {

using detikzify_sm90::cp_async16;
using detikzify_sm90::cp_async_commit;
using detikzify_sm90::cp_async_wait;
using detikzify_sm90::ex2;
using detikzify_sm90::ldmatrix_x4;
using detikzify_sm90::ldmatrix_x4_trans;
using detikzify_sm90::mma_16816;
using detikzify_sm90::smem_u32;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WROWS = 32;                  // rows per warp
constexpr int SPLIT = WARPS * WROWS;       // rows per block
constexpr int ROW_ALIGN = WROWS;           // the page size must divide by it
constexpr int MAXG = 8;                    // query rows per KV head
constexpr int MAX_SPLITS = 256;            // table rows up to 32768
constexpr float NEG_SENTINEL = -2.3819765e38f;   // -0.7 * FLT_MAX
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Smem {
  // rows padded by 8 bf16: the 8 row addresses of an ldmatrix fall on
  // distinct banks
  __nv_bfloat16 k[SPLIT][HD + 8];
  __nv_bfloat16 v[SPLIT][HD + 8];
  __nv_bfloat16 pt[WARPS][MAXG][WROWS + 8];  // P^T of each warp
  float m[WARPS][MAXG], l[WARPS][MAXG];
};

// Partials of (slot b, KV head h, split s): acc [G, HD] at float offset
// ((b * NKV + h) * nsplit + s) * G * HD, then (max, sum) pairs at
// ml + ((b * NKV + h) * nsplit + s) * G * 2.
struct Partials {
  float* acc;
  float* ml;
};

// One block: query rows of KV head h of slot b against rows
// [split * SPLIT, min((split + 1) * SPLIT, length)).
template <int HD, class RowBase>
__device__ __forceinline__ void split_partial(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const Partials& part, int b, int h,
    int split, int nsplit, int NH, int NKV, int length, float scale_log2,
    const RowBase& row_base) {
  const int r0 = split * SPLIT;
  if (r0 >= length) return;                  // a dead split: no partial
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);

  constexpr int CH = HD / 8;                 // 16-byte chunks per row
  constexpr int DT = HD / 16;                // 16-wide head-dim tiles
  const int G = NH / NKV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r1 = min(r0 + SPLIT, length);
  const int w0 = warp * WROWS;               // this warp's rows in the split
  const bool live = r0 + w0 < r1;
  const int g_own = lane >> 2, c_own = 2 * (lane & 3);

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY}, l2[2] = {0.f, 0.f};

  if (live) {
    // this warp's 32 rows: K, then V, as two copy groups
    const size_t base0 = row_base(r0 + w0);
    const int rs = NKV * HD;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      const __nv_bfloat16* src = kv ? v : k;
#pragma unroll
      for (int it = 0; it < WROWS * CH / 32; ++it) {
        const int e = lane + 32 * it;
        const int r = e / CH, cc = e % CH;
        const bool full = r0 + w0 + r < r1;
        const size_t off = full ? base0 + (size_t)r * rs + cc * 8 : 0;
        __nv_bfloat16* dst =
            kv ? &sm.v[w0 + r][cc * 8] : &sm.k[w0 + r][cc * 8];
        cp_async16(smem_u32(dst), src + off, full);
      }
      cp_async_commit();
    }

    // q^T as the B operand: b0 = q[g][16ks + c_own ..], b1 = 8 further
    uint32_t qb[DT][2];
    const __nv_bfloat16* qrow = q + ((size_t)b * NH + h * G + g_own) * HD;
#pragma unroll
    for (int ks = 0; ks < DT; ++ks) {
      qb[ks][0] = g_own < G ? *reinterpret_cast<const uint32_t*>(
                                  qrow + 16 * ks + c_own) : 0u;
      qb[ks][1] = g_own < G ? *reinterpret_cast<const uint32_t*>(
                                  qrow + 16 * ks + 8 + c_own) : 0u;
    }

    cp_async_wait<1>();                      // K rows landed
    __syncwarp();
    // S^T [32 keys, 8 g] as two 16-key tiles
    float st[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      st[mt][0] = st[mt][1] = st[mt][2] = st[mt][3] = 0.f;
      const int row = w0 + 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int ks = 0; ks < DT; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(&sm.k[row][16 * ks + 8 * (lane >> 4)]));
        mma_16816(st[mt], a, qb[ks]);
      }
    }
    // scores in the log2 domain; rows at or past the length get the
    // sentinel (weight 0 beside any live row)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = r0 + w0 + 16 * mt + g_own + 8 * (u >> 1);
        st[mt][u] = key < r1 ? st[mt][u] * scale_log2 : NEG_SENTINEL;
      }
    }
    // per query column c_own + j: max and sum over the warp's 32 rows
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = fmaxf(fmaxf(st[0][j], st[0][j + 2]),
                       fmaxf(st[1][j], st[1][j + 2]));
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        st[mt][j] = ex2(st[mt][j] - mx);
        st[mt][j + 2] = ex2(st[mt][j + 2] - mx);
        sum += st[mt][j] + st[mt][j + 2];
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      m2[j] = mx;
      l2[j] = sum;
    }
    // P^T [g, key] in bf16 through this warp's shared buffer
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        sm.pt[warp][c_own + (u & 1)][16 * mt + g_own + 8 * (u >> 1)] =
            __float2bfloat16(st[mt][u]);
    }
    __syncwarp();
    uint32_t pb[2][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pb[kk][0] = *reinterpret_cast<const uint32_t*>(
          &sm.pt[warp][g_own][16 * kk + c_own]);
      pb[kk][1] = *reinterpret_cast<const uint32_t*>(
          &sm.pt[warp][g_own][16 * kk + 8 + c_own]);
    }

    cp_async_wait<0>();                      // V rows landed
    __syncwarp();
    // acc^T [HD, 8 g] += V^T P^T over the warp's two 16-key steps
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int row = w0 + 16 * kk + (lane & 7) + 8 * (lane >> 4);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t a[4];
        ldmatrix_x4_trans(
            a, smem_u32(&sm.v[row][16 * dt + 8 * ((lane >> 3) & 1)]));
        mma_16816(acc[dt], a, pb[kk]);
      }
    }
  }
  if (g_own == 0) {                          // lanes 0-3 hold the row stats
    sm.m[warp][c_own] = m2[0];
    sm.m[warp][c_own + 1] = m2[1];
    sm.l[warp][c_own] = l2[0];
    sm.l[warp][c_own + 1] = l2[1];
  }
  __syncthreads();                           // every warp is done with K

  // the warps' accumulators, [WARPS][G][HD] fp32, over the K rows
  float* red = reinterpret_cast<float*>(&sm.k[0][0]);
  static_assert(sizeof(float) * WARPS * MAXG * HD <= sizeof(sm.k),
                "the accumulators fit in the K rows");
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int g = c_own + (u & 1), d = 16 * dt + g_own + 8 * (u >> 1);
      if (g < G) red[(warp * G + g) * HD + d] = acc[dt][u];
    }
  }
  __syncthreads();
  const size_t rec = ((size_t)b * NKV + h) * nsplit + split;
  for (int e = tid; e < G * HD; e += THREADS) {
    const int g = e / HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm.m[w][g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (sm.m[w][g] == -INFINITY) continue;   // a warp past the length
      const float wt = ex2(sm.m[w][g] - mx);
      l += wt * sm.l[w][g];
      a += wt * red[w * G * HD + e];
    }
    part.acc[rec * G * HD + e] = a;
    if (e % HD == 0) {
      part.ml[(rec * G + g) * 2] = mx;
      part.ml[(rec * G + g) * 2 + 1] = l;
    }
  }
}

// One block per (query row g, KV head, slot), one thread per output
// column: out row h * G + g of slot b from the ceil(length / SPLIT) live
// splits. The split weights exp2(m_s - max) go to shared memory first, so
// the sum over the splits issues independent loads; it runs in split order
// (no atomics).
template <int HD>
__device__ __forceinline__ void merge_partials(
    const Partials& part, __nv_bfloat16* __restrict__ out, int b, int h,
    int g, int nsplit, int NH, int NKV, int length) {
  __shared__ float sw[MAX_SPLITS];
  __shared__ float s_inv;
  const int G = NH / NKV;
  const int live = (length + SPLIT - 1) / SPLIT;
  const size_t rec0 = ((size_t)b * NKV + h) * nsplit;
  const int d = threadIdx.x;
  if (d < 32) {                              // warp 0: max, weights, sum
    float mx = -INFINITY;
    for (int s = d; s < live; s += 32)
      mx = fmaxf(mx, part.ml[((rec0 + s) * G + g) * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    for (int s = d; s < live; s += 32) {
      const float w = ex2(part.ml[((rec0 + s) * G + g) * 2] - mx);
      sw[s] = w;
      l += w * part.ml[((rec0 + s) * G + g) * 2 + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (d == 0) s_inv = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* acc = part.acc + rec0 * G * HD + g * HD + d;
  float a = 0.f;
#pragma unroll 4
  for (int s = 0; s < live; ++s) a += sw[s] * acc[(size_t)s * G * HD];
  out[((size_t)b * NH + h * G + g) * HD + d] = __float2bfloat16(a * s_inv);
}

}  // namespace detikzify_decode_split
