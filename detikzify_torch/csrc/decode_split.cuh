// Split-sequence body of the decode kernels K2 (paged_decode.cu), K3
// (decode_contig.cu) and K4 (paged_verify.cu), for Hopper (sm_90a).
//
// One (slot, KV head) has R query rows, each with its own key limit: row r
// sees keys [0, limit(r)). K2 and K3 have R = G = NH / NKV (the GQA group,
// one row per head) and every limit equal to the slot's length; K4 has
// R = G * K1 (flat row r = g * K1 + j, as the TPU kernel lays them out)
// and row r's limit start + j + 1, clamped to the table. The slot's length
// is the largest limit.
//
// The keys of one (slot, KV head) are cut into splits of SPLIT = WARPS * 32
// rows, one thread block each (flash-decoding). A block computes its query
// rows against the keys of its split and writes a partial result in fp32:
// per query row the row max (log2 domain), the sum of exp2(x - max) and the
// unnormalised acc = sum_j p_j V_j. A split that starts at or beyond the
// length leaves at once and writes nothing; the merge reads only the
// ceil(length / SPLIT) live splits. A row that sees no key of a live split
// writes max = -inf, sum 0 and acc 0, and the merge gives it weight 0, so
// nothing of a split it cannot see reaches its output. The merge kernel
// combines the partials of one query row in split order with no atomics,
// so repeated runs give the same bits, and writes out = acc / max(l, 1e-30)
// in the caches' type (bf16 or fp32), as the TPU kernels do.
//
// Inside a block each warp owns 32 rows of the split. A warp issues its own
// cp.async copies of its K rows, then of its V rows (two groups, all of the
// block's rows in flight at once), computes the scores as soon as its K
// rows land while its V rows are still in flight, and needs no barrier
// with the other warps until the end. Both products run on the tensor
// cores (mma.sync m16n8k16, bf16 in, fp32 out) with the query rows as the
// 8-wide side, NTP tiles of 8 rows held in registers: S^T[key, r] = K q^T,
// and acc^T[d, r] = V^T P^T with V read transposed by ldmatrix. P is
// rounded to bf16 for the second product, as the plain versions round it.
// More than MAX_TILES tiles (K4 above 24 rows) do not fit in registers:
// the rows are then cut into passes of NTP tiles, one block per pass, each
// reading the split's K/V rows (the second reader finds them in L2). The
// warps' partials are combined in shared memory into the block's one
// partial.
//
// The same partials come from a second body for float32 pools and caches
// (split_partial on float pointers): the same splits, limits and merge, with
// every product an fp32 FFMA (no TF32, no tensor core) and P kept in fp32,
// as the plain versions keep it for fp32 values. At <= 20 query rows a KV
// head that is ~5 FLOP a byte, far under the card's ridge: the body is
// bound by bytes and launches. Its keys stream through a 3-stage cp.async
// ring of 16-row chunks shared by the block's warps (~62 KB of shared
// memory at head_dim 128, three blocks an SM), each warp owning some of the
// query rows over all of the split's keys (no combine across warps). Where
// the launch has one split (every slot's keys fit 128 rows, as the spec
// model's do), the split kernel writes the output and no merge is launched.
// The merge writes the caches' type. Both bodies take head_dim 32, 64 and
// 128.
//
// The caller describes one (slot, KV head) with a Slot: members b, h, nkv,
// R and length, and
//   size_t qrow(int r)   row index of query row r in q and out (rows of HD);
//   int limit(int r)     row r sees keys [0, limit(r)), limit(r) <= length;
//   size_t kv(int row0)  element offset of K/V row row0 of this head (32
//                        rows from a 32-aligned row0 are contiguous with a
//                        stride of nkv * HD elements).
// The grids are sized from the table width or the cache length, never from
// the values of lengths or starts, so the host never reads them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

constexpr int WROWS = 32;                  // key rows per warp
constexpr int ROW_ALIGN = WROWS;           // the page size must divide by it
constexpr int MAX_TILES = 3;               // 8-row query tiles per block
constexpr int MERGE_CHUNK = 256;           // split weights staged at once
constexpr float NEG_SENTINEL = -2.3819765e38f;   // -0.7 * FLT_MAX
constexpr float LOG2E = 1.4426950408889634f;

// blocks an SM should hold: 3 of K2's and K3's (one query tile), 2 with
// more tiles (their accumulators take up to ~200 registers), 1 of 8 warps
__host__ __device__ constexpr int min_blocks(int ntp, int warps) {
  return warps > 4 ? 1 : (ntp == 1 ? 3 : 2);
}

template <int HD, int NTP, int WARPS>
struct Smem {
  // rows padded by 8 bf16: the 8 row addresses of an ldmatrix fall on
  // distinct banks
  __nv_bfloat16 k[WARPS * WROWS][HD + 8];
  __nv_bfloat16 v[WARPS * WROWS][HD + 8];
  __nv_bfloat16 pt[WARPS][8 * NTP][WROWS + 8];   // P^T of each warp
  float m[WARPS][8 * NTP], l[WARPS][8 * NTP];
};

// Partials of (slot b, KV head h, split s, query row r): acc [HD] at float
// offset ((((b * NKV + h) * nsplit + s) * R + r) * HD, then (max, sum) at
// ml + (((b * NKV + h) * nsplit + s) * R + r) * 2.
struct Partials {
  float* acc;
  float* ml;
};

// How a Slot's R rows are cut into passes of ntp tiles of 8 rows.
struct RowPlan {
  int ntp, npass;
};

inline RowPlan plan_rows(int R) {
  const int nt = (R + 7) / 8;
  const int npass = (nt + MAX_TILES - 1) / MAX_TILES;
  return {(nt + npass - 1) / npass, npass};
}

// The block's one partial from its warps' (max, sum) in m, l [WARPS][NR]
// and unnormalised accumulators red [WARPS][nr][HD] (fp32, shared memory):
// record rec0 + c for each of the pass's nr query rows c.
template <int HD, int WARPS, int NR>
__device__ __forceinline__ void combine_warps(const float (*m)[NR],
                                              const float (*l)[NR],
                                              const float* red, int nr,
                                              const Partials& part,
                                              size_t rec0) {
  for (int e = threadIdx.x; e < nr * HD; e += WARPS * 32) {
    const int c = e / HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m[w][c]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (m[w][c] == -INFINITY) continue;     // a warp the row cannot see
      const float wt = ex2(m[w][c] - mx);
      sum += wt * l[w][c];
      a += wt * red[w * nr * HD + e];
    }
    part.acc[rec0 * HD + e] = a;
    if (e % HD == 0) {
      part.ml[(rec0 + c) * 2] = mx;
      part.ml[(rec0 + c) * 2 + 1] = sum;
    }
  }
}

// One block: query rows [rp0, rp0 + 8 * NTP) of the slot against keys
// [split * SPLIT, (split + 1) * SPLIT), each row below its limit.
template <int HD, int NTP, int WARPS, class Slot>
__device__ __forceinline__ void split_partial(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const Partials& part, int split,
    int nsplit, int rp0, float scale_log2, const Slot& s) {
  constexpr int SPLIT = WARPS * WROWS, NR = 8 * NTP;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int r0 = split * SPLIT;
  if (r0 >= s.length) return;                // a dead split: no partial
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD, NTP, WARPS>& sm = *reinterpret_cast<Smem<HD, NTP, WARPS>*>(smem_raw);

  constexpr int CH = HD / 8;                 // 16-byte chunks per row
  constexpr int DT = HD / 16;                // 16-wide head-dim tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r1 = min(r0 + SPLIT, s.length);
  const int w0 = warp * WROWS;               // this warp's rows in the split
  const bool live = r0 + w0 < r1;
  const int g_own = lane >> 2, c_own = 2 * (lane & 3);

  float acc[NTP][DT][4];
#pragma unroll
  for (int t = 0; t < NTP; ++t)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      acc[t][dt][0] = acc[t][dt][1] = acc[t][dt][2] = acc[t][dt][3] = 0.f;
  float m2[NTP][2], l2[NTP][2];
#pragma unroll
  for (int t = 0; t < NTP; ++t)
    m2[t][0] = m2[t][1] = -INFINITY, l2[t][0] = l2[t][1] = 0.f;

  if (live) {
    // this warp's 32 rows: K, then V, as two copy groups
    const size_t base0 = s.kv(r0 + w0);
    const int rs = s.nkv * HD;
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

    // q^T as the B operand: in tile t, column g_own is query row
    // rp0 + 8t + g_own; b0 = q[row][16ks + c_own ..], b1 = 8 further
    uint32_t qb[NTP][DT][2];
    // key limits of this lane's accumulator columns 8t + c_own + j
    int lim[NTP][2];
#pragma unroll
    for (int t = 0; t < NTP; ++t) {
      const int r = rp0 + 8 * t + g_own;
      const bool has = r < s.R;
      const __nv_bfloat16* qrow = q + (has ? s.qrow(r) * HD : 0);
#pragma unroll
      for (int ks = 0; ks < DT; ++ks) {
        qb[t][ks][0] = has ? *reinterpret_cast<const uint32_t*>(
                                 qrow + 16 * ks + c_own) : 0u;
        qb[t][ks][1] = has ? *reinterpret_cast<const uint32_t*>(
                                 qrow + 16 * ks + 8 + c_own) : 0u;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int rc = rp0 + 8 * t + c_own + j;
        lim[t][j] = rc < s.R ? s.limit(rc) : s.length;
      }
    }

    cp_async_wait<1>();                      // K rows landed
    __syncwarp();
    // S^T [32 keys, 8 rows] per tile, as two 16-key tiles
    float st[NTP][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int t = 0; t < NTP; ++t)
        st[t][mt][0] = st[t][mt][1] = st[t][mt][2] = st[t][mt][3] = 0.f;
      const int row = w0 + 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int ks = 0; ks < DT; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(&sm.k[row][16 * ks + 8 * (lane >> 4)]));
#pragma unroll
        for (int t = 0; t < NTP; ++t) mma_16816(st[t][mt], a, qb[t][ks]);
      }
    }
    // scores in the log2 domain; keys at or past a row's limit get the
    // sentinel
#pragma unroll
    for (int t = 0; t < NTP; ++t) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int key = r0 + w0 + 16 * mt + g_own + 8 * (u >> 1);
          st[t][mt][u] = key < lim[t][u & 1] ? st[t][mt][u] * scale_log2
                                             : NEG_SENTINEL;
        }
      }
    }
    // per query column c_own + j: max and sum over the warp's 32 rows; a
    // column that sees none of them gets max -inf, sum 0 and p = 0
#pragma unroll
    for (int t = 0; t < NTP; ++t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = fmaxf(fmaxf(st[t][0][j], st[t][0][j + 2]),
                         fmaxf(st[t][1][j], st[t][1][j + 2]));
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const bool seen = mx != NEG_SENTINEL;
        const float base = seen ? mx : 0.f;  // sentinel keys give ex2 = 0
        float sum = 0.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          st[t][mt][j] = ex2(st[t][mt][j] - base);
          st[t][mt][j + 2] = ex2(st[t][mt][j + 2] - base);
          sum += st[t][mt][j] + st[t][mt][j + 2];
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        m2[t][j] = seen ? mx : -INFINITY;
        l2[t][j] = sum;
      }
    }
    // P^T [row, key] in bf16 through this warp's shared buffer
#pragma unroll
    for (int t = 0; t < NTP; ++t) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sm.pt[warp][8 * t + c_own + (u & 1)][16 * mt + g_own + 8 * (u >> 1)] =
              __float2bfloat16(st[t][mt][u]);
      }
    }
    __syncwarp();
    uint32_t pb[NTP][2][2];
#pragma unroll
    for (int t = 0; t < NTP; ++t) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        pb[t][kk][0] = *reinterpret_cast<const uint32_t*>(
            &sm.pt[warp][8 * t + g_own][16 * kk + c_own]);
        pb[t][kk][1] = *reinterpret_cast<const uint32_t*>(
            &sm.pt[warp][8 * t + g_own][16 * kk + 8 + c_own]);
      }
    }

    cp_async_wait<0>();                      // V rows landed
    __syncwarp();
    // acc^T [HD, 8 rows] += V^T P^T over the warp's two 16-key steps
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int row = w0 + 16 * kk + (lane & 7) + 8 * (lane >> 4);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t a[4];
        ldmatrix_x4_trans(
            a, smem_u32(&sm.v[row][16 * dt + 8 * ((lane >> 3) & 1)]));
#pragma unroll
        for (int t = 0; t < NTP; ++t) mma_16816(acc[t][dt], a, pb[t][kk]);
      }
    }
  }
  if (g_own == 0) {                          // lanes 0-3 hold the row stats
#pragma unroll
    for (int t = 0; t < NTP; ++t) {
      sm.m[warp][8 * t + c_own] = m2[t][0];
      sm.m[warp][8 * t + c_own + 1] = m2[t][1];
      sm.l[warp][8 * t + c_own] = l2[t][0];
      sm.l[warp][8 * t + c_own + 1] = l2[t][1];
    }
  }
  __syncthreads();                           // every warp is done with K, V

  // the warps' accumulators, [WARPS][nr][HD] fp32, over the K and V rows
  const int nr = min(NR, s.R - rp0);         // query rows of this pass
  float* red = reinterpret_cast<float*>(&sm.k[0][0]);
  static_assert(sizeof(float) * WARPS * NR * HD <= sizeof(sm.k) + sizeof(sm.v),
                "the accumulators fit in the K and V rows");
#pragma unroll
  for (int t = 0; t < NTP; ++t) {
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 8 * t + c_own + (u & 1);
        const int d = 16 * dt + g_own + 8 * (u >> 1);
        if (c < nr) red[(warp * nr + c) * HD + d] = acc[t][dt][u];
      }
    }
  }
  __syncthreads();
  combine_warps<HD, WARPS, NR>(sm.m, sm.l, red, nr, part,
                               (((size_t)s.b * s.nkv + s.h) * nsplit + split)
                                   * s.R + rp0);
}

constexpr int F32_CROWS = 16;           // key rows per chunk of the fp32 ring
constexpr int F32_STAGES = 3;           // chunks in the fp32 ring

template <int HD, int NTP, int WARPS>
struct SmemF32 {
  // K rows padded by 4 floats: the 8 lanes of a quarter-warp reading their
  // own keys' float4 fall on distinct banks
  float k[F32_STAGES][F32_CROWS][HD + 4];
  float v[F32_STAGES][F32_CROWS][HD];
  // the pass's rows, scaled; a row's second half starts 4 floats late, so
  // the two halves a warp reads at once fall on distinct banks
  float q[8 * NTP][HD + 4];
  float p[WARPS][8 * NTP / WARPS][F32_CROWS];  // each warp's P of a chunk
};

// DL consecutive floats from shared memory as one vector load
template <int DL>
__device__ __forceinline__ void load_cols(float (&x)[DL], const float* src) {
  if constexpr (DL == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (DL == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *src;
  }
}

// The float32 body: the same splits, limits and partials as the bf16 one,
// every product an fp32 FFMA. The block's keys stream through a ring of
// F32_STAGES chunks of F32_CROWS rows (cp.async, two chunks ahead of the one
// computed, one barrier a chunk); warp w owns the pass's query rows
// w, w + WARPS, ... and runs the online softmax over every chunk for them,
// so no partial is combined across warps. On a chunk, lane l scores key
// l % 16 against half l / 16 of the head dims (four independent sums, one
// shuffle adds the halves); the chunk's P goes to the warp's shared rows
// and P V reads it back four keys at a time, lane l adding into head
// columns [l * HD / 32, (l + 1) * HD / 32). Each lane keeps its key's share
// of a row's sum, added across the lanes once at the end. With `out` (the
// launch has one split) each row's output is written here and no merge
// runs.
template <int HD, int NTP, int WARPS, class Slot>
__device__ __forceinline__ void split_partial(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const Partials& part, int split,
    int nsplit, int rp0, float scale_log2, const Slot& s, float* out) {
  constexpr int SPLIT = WARPS * WROWS, THREADS = WARPS * 32, NR = 8 * NTP;
  constexpr int CR = F32_CROWS;
  constexpr int C4 = HD / 4;                 // 16-byte chunks per row
  constexpr int H4 = HD / 8;                 // float4s in half a row
  constexpr int DL = HD / 32;                // head columns per lane
  constexpr int RW = NR / WARPS;             // query rows per warp
  constexpr int GROUPS = SPLIT / WROWS;      // contiguous 32-row groups
  static_assert(HD % 32 == 0, "head_dim 32, 64 or 128");
  static_assert(NR % WARPS == 0 && WROWS % CR == 0 && CR % 4 == 0,
                "whole rows per warp, whole chunks per 32-row group");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nr = min(NR, s.R - rp0);         // query rows of this pass
  const int r0 = split * SPLIT;
  if (r0 >= s.length) {                      // a dead split: no partial
    if (out != nullptr)                      // ... of an empty slot: 0
      for (int e = tid; e < nr * HD; e += THREADS)
        out[s.qrow(rp0 + e / HD) * HD + e % HD] = 0.f;
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemF32<HD, NTP, WARPS>& sm =
      *reinterpret_cast<SmemF32<HD, NTP, WARPS>*>(smem_raw);

  const int r1 = min(r0 + SPLIT, s.length);
  const int nch = (r1 - r0 + CR - 1) / CR;
  const int rs = s.nkv * HD;
  // where each live 32-row group of the split starts (one read of the
  // page table each, all in flight before the first copy)
  size_t base[GROUPS];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g)
    base[g] = r0 + g * WROWS < r1 ? s.kv(r0 + g * WROWS) : 0;
  // chunk c's K and V rows into stage c % F32_STAGES; rows at or past r1
  // are zero
  auto issue = [&](int c) {
    const int row0 = r0 + c * CR, st = c % F32_STAGES;
    size_t b0 = 0;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
      if (g == c * CR / WROWS) b0 = base[g];
    b0 += (size_t)(c * CR % WROWS) * rs;
#pragma unroll
    for (int e0 = 0; e0 < 2 * CR * C4; e0 += THREADS) {
      const int e = e0 + tid;
      const int kv = e / (CR * C4), r = e % (CR * C4) / C4, cc = e % C4;
      const bool full = row0 + r < r1;
      const size_t off = full ? b0 + (size_t)r * rs + 4 * cc : 0;
      float* dst = kv ? &sm.v[st][r][4 * cc] : &sm.k[st][r][4 * cc];
      cp_async16(smem_u32(dst), (kv ? v : k) + off, full);
    }
  };
  static_assert(2 * CR * C4 % THREADS == 0, "whole copy steps");
#pragma unroll
  for (int c = 0; c < F32_STAGES - 1; ++c) {
    if (c < nch) issue(c);
    cp_async_commit();
  }
  for (int e = tid; e < NR * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    sm.q[r][d + (d >= HD / 2 ? 4 : 0)] =
        r < nr ? q[s.qrow(rp0 + r) * HD + d] * scale_log2 : 0.f;
  }

  // this warp's rows warp + WARPS i: max (log2 domain; the sentinel while
  // the row has seen no key), this lane's share of the sum, unnormalised acc
  float acc[RW][DL], m[RW], l[RW];
  int lim[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + WARPS * i;
    m[i] = NEG_SENTINEL;
    l[i] = 0.f;
    lim[i] = r < nr ? s.limit(rp0 + r) : 0;
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[i][j] = 0.f;
  }
  const int kl = lane & (CR - 1), half = lane / CR;

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<F32_STAGES - 2>();         // chunk c landed
    __syncthreads();                         // for all; chunk c - 1 is done
    if (c + F32_STAGES - 1 < nch) issue(c + F32_STAGES - 1);
    cp_async_commit();
    const int st = c % F32_STAGES;
    const int key = r0 + c * CR + kl;

    // scores: four independent sums a row over this lane's half
    float sc[RW][4];
#pragma unroll
    for (int i = 0; i < RW; ++i)
      sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
    const float* krow = &sm.k[st][kl][half * (HD / 2)];
#pragma unroll
    for (int i4 = 0; i4 < H4; ++i4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + 4 * i4);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (warp + WARPS * i >= nr) continue;
        const float4 qq = *reinterpret_cast<const float4*>(
            &sm.q[warp + WARPS * i][half * (HD / 2 + 4) + 4 * i4]);
        sc[i][0] = fmaf(qq.x, kk.x, sc[i][0]);
        sc[i][1] = fmaf(qq.y, kk.y, sc[i][1]);
        sc[i][2] = fmaf(qq.z, kk.z, sc[i][2]);
        sc[i][3] = fmaf(qq.w, kk.w, sc[i][3]);
      }
    }
    // keys at or past a row's limit get the sentinel; the online update
    // over the chunk's CR keys (both halves of the warp hold them)
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (warp + WARPS * i >= nr) continue;
      float x = (sc[i][0] + sc[i][1]) + (sc[i][2] + sc[i][3]);
      x += __shfl_xor_sync(0xffffffffu, x, CR);
      x = key < lim[i] ? x : NEG_SENTINEL;
      float mx = x;
#pragma unroll
      for (int o = CR / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - mn);
      const float p = ex2(x - mn);
      l[i] = l[i] * alpha + p;
      m[i] = mn;
      if (half == 0) sm.p[warp][i][kl] = p;
#pragma unroll
      for (int j = 0; j < DL; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();
    // acc += P V over the chunk's keys, four at a time
#pragma unroll
    for (int k4 = 0; k4 < CR / 4; ++k4) {
      float vv[4][DL];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        load_cols<DL>(vv[u], &sm.v[st][4 * k4 + u][lane * DL]);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (warp + WARPS * i >= nr) continue;
        const float4 pp =
            *reinterpret_cast<const float4*>(&sm.p[warp][i][4 * k4]);
#pragma unroll
        for (int j = 0; j < DL; ++j) {
          acc[i][j] = fmaf(pp.x, vv[0][j], acc[i][j]);
          acc[i][j] = fmaf(pp.y, vv[1][j], acc[i][j]);
          acc[i][j] = fmaf(pp.z, vv[2][j], acc[i][j]);
          acc[i][j] = fmaf(pp.w, vv[3][j], acc[i][j]);
        }
      }
    }
  }

  // a row that saw no key of the split: max -inf, sum 0, acc 0 (output 0)
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + WARPS * i;
    if (r >= nr) continue;
    float li = l[i];
#pragma unroll
    for (int o = CR / 2; o > 0; o >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, o);
    const bool seen = m[i] != NEG_SENTINEL;
    if (out != nullptr) {
      const float inv = seen ? 1.f / fmaxf(li, 1e-30f) : 0.f;
      float* o = out + s.qrow(rp0 + r) * HD + lane * DL;
#pragma unroll
      for (int j = 0; j < DL; ++j) o[j] = acc[i][j] * inv;
    } else {
      const size_t rec =
          (((size_t)s.b * s.nkv + s.h) * nsplit + split) * s.R + rp0 + r;
#pragma unroll
      for (int j = 0; j < DL; ++j)
        part.acc[rec * HD + lane * DL + j] = seen ? acc[i][j] : 0.f;
      if (lane == 0) {
        part.ml[rec * 2] = seen ? m[i] : -INFINITY;
        part.ml[rec * 2 + 1] = seen ? li : 0.f;
      }
    }
  }
}

// One block of a split kernel: the bf16 body always writes a partial for
// the merge; the float32 body writes the output itself when the launch has
// one split.
template <int HD, int NTP, int WARPS, class Slot>
__device__ __forceinline__ void split_block(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16*, const Partials& part,
    int split, int nsplit, int rp0, float scale_log2, const Slot& s) {
  split_partial<HD, NTP, WARPS>(q, k, v, part, split, nsplit, rp0,
                                scale_log2, s);
}

template <int HD, int NTP, int WARPS, class Slot>
__device__ __forceinline__ void split_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* out, const Partials& part,
    int split, int nsplit, int rp0, float scale_log2, const Slot& s) {
  split_partial<HD, NTP, WARPS>(q, k, v, part, split, nsplit, rp0,
                                scale_log2, s, nsplit == 1 ? out : nullptr);
}

__device__ __forceinline__ void store_out(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);
}
__device__ __forceinline__ void store_out(float* o, float x) { *o = x; }

// One block per (query row r, KV head, slot), one thread per output
// column: out row r of the slot from the ceil(length / SPLIT) live splits.
// The split weights exp2(m_s - max) go to shared memory first, MERGE_CHUNK
// at a time, so the sum over the splits issues independent loads; it runs
// in split order (no atomics). A split the row cannot see (m_s = -inf)
// has weight 0. The output is bf16 or fp32, the caches' type.
template <int HD, int WARPS, class T, class Slot>
__device__ __forceinline__ void merge_partials(
    const Partials& part, T* __restrict__ out, int nsplit, int r,
    const Slot& s) {
  constexpr int SPLIT = WARPS * WROWS;
  __shared__ float sw[MERGE_CHUNK];
  __shared__ float s_inv;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the partials
  const int live = (s.length + SPLIT - 1) / SPLIT;
  const int d = threadIdx.x;
  T* o = out + s.qrow(r) * HD + d;
  if (live == 0) {                           // an empty slot
    store_out(o, 0.f);
    return;
  }
  const size_t rec0 = ((size_t)s.b * s.nkv + s.h) * nsplit * s.R + r;
  const float* ml = part.ml + rec0 * 2;      // split sp at ml[sp * R * 2]
  const float* acc = part.acc + rec0 * HD + d;
  const size_t ms = (size_t)s.R * 2, as = (size_t)s.R * HD;
  float mx = -INFINITY, l = 0.f;
  if (d < 32) {                              // warp 0: max, weights, sum
    for (int sp = d; sp < live; sp += 32) mx = fmaxf(mx, ml[sp * ms]);
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
  }
  float a = 0.f;
  for (int c0 = 0; c0 < live; c0 += MERGE_CHUNK) {
    const int n = min(MERGE_CHUNK, live - c0);
    const bool last = c0 + MERGE_CHUNK >= live;
    if (d < 32) {
      for (int i = d; i < n; i += 32) {
        const float m = ml[(c0 + i) * ms];
        const float w = m == -INFINITY ? 0.f : ex2(m - mx);
        sw[i] = w;
        l += w * ml[(c0 + i) * ms + 1];
      }
      if (last) {
#pragma unroll
        for (int o2 = 16; o2 > 0; o2 >>= 1)
          l += __shfl_xor_sync(0xffffffffu, l, o2);
        if (d == 0) s_inv = 1.f / fmaxf(l, 1e-30f);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < n; ++i) a += sw[i] * acc[(size_t)(c0 + i) * as];
    if (!last) __syncthreads();              // sw is staged again
  }
  store_out(o, a * s_inv);
}

// Launch the split kernel over grid (nsplit, NKV * npass, B) and the merge
// kernel over (R, NKV, B) as its programmatic dependent: the merge may be
// scheduled as the split blocks start and waits for their grid to finish,
// so its launch overlaps the split kernel's tail. T is the element type
// (bf16 or float), which sets the split block's shared memory; a float32
// launch of one split has written its output and launches no merge.
// Returns a cudaError_t. Nothing here allocates, synchronises or reads
// device memory on the host, so the decode engine's CUDA graphs capture
// it; a capture records the merge's dependency as a programmatic edge
// (CUDA 12.3 and later).
template <int HD, int NTP, int WARPS, class T, class Args>
int launch_split_merge(void (*split_kernel)(Args, Partials, int, int, float),
                       void (*merge_kernel)(Args, Partials, int),
                       const Args& args, Partials part, int B, int NKV,
                       int R, int nsplit, int npass, float scale_log2,
                       cudaStream_t st) {
  constexpr size_t smem = std::is_same<T, float>::value
                               ? sizeof(SmemF32<HD, NTP, WARPS>)
                               : sizeof(Smem<HD, NTP, WARPS>);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, NKV * npass, B);
  cfg.blockDim = dim3(WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaError_t err = cudaLaunchKernelEx(&cfg, split_kernel, args, part, nsplit,
                                       npass, scale_log2);
  if (err != cudaSuccess) return (int)err;
  // one float32 split: the split kernel has written the output
  if (std::is_same<T, float>::value && nsplit == 1) return (int)cudaSuccess;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t mcfg = {};
  mcfg.gridDim = dim3(R, NKV, B);
  mcfg.blockDim = dim3(HD);
  mcfg.stream = st;
  mcfg.attrs = attr;
  mcfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&mcfg, merge_kernel, args, part, nsplit);
}

}  // namespace detikzify_decode_split
