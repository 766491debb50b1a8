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
// What bounds it on the H100: at the vision tower's shape (900 x 900 at
// head_dim 72) the work is 4*B*NH*S*T*Hd FLOP against (q + k + v + out)
// bytes, far above the card's ~295 FLOP/byte ridge, so it is bound by
// tensor-core operations; the windowed prefill (most keys outside the
// window) and the MAP head (S = 1) are bound by bytes.
//
// What the design does about it. Two paths behind one entry point:
//
// * S > 16: one block of two warpgroups per (batch, head, 128 query rows),
//   64 rows per warpgroup. Both products run on wgmma with fp32
//   accumulators in registers: S = Q K^T as m64n64k16 from shared memory,
//   and O += P V with P taken from registers (the score accumulator,
//   rescaled and cast to bf16 in place: its fragment is the A operand's) and
//   V read N-major. The online softmax works on the score fragment: each
//   thread holds 2 rows x 16 keys, the row max and sum need two shuffles
//   within a quad, and O is rescaled in registers. The two warpgroups share
//   each K/V tile, which halves the re-reads of K/V from L2 against one
//   warpgroup per block. K/V tiles of 64 keys stream through a 3-stage ring
//   filled by cp.async, two tiles ahead of the one computed; one barrier
//   per tile. Tiles are stored in the 128-byte swizzle, so a warp's copy
//   reads 4 whole 128-byte rows and writes shared memory without bank
//   conflicts (the unswizzled core-matrix layout made each warp-wide copy
//   touch ~12 cache lines, and cost a third of the vision shape's time).
//   head_dim 72 is tiled at 80: columns 0-63 swizzled, 64-79 unswizzled with
//   their own n16 product for P V; cp.async zero-fills the pad columns
//   72-79 of Q, K and V in shared memory (a copy of source size 0), and the
//   pad columns are never written to device memory. head_dim 32 is tiled
//   at 64 the same way (columns 32-63 zero in shared memory, never
//   written). Key tiles that no query row of the block can see (beyond
//   the causal diagonal or the per-batch window) are skipped. P enters
//   the PV product as bf16 (unnormalised, in (0, 1]) and is normalised
//   once at the end; the TPU kernel normalises before the bf16 cast, so
//   the two differ by bf16 rounding of p and of the output.
// * S <= 16 (the MAP head's probe query): no 64-row tile is padded for
//   one query. A cluster of 8 blocks splits the keys of each (head, batch)
//   (flash-decoding); each block computes, for its keys and every query
//   row, the row max, the sum of exp and the unnormalised P V in fp32, and
//   the blocks combine the 8 partials through distributed shared memory in
//   a fixed order and write bf16: no scratch and no second launch.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;
using namespace detikzify_sm90;

namespace {

constexpr int WGS = 2;           // warpgroups per block, 64 query rows each
constexpr int BQ = 64 * WGS;     // query rows per block
constexpr int BK = 64;           // keys per K/V tile
constexpr int TILE_THREADS = 128 * WGS;
constexpr int THREADS = 128;     // a block of the split-key path
constexpr int STAGES = 3;        // K/V tiles in the cp.async ring
constexpr int SMALL_S = 16;      // S at or below takes the split-key path
constexpr int TS = 64;           // keys per chunk on the split-key path
constexpr int CLUSTER = 8;       // blocks splitting the keys of one row
constexpr float NEG_SENTINEL = -2.3819765e38f;   // -0.7 * FLT_MAX
constexpr float LOG2E = 1.4426950408889634f;

struct Masks {
  const unsigned char* kv_mask;  // [B, T] or null
  const int* q_off;              // [B] or null (per_batch)
  const int* kv_lim;             // [B] or null (per_batch)
  int causal, per_batch;
};

// Keys [0, kv_end) can be visible to some query row <= i_last of batch b.
// Skipping the keys beyond is exact only when every row sees at least one
// key (their weight is then exp(sentinel - real max) == 0), which holds for
// causal and for a window with kv_limits > 0, but not under an arbitrary
// key mask.
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

// A 64-row tile of HDP columns: HDP / 64 regions of 64 columns in the
// 128-byte swizzle (8 KB each, 1024-aligned), then, at head_dim 72, a
// region of the 16 remaining columns (72 real, 8 pad) as unswizzled core
// matrices (2 KB).
template <int HDP>
struct TileShape {
  static constexpr int NA = HDP / 64;       // swizzled 64-column regions
  static constexpr int REM = HDP % 64;      // 0, or 16 columns after them
  static_assert(REM == 0 || REM == 16, "head_dim tiles: 64, 80 or 128");
  static constexpr int BYTES = 64 * HDP * 2;
};

// Copy rows [row0, row0 + 64) of a [rows, Hd] slice with row stride `ld`
// (elements) into the layout of TileShape at `dst`; rows at or beyond
// `nrows` and the pad columns [Hd, HDP) are zero-filled (a copy of source
// size 0), never read from device memory. Each warp copies 4 whole 128-byte
// row pieces of a region per step.
template <int HDP>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int nrows, size_t ld, int Hd,
                                          int tid) {
  using TS_ = TileShape<HDP>;
#pragma unroll
  for (int a = 0; a < TS_::NA; ++a) {
#pragma unroll
    for (int it = 0; it < 512 / TILE_THREADS; ++it) {
      const int e = tid + it * TILE_THREADS;
      const int r = e >> 3, c = e & 7, col = a * 64 + c * 8;
      const bool full = row0 + r < nrows && col < Hd;
      const __nv_bfloat16* g =
          full ? src + (size_t)(row0 + r) * ld + col : src;
      cp_async16(dst + a * 8192 + sw128(r, c), g, full);
    }
  }
  if constexpr (TS_::REM != 0) {
    const int r = tid >> 1, cj = tid & 1, col = TS_::NA * 64 + cj * 8;
    if (tid < 128) {
      const bool full = row0 + r < nrows && col < Hd;
      const __nv_bfloat16* g =
          full ? src + (size_t)(row0 + r) * ld + col : src;
      cp_async16(dst + TS_::NA * 8192 + ((r >> 3) * 2 + cj) * 128 +
                     (r & 7) * 16, g, full);
    }
  }
}

template <int HDP>
__host__ __device__ constexpr int tile_bytes() {
  return TileShape<HDP>::BYTES;
}

template <int HDP>
__host__ __device__ constexpr size_t smem_bytes() {
  // a Q tile per warpgroup, then the ring of (K, V) tiles, and room to
  // align the first tile to 1024 bytes
  return (size_t)(WGS + 2 * STAGES) * tile_bytes<HDP>() + 1024;
}

template <int HDP, bool MASKED>
__global__ void __launch_bounds__(TILE_THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, Masks mk, int S, int T,
                 int NH, int NKV, int Hd, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  using TS_ = TileShape<HDP>;
  constexpr int TB = tile_bytes<HDP>();
  const uint32_t sQ0 = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sRing = sQ0 + WGS * TB;  // stage s: K at 2s*TB, V at (2s+1)*TB

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (NH / NKV);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int i0 = qt * BQ;
  const __nv_bfloat16* qb = q + ((size_t)b * S * NH + h) * Hd;
  const __nv_bfloat16* kb = k + ((size_t)b * T * NKV + kvh) * Hd;
  const __nv_bfloat16* vb = v + ((size_t)b * T * NKV + kvh) * Hd;
  const size_t ldq = (size_t)NH * Hd, ldkv = (size_t)NKV * Hd;

  const int kv_end = visible_end(mk, b, min(i0 + BQ, S) - 1, S, T);
  const int ntiles = (kv_end + BK - 1) / BK;
  const int off = MASKED && mk.per_batch ? mk.q_off[b] : 0;
  const int lim = MASKED && mk.per_batch ? mk.kv_lim[b] : T;

  // Q, then K/V tiles 0 and 1, as two copy groups
#pragma unroll
  for (int w = 0; w < WGS; ++w)
    load_tile<HDP>(sQ0 + w * TB, qb, i0 + 64 * w, S, ldq, Hd, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) {
      load_tile<HDP>(sRing + t * 2 * TB, kb, t * BK, T, ldkv, Hd, tid);
      load_tile<HDP>(sRing + (t * 2 + 1) * TB, vb, t * BK, T, ldkv, Hd, tid);
    }
    cp_async_commit();
  }

  // this thread's two rows and its column offset in a fragment
  const uint32_t sQ = sQ0 + wg * TB;
  const int ra = i0 + 64 * wg + warp * 16 + (lane >> 2), rb = ra + 8;
  const int cq = 2 * (lane & 3);
  // O: the swizzled columns in o (n64, or n128 over two regions), the
  // 16-column remainder in o2
  constexpr int NO = TS_::NA == 2 ? 64 : 32;
  float o[NO], o2[8];
#pragma unroll
  for (int f = 0; f < NO; ++f) o[f] = 0.f;
#pragma unroll
  for (int f = 0; f < 8; ++f) o2[f] = 0.f;
  float ma = NEG_SENTINEL, mb = NEG_SENTINEL, la = 0.f, lb = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    // tile kt (and Q) have landed; tile kt + 1 may still be in flight. The
    // barrier also means every warp is done with tile kt - 1, whose stage
    // the copy of tile kt + STAGES - 1 overwrites.
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    if (kt + STAGES - 1 < ntiles) {
      const int t = kt + STAGES - 1;
      const uint32_t nxt = sRing + (t % STAGES) * 2 * TB;
      load_tile<HDP>(nxt, kb, t * BK, T, ldkv, Hd, tid);
      load_tile<HDP>(nxt + TB, vb, t * BK, T, ldkv, Hd, tid);
    }
    cp_async_commit();
    const uint32_t sK = sRing + (kt % STAGES) * 2 * TB, sV = sK + TB;

    // S = Q K^T over HDP / 16 k-steps, Q and K K-major in shared memory
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * TS_::NA; ++ks) {
      const uint32_t at = (ks >> 2) * 8192 + (ks & 3) * 32;
      wgmma_ss(s, gmma_desc(sQ + at, 16, 1024, 1),
               gmma_desc(sK + at, 16, 1024, 1));
    }
    if constexpr (TS_::REM != 0)
      wgmma_ss(s, gmma_desc(sQ + TS_::NA * 8192, 128, 256),
               gmma_desc(sK + TS_::NA * 8192, 128, 256));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scores in the log2 domain, masked; row max over this thread's keys
    const int t0 = kt * BK;
    float xa = -INFINITY, xb = -INFINITY;
    if (MASKED || t0 + BK > T) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int t = t0 + 8 * (e >> 2) + cq + (e & 1);
        float x = s[e] * scale_log2;
        if (t >= T) {
          x = -INFINITY;               // not a key: weight 0
        } else if (MASKED && !visible(mk, b, (e & 2) ? rb : ra, t, S, T, off,
                                      lim)) {
          x = NEG_SENTINEL;
        }
        s[e] = x;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] *= scale_log2;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if (e & 2) xb = fmaxf(xb, s[e]);
      else xa = fmaxf(xa, s[e]);
    }
    xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, 1));
    xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, 2));
    xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, 1));
    xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, 2));
    const float na = fmaxf(ma, xa), nb = fmaxf(mb, xb);
    const float aa = ex2(ma - na), ab = ex2(mb - nb);
    ma = na;
    mb = nb;

    // P = exp2(s - m) (fp32 for the row sums, bf16 for the PV product)
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = ex2(s[e] - ((e & 2) ? nb : na));
      s[e] = p;
      if (e & 2) pb += p;
      else pa += p;
    }
    la = la * aa + pa;
    lb = lb * ab + pb;
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        pf[kk][u] = pack_bf16(s[8 * kk + 2 * u], s[8 * kk + 2 * u + 1]);
    }
#pragma unroll
    for (int f = 0; f < NO; ++f) o[f] *= (f & 2) ? ab : aa;
    if constexpr (TS_::REM != 0) {
#pragma unroll
      for (int f = 0; f < 8; ++f) o2[f] *= (f & 2) ? ab : aa;
      fence_regs(o2);
    }

    // O += P V over the tile's four 16-key steps, V N-major
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(o, pf[kk], gmma_desc(sV + kk * 2048, 8192, 1024, 1));
      if constexpr (TS_::REM != 0)
        wgmma_rs(o2, pf[kk],
                    gmma_desc(sV + TS_::NA * 8192 + kk * 512, 256, 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if constexpr (TS_::REM != 0) fence_regs(o2);
  }
  cp_async_wait<0>();            // nothing left in flight at exit

  la += __shfl_xor_sync(0xffffffffu, la, 1);
  la += __shfl_xor_sync(0xffffffffu, la, 2);
  lb += __shfl_xor_sync(0xffffffffu, lb, 1);
  lb += __shfl_xor_sync(0xffffffffu, lb, 2);
  const float inva = 1.f / fmaxf(la, 1e-30f), invb = 1.f / fmaxf(lb, 1e-30f);
  __nv_bfloat16* oa = out + (((size_t)b * S + ra) * NH + h) * Hd;
  __nv_bfloat16* ob = out + (((size_t)b * S + rb) * NH + h) * Hd;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    const int col = 8 * j + cq;
    if (col >= Hd) continue;        // head_dim 32 tiled at 64: pad columns
    if (ra < S)
      *reinterpret_cast<__nv_bfloat162*>(oa + col) =
          __floats2bfloat162_rn(o[4 * j] * inva, o[4 * j + 1] * inva);
    if (rb < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * invb, o[4 * j + 3] * invb);
  }
  if (TS_::REM != 0 && 64 * TS_::NA < Hd) {   // columns 64..71; 72..79 pad
    const int col = 64 * TS_::NA + cq;
    if (ra < S)
      *reinterpret_cast<__nv_bfloat162*>(oa + col) =
          __floats2bfloat162_rn(o2[0] * inva, o2[1] * inva);
    if (rb < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + col) =
          __floats2bfloat162_rn(o2[2] * invb, o2[3] * invb);
  }
}

// ---- S <= 16: keys split across a cluster, partials merged in fp32 -------
//
// A cluster of CLUSTER blocks per (head, batch): block r takes keys
// [r * tsb, (r + 1) * tsb) (tsb = ceil(T / CLUSTER) rounded up to 64) in
// 64-key chunks with an online softmax, and keeps, per query row, its row
// max (log2 domain; -inf: no visible key), its sum of exp2(x - max) and its
// unnormalised P V in shared memory. After a cluster barrier each block
// combines, for its share of the output elements, the CLUSTER partials read
// from the other blocks' shared memory, in rank order (no atomics: repeated
// runs agree bitwise), and writes bf16.

template <int HD>
struct SplitSmem {
  __nv_bfloat16 k[TS][HD + 8];     // padded: conflict-free row reads
  __nv_bfloat16 v[TS][HD];
  float q[SMALL_S][HD];
  float p[SMALL_S][TS];
  float acc[SMALL_S][HD];
  float m[SMALL_S], l[SMALL_S], a[SMALL_S];
};

template <int HD>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
flash_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, Masks mk, int S, int T,
                   int NH, int NKV, float scale_log2, int tsb) {
  constexpr int CH = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SplitSmem<HD>& sm = *reinterpret_cast<SplitSmem<HD>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (NH / NKV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t_begin = rank * tsb;
  const int t_end = min(t_begin + tsb, visible_end(mk, b, S - 1, S, T));
  const size_t ldkv = (size_t)NKV * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * T * NKV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * T * NKV + kvh) * HD;
  const int off = mk.per_batch ? mk.q_off[b] : 0;
  const int lim = mk.per_batch ? mk.kv_lim[b] : T;

  for (int e = tid; e < S * HD; e += THREADS) {
    const int i = e / HD, d = e % HD;
    sm.q[i][d] =
        __bfloat162float(q[(((size_t)b * S + i) * NH + h) * HD + d]) *
        scale_log2;
    sm.acc[i][d] = 0.f;
  }
  if (tid < S) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += TS) {
    __syncthreads();               // the last chunk's K, V and p are used
    for (int e = tid; e < TS * CH; e += THREADS) {
      const int r = e / CH, cc = e % CH, t = t0 + r;
      const bool full = t < T;
      const size_t o = full ? (size_t)t * ldkv + cc * 8 : 0;
      cp_async16(smem_u32(&sm.k[r][cc * 8]), kb + o, full);
      cp_async16(smem_u32(&sm.v[r][cc * 8]), vb + o, full);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // scores: one (row, key) pair per thread and step
    for (int e = tid; e < S * TS; e += THREADS) {
      const int i = e / TS, j = e % TS, t = t0 + j;
      float dot = 0.f;
#pragma unroll
      for (int cc = 0; cc < CH; ++cc) {
        const uint4 raw = *reinterpret_cast<const uint4*>(&sm.k[j][cc * 8]);
        const __nv_bfloat162* k2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 f = __bfloat1622float2(k2[u]);
          dot += sm.q[i][cc * 8 + 2 * u] * f.x +
                 sm.q[i][cc * 8 + 2 * u + 1] * f.y;
        }
      }
      float x = dot;
      if (t >= T) x = -INFINITY;
      else if (!visible(mk, b, i, t, S, T, off, lim)) x = NEG_SENTINEL;
      sm.p[i][j] = x;
    }
    __syncthreads();

    // online softmax update, one warp per row
    for (int i = warp; i < S; i += THREADS / 32) {
      const float x0 = sm.p[i][lane], x1 = sm.p[i][lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(sm.m[i], mx);
      const float p0 = ex2(x0 - m_new), p1 = ex2(x1 - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      sm.p[i][lane] = p0;
      sm.p[i][lane + 32] = p1;
      if (lane == 0) {
        const float alpha = ex2(sm.m[i] - m_new);
        sm.m[i] = m_new;
        sm.l[i] = sm.l[i] * alpha + ps;
        sm.a[i] = alpha;
      }
    }
    __syncthreads();

    // unnormalised P V in fp32
    for (int e = tid; e < S * HD; e += THREADS) {
      const int i = e / HD, d = e % HD;
      float acc = sm.acc[i][d] * sm.a[i];
#pragma unroll 8
      for (int j = 0; j < TS; ++j)
        acc += sm.p[i][j] * __bfloat162float(sm.v[j][d]);
      sm.acc[i][d] = acc;
    }
  }

  // merge the cluster's partials: this block takes every CLUSTER-th slice
  cluster.sync();
  for (int e = rank * THREADS + tid; e < S * HD; e += CLUSTER * THREADS) {
    const int i = e / HD, d = e % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(&sm, r)->m[i]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      const SplitSmem<HD>* o = cluster.map_shared_rank(&sm, r);
      if (o->m[i] == -INFINITY) continue;       // no visible key there
      const float w = ex2(o->m[i] - mx);
      l += w * o->l[i];
      acc += w * o->acc[i][d];
    }
    out[(((size_t)b * S + i) * NH + h) * HD + d] =
        __float2bfloat16(acc / fmaxf(l, 1e-30f));
  }
  cluster.sync();                  // keep this block's partials until read
}

template <int HDP, bool MASKED>
int launch_tiles(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, __nv_bfloat16* out, const Masks& mk,
                 int B, int S, int T, int NH, int NKV, int Hd,
                 float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HDP, MASKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((S + BQ - 1) / BQ, NH, B);
  flash_fwd_kernel<HDP, MASKED><<<grid, TILE_THREADS, smem, stream>>>(
      q, k, v, out, mk, S, T, NH, NKV, Hd, scale_log2);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_tiles_any(const __nv_bfloat16* q, const __nv_bfloat16* k,
                     const __nv_bfloat16* v, __nv_bfloat16* out,
                     const Masks& mk, int B, int S, int T, int NH, int NKV,
                     int Hd, float scale_log2, cudaStream_t stream) {
  const bool masked = mk.kv_mask != nullptr || mk.causal || mk.per_batch;
  return masked ? launch_tiles<HDP, true>(q, k, v, out, mk, B, S, T, NH, NKV,
                                          Hd, scale_log2, stream)
                : launch_tiles<HDP, false>(q, k, v, out, mk, B, S, T, NH,
                                           NKV, Hd, scale_log2, stream);
}

template <int HD>
int launch_split(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, __nv_bfloat16* out, const Masks& mk,
                 int B, int S, int T, int NH, int NKV, float scale_log2,
                 cudaStream_t stream) {
  constexpr size_t smem = sizeof(SplitSmem<HD>);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_split_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int per = (T + CLUSTER - 1) / CLUSTER;
  const int tsb = (per + TS - 1) / TS * TS;
  flash_split_kernel<HD><<<dim3(CLUSTER, NH, B), THREADS, smem, stream>>>(
      q, k, v, out, mk, S, T, NH, NKV, scale_log2, tsb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,S,NH,Hd], k/v [B,T,NKV,Hd], out [B,S,NH,Hd]: contiguous bf16.
// kv_mask [B,T] bool or NULL; q_off/kv_lim [B] int32 (per_batch) or NULL.
// Hd must be 32, 64, 72 or 128: the head dims of the port's models (72 is
// tiled at 80, 32 at 64); no other tile is built. Float32 inputs take
// flash_attn_f32.cu.
int detikzify_flash_attention(const void* q, const void* k, const void* v,
                              void* out, const void* kv_mask,
                              const void* q_off, const void* kv_lim, int B,
                              int S, int T, int NH, int NKV, int Hd,
                              float scale, int causal, int per_batch,
                              void* stream) {
  const Masks mk{static_cast<const unsigned char*>(kv_mask),
                 static_cast<const int*>(q_off),
                 static_cast<const int*>(kv_lim), causal, per_batch};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || T <= 0) return (int)cudaSuccess;
  if (NKV <= 0 || NH % NKV != 0) return (int)cudaErrorInvalidValue;
  if (per_batch && (q_off == nullptr || kv_lim == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  const float sl = scale * LOG2E;
  if (S <= SMALL_S) {
    switch (Hd) {
      case 32:
        return launch_split<32>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, sl, st);
      case 64:
        return launch_split<64>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, sl, st);
      case 72:
        return launch_split<72>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, sl, st);
      case 128:
        return launch_split<128>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, sl,
                                 st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (Hd) {
    case 32:
    case 64:
      return launch_tiles_any<64>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, Hd,
                                  sl, st);
    case 72:
      return launch_tiles_any<80>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, Hd,
                                  sl, st);
    case 128:
      return launch_tiles_any<128>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, Hd,
                                   sl, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* detikzify_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
