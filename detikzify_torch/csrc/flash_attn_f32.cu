// K1 in float32: fused multi-head attention forward for Hopper (sm_90a),
// both products on the tensor cores in 3xTF32.
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
// masked logits, so a fully masked row averages V uniformly over the T real
// keys as the plain version does. head_dim is any multiple of 4 up to 128
// (16-byte rows), tiled at 32, 64, 72 or 128 with the pad columns zero in
// shared memory and never written.
//
// What bounds it on the H100: at ClipScore's vision shape (4 x 729 x 729,
// 16 heads of 72) the work is 4 * B * NH * S * T * Hd FLOP against
// (q + k + v + out) bytes in fp32, far above the ridge of either fp32 rate
// of the card, so it is bound by operations. In FFMA (67 TFLOP/s) that is
// 0.146 ms; here each fp32 product is three TF32 products on the tensor
// cores (495 TFLOP/s dense), 0.059 ms. The MAP head (S = 1) and the spec
// model's short prefills are bound by bytes and launch time.
//
// What the design does about it. Two paths behind one entry point:
//
// * S > 16: 3xTF32 tiles. Each fp32 operand x is split once into
//   hi = tf32(x) and lo = tf32(x - hi) (cvt.rna.tf32.f32), and a product
//   a b is accumulated in fp32 as lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b):
//   the dropped lo lo term and lo's own rounding are ~2^-21 of the product,
//   against ~2^-11 for one TF32 pass, so the sum keeps about fp32's
//   precision. One block of 4 warps per (batch, head, 64 query rows), 16
//   rows a warp, both products on mma.sync m16n8k8 (wgmma takes tf32 only
//   K-major from shared memory, and V in P V is N-major). Q's fragments
//   (pre-scaled by scale * log2 e) are loaded once; at head_dim <= 72 their
//   hi/lo halves stay in registers, at 128 the fp32 fragments stay and are
//   split per tile (the halves would take 128 registers). K and V tiles of
//   32 keys stream through a 3-stage ring filled by cp.async, two tiles
//   ahead of the one computed, one barrier per tile; K rows are padded to
//   8 or 24 floats mod 32 and V rows to 4 mod 16, so every fragment read of
//   a warp hits distinct banks. Within a k8 step the key order is permuted
//   (fragment column t is key 2t, column t + 4 key 2t + 1), so the score
//   accumulator of one 8-key tile is the A fragment of the P V step with no
//   shuffle, and Q and K fragments are float2 reads. The row max, ex2 and
//   the sums stay in fp32. Shared memory is ~57 KB a block at head_dim 72
//   and ~101 KB at 128, two blocks an SM or more. Key tiles that no row of
//   the block can see (causal, window) are skipped.
// * S <= 16 over more than 256 keys (the MAP head's probe over the
//   tower's 729 or 900 patches): no 64-row tile is padded for one query
//   and walks every key tile alone. A cluster of 8 blocks splits the keys
//   of each (head, batch) (flash-decoding, as flash_attn.cu's bf16 path): each
//   block puts all of its keys' K and V rows in flight at once (cp.async,
//   32 rows a warp, K before V), each lane scores one key against the rows
//   in FFMA (the work is bound by bytes), the warps' partials (max, sum,
//   unnormalised P V) are combined in shared memory, and the blocks combine
//   the 8 partials through distributed shared memory in rank order (no
//   atomics: repeated runs agree bitwise) and write fp32. Over at most 256
//   keys (the spec model's prefill windows) one 64-row tile block a head
//   costs less than the cluster's two barriers and merge.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using detikzify_sm90::cp_async16;
using detikzify_sm90::cp_async_commit;
using detikzify_sm90::cp_async_wait;
using detikzify_sm90::ex2;
using detikzify_sm90::smem_u32;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;   // query rows per tile block
constexpr int BK = 32;           // keys per K/V tile
constexpr int STAGES = 3;        // K/V tiles in the cp.async ring
constexpr int SMALL_S = 16;      // S at or below takes the split-key path
constexpr int SPLIT_MIN_T = 8 * BK;   // ... when T is above (else tiles)
constexpr int CLUSTER = 8;       // blocks splitting the keys of one row
constexpr int WROWS = 32;        // keys per warp on the split-key path
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

// ---- 3xTF32 on mma.sync ----------------------------------------------------
//
// m16n8k8 with tf32 operands, lane l (g = l / 4, t = l % 4): A (16 x 8,
// row-major) a0 = (row g, col t), a1 = (g + 8, t), a2 = (g, t + 4),
// a3 = (g + 8, t + 4); B (8 x 8) b0 = (row t, col g), b1 = (t + 4, g);
// C (16 x 8) c0, c1 = (row g, cols 2t, 2t + 1), c2, c3 = row g + 8.

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 of x: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the two small cross terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(c, alo, h0, h1);
  mma_tf32(c, ahi, l0, l1);
  mma_tf32(c, ahi, h0, h1);
}

// ---- S > 16: 64-row tiles ------------------------------------------------

template <int HDP>
struct Tile {
  static constexpr int LDK = HDP % 16 == 8 ? HDP : HDP + 8;  // 8 or 24 mod 32
  static constexpr int LDV = HDP + 4;                        // 4 or 12 mod 16
  static constexpr int KS = HDP / 8;   // k8 steps of Q K^T
  static constexpr int NT = BK / 8;    // 8-key tiles of S, k8 steps of P V
  static constexpr int DT = HDP / 8;   // 8-column tiles of the output
  static constexpr bool QHELD = HDP <= 72;   // Q's hi/lo kept in registers
  static constexpr size_t SMEM = sizeof(float) * STAGES * BK * (LDK + LDV);
};

// rows [t0, t0 + BK) of a [rows, Hd] slice with row stride `ld` (floats)
// into dst[BK][LD] by cp.async; rows at or past T and columns [Hd, HDP) are
// zero
template <int HDP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int t0, int T, size_t ld, int Hd,
                                          int tid) {
  constexpr int C4 = HDP / 4, N = BK * C4;
#pragma unroll
  for (int e0 = 0; e0 < N; e0 += THREADS) {
    const int e = e0 + tid;
    if (N % THREADS != 0 && e >= N) break;
    const int r = e / C4, c = e % C4;
    const bool full = t0 + r < T && 4 * c < Hd;
    const float* p = full ? src + (size_t)(t0 + r) * ld + 4 * c : src;
    cp_async16(smem_u32(dst + r * LD + 4 * c), p, full);
  }
}

template <int HDP, bool MASKED>
__global__ void __launch_bounds__(THREADS, 2)
flash_f32_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      Masks mk, int S, int T, int NH, int NKV, int Hd,
                      float scale_log2) {
  using C = Tile<HDP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sk = reinterpret_cast<float*>(smem_raw);    // [STAGES][BK][LDK]
  float* const sv = sk + STAGES * BK * C::LDK;             // [STAGES][BK][LDV]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (NH / NKV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int i0 = qt * BQ;
  const int row_a = i0 + 16 * warp + g, row_b = row_a + 8;
  const float* kb = k + ((size_t)b * T * NKV + kvh) * Hd;
  const float* vb = v + ((size_t)b * T * NKV + kvh) * Hd;
  const size_t ldkv = (size_t)NKV * Hd;

  const int kv_end = visible_end(mk, b, min(i0 + BQ, S) - 1, S, T);
  const int ntiles = (kv_end + BK - 1) / BK;
  const int off = MASKED && mk.per_batch ? mk.q_off[b] : 0;
  const int lim = MASKED && mk.per_batch ? mk.kv_lim[b] : T;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) {
      load_tile<HDP, C::LDK>(sk + st * BK * C::LDK, kb, st * BK, T, ldkv, Hd,
                             tid);
      load_tile<HDP, C::LDV>(sv + st * BK * C::LDV, vb, st * BK, T, ldkv, Hd,
                             tid);
    }
    cp_async_commit();
  }

  // Q's A fragments, scaled: step ks, a0/a2 = row g, d = 8 ks + 2t, + 1;
  // a1/a3 the same for row g + 8
  float qf[C::QHELD ? 1 : C::KS][4];
  uint32_t qhi[C::QHELD ? C::KS : 1][4], qlo[C::QHELD ? C::KS : 1][4];
  {
    const float* qa = q + (((size_t)b * S + row_a) * NH + h) * Hd;
    const float* qb2 = q + (((size_t)b * S + row_b) * NH + h) * Hd;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      const int d = 8 * ks + 2 * t4;
      float2 xa = make_float2(0.f, 0.f), xb = make_float2(0.f, 0.f);
      if (d < Hd) {
        if (row_a < S) xa = *reinterpret_cast<const float2*>(qa + d);
        if (row_b < S) xb = *reinterpret_cast<const float2*>(qb2 + d);
      }
      const float f[4] = {xa.x * scale_log2, xb.x * scale_log2,
                          xa.y * scale_log2, xb.y * scale_log2};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (C::QHELD) split(f[u], qhi[ks][u], qlo[ks][u]);
        else qf[ks][u] = f[u];
      }
    }
  }

  float o[C::DT][4];
#pragma unroll
  for (int dt = 0; dt < C::DT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_a = NEG_SENTINEL, m_b = NEG_SENTINEL, l_a = 0.f, l_b = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<STAGES - 2>();     // tile kt landed
    __syncthreads();                 // ... for all, and tile kt - 1 is done
    {
      const int nx = kt + STAGES - 1;
      if (nx < ntiles) {
        const int st = nx % STAGES;
        load_tile<HDP, C::LDK>(sk + st * BK * C::LDK, kb, nx * BK, T, ldkv,
                               Hd, tid);
        load_tile<HDP, C::LDV>(sv + st * BK * C::LDV, vb, nx * BK, T, ldkv,
                               Hd, tid);
      }
      cp_async_commit();
    }
    const int st = kt % STAGES, t0 = kt * BK;
    const float* ks_ = sk + st * BK * C::LDK;
    const float* vs_ = sv + st * BK * C::LDV;

    // S = Q K^T (log2 domain): tile nt, c0/c1 = row g, keys 8 nt + 2t, + 1
    float s[C::NT][4];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (C::QHELD) {
          ahi[u] = qhi[ks][u];
          alo[u] = qlo[ks][u];
        } else {
          // split again on every tile: hoisted out of the tile loop, the
          // halves of all KS steps would be live at once and spill
          float x = qf[ks][u];
          asm volatile("" : "+f"(x));
          split(x, ahi[u], alo[u]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const float2 kk = *reinterpret_cast<const float2*>(
            ks_ + (8 * nt + g) * C::LDK + 8 * ks + 2 * t4);
        mma3(s[nt], ahi, alo, kk.x, kk.y);
      }
    }

    // masks, then the online softmax over the quad that holds each row
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + 8 * nt + 2 * t4 + (u & 1);
        float x = s[nt][u];
        if (t >= T) {
          x = -INFINITY;             // not a key: weight 0
        } else if (MASKED && !visible(mk, b, u < 2 ? row_a : row_b, t, S, T,
                                      off, lim)) {
          x = NEG_SENTINEL;
        }
        s[nt][u] = x;
        if (u < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      s[nt][0] = ex2(s[nt][0] - mn_a);
      s[nt][1] = ex2(s[nt][1] - mn_a);
      s[nt][2] = ex2(s[nt][2] - mn_b);
      s[nt][3] = ex2(s[nt][3] - mn_b);
      ps_a += s[nt][0] + s[nt][1];
      ps_b += s[nt][2] + s[nt][3];
    }
    l_a = l_a * al_a + ps_a;         // this thread's share; summed at the end
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int dt = 0; dt < C::DT; ++dt) {
      o[dt][0] *= al_a;
      o[dt][1] *= al_a;
      o[dt][2] *= al_b;
      o[dt][3] *= al_b;
    }

    // O += P V: the score tile j is step j's A fragment (key 8j + 2t at
    // column t, 8j + 2t + 1 at t + 4); B: b0 = V[8j + 2t][8 dt + g],
    // b1 = V[8j + 2t + 1][8 dt + g]
#pragma unroll
    for (int j = 0; j < C::NT; ++j) {
      uint32_t phi[4], plo[4];
      split(s[j][0], phi[0], plo[0]);
      split(s[j][2], phi[1], plo[1]);
      split(s[j][1], phi[2], plo[2]);
      split(s[j][3], phi[3], plo[3]);
      const float* v0 = vs_ + (8 * j + 2 * t4) * C::LDV + g;
#pragma unroll
      for (int dt = 0; dt < C::DT; ++dt)
        mma3(o[dt], phi, plo, v0[8 * dt], v0[C::LDV + 8 * dt]);
    }
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  float* oa = out + (((size_t)b * S + row_a) * NH + h) * Hd;
  float* ob = out + (((size_t)b * S + row_b) * NH + h) * Hd;
#pragma unroll
  for (int dt = 0; dt < C::DT; ++dt) {
    const int d = 8 * dt + 2 * t4;
    if (d >= Hd) continue;
    if (row_a < S)
      *reinterpret_cast<float2*>(oa + d) =
          make_float2(o[dt][0] * inv_a, o[dt][1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<float2*>(ob + d) =
          make_float2(o[dt][2] * inv_b, o[dt][3] * inv_b);
  }
}

// ---- S <= 16: keys split across a cluster, partials merged in fp32 -------
//
// Block r of the cluster takes keys [r * tsb, (r + 1) * tsb) (tsb =
// ceil(T / CLUSTER) rounded up to 32), in chunks of WARPS * 32 keys, warp w
// the chunk's keys [32 w, 32 w + 32), lane l key 32 w + l. Per query row a
// warp keeps its max (log2 domain; -inf: no key yet), sum of exp2(x - max)
// and unnormalised P V (lane l: columns l + 32 j) over its chunks.

template <int HDP, int NR>
struct SplitSmem {
  float k[WARPS * WROWS][HDP + 4];   // 4 mod 8: a quarter-warp's rows on
                                     // distinct banks
  float v[WARPS * WROWS][HDP];
  float q[NR][HDP];                  // scaled by scale * log2 e
  float m[WARPS][NR], l[WARPS][NR];
  float pm[NR], pl[NR];              // the block's partial
  float pacc[NR][HDP];
};

template <int HDP, int NR, bool MASKED>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
flash_f32_split_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       Masks mk, int S, int T, int NH, int NKV, int Hd,
                       float scale_log2, int tsb) {
  constexpr int C4 = HDP / 4, DL = (HDP + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SplitSmem<HDP, NR>& sm = *reinterpret_cast<SplitSmem<HDP, NR>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (NH / NKV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t_begin = rank * tsb;
  const int t_end = min(t_begin + tsb, visible_end(mk, b, S - 1, S, T));
  const size_t ldkv = (size_t)NKV * Hd;
  const float* kb = k + ((size_t)b * T * NKV + kvh) * Hd;
  const float* vb = v + ((size_t)b * T * NKV + kvh) * Hd;
  const int off = MASKED && mk.per_batch ? mk.q_off[b] : 0;
  const int lim = MASKED && mk.per_batch ? mk.kv_lim[b] : T;

  for (int e = tid; e < NR * HDP; e += THREADS) {
    const int i = e / HDP, d = e % HDP;
    sm.q[i][d] = i < S && d < Hd
                     ? q[(((size_t)b * S + i) * NH + h) * Hd + d] * scale_log2
                     : 0.f;
  }
  __syncthreads();

  float acc[NR][DL], m[NR], l[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[i][j] = 0.f;
  }

  const int w0 = WROWS * warp;
  for (int c0 = t_begin; c0 < t_end; c0 += WARPS * WROWS) {
    const int r0 = c0 + w0;          // this warp's keys [r0, r0 + 32)
    if (r0 >= t_end) break;          // none left for this warp
    // K, then V, as two copy groups of this warp's rows
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      const float* src = kv ? vb : kb;
#pragma unroll
      for (int it = 0; it < WROWS * C4 / 32; ++it) {
        const int e = lane + 32 * it;
        const int r = e / C4, cc = e % C4;
        const bool full = r0 + r < t_end && 4 * cc < Hd;
        const float* p = full ? src + (size_t)(r0 + r) * ldkv + 4 * cc : src;
        float* dst = kv ? &sm.v[w0 + r][4 * cc] : &sm.k[w0 + r][4 * cc];
        cp_async16(smem_u32(dst), p, full);
      }
      cp_async_commit();
    }
    cp_async_wait<1>();              // K rows landed
    __syncwarp();

    const int t = r0 + lane;
    float x[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) x[i] = 0.f;
#pragma unroll 6
    for (int c4 = 0; c4 < C4; ++c4) {
      const float4 kk =
          *reinterpret_cast<const float4*>(&sm.k[w0 + lane][4 * c4]);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(&sm.q[i][4 * c4]);
        x[i] = fmaf(qq.x, kk.x, x[i]);
        x[i] = fmaf(qq.y, kk.y, x[i]);
        x[i] = fmaf(qq.z, kk.z, x[i]);
        x[i] = fmaf(qq.w, kk.w, x[i]);
      }
    }
    // per row: masks, the warp's max over its 32 keys, the online update
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float xi = x[i];
      if (t >= t_end) xi = -INFINITY;                  // not one of its keys
      else if (MASKED && !visible(mk, b, i, t, S, T, off, lim))
        xi = NEG_SENTINEL;
      float mx = xi;
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float mn = fmaxf(m[i], mx);
      const float base = mn == -INFINITY ? 0.f : mn;
      const float p = ex2(xi - base);
      const float alpha = ex2(m[i] - base);
      float ps = p;
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o2);
      l[i] = l[i] * alpha + ps;
      m[i] = mn;
      x[i] = p;
#pragma unroll
      for (int j = 0; j < DL; ++j) acc[i][j] *= alpha;
    }

    cp_async_wait<0>();              // V rows landed
    __syncwarp();
#pragma unroll 4
    for (int c = 0; c < WROWS; ++c) {
      float vv[DL];
#pragma unroll
      for (int j = 0; j < DL; ++j)
        vv[j] = lane + 32 * j < HDP ? sm.v[w0 + c][lane + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float p = __shfl_sync(0xffffffffu, x[i], c);
#pragma unroll
        for (int j = 0; j < DL; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
    __syncwarp();                    // the rows are read before the next copy
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      sm.m[warp][i] = m[i];
      sm.l[warp][i] = l[i];
    }
  }
  __syncthreads();                   // every warp is done with K and V
  float* red = &sm.k[0][0];          // [WARPS][NR][HDP]
  static_assert(sizeof(float) * WARPS * NR * HDP <= sizeof(sm.k),
                "the accumulators fit in the K rows");
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < DL; ++j)
      if (lane + 32 * j < HDP)
        red[(warp * NR + i) * HDP + lane + 32 * j] = acc[i][j];
  __syncthreads();
  // the block's partial from its warps'
  for (int e = tid; e < NR * HDP; e += THREADS) {
    const int i = e / HDP;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm.m[w][i]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (sm.m[w][i] == -INFINITY) continue;    // a warp with no key
      const float wt = ex2(sm.m[w][i] - mx);
      sum += wt * sm.l[w][i];
      a += wt * red[w * NR * HDP + e];
    }
    sm.pacc[i][e % HDP] = a;
    if (e % HDP == 0) {
      sm.pm[i] = mx;
      sm.pl[i] = sum;
    }
  }

  // merge the cluster's partials: this block takes every CLUSTER-th slice
  cluster.sync();
  for (int e = rank * THREADS + tid; e < S * Hd; e += CLUSTER * THREADS) {
    const int i = e / Hd, d = e % Hd;
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(&sm, r)->pm[i]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      const SplitSmem<HDP, NR>* o = cluster.map_shared_rank(&sm, r);
      if (o->pm[i] == -INFINITY) continue;      // no key there
      const float w = ex2(o->pm[i] - mx);
      sum += w * o->pl[i];
      a += w * o->pacc[i][d];
    }
    out[(((size_t)b * S + i) * NH + h) * Hd + d] = a / fmaxf(sum, 1e-30f);
  }
  cluster.sync();                    // keep this block's partial until read
}

template <class Kernel>
int allow_smem(Kernel kernel, size_t smem, bool& configured) {
  if (configured) return (int)cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured = true;
  return (int)err;
}

template <int HDP, bool MASKED>
int launch_tiles(const float* q, const float* k, const float* v, float* out,
                 const Masks& mk, int B, int S, int T, int NH, int NKV,
                 int Hd, float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = Tile<HDP>::SMEM;
  static bool configured = false;
  const int err = allow_smem(flash_f32_tile_kernel<HDP, MASKED>, smem,
                             configured);
  if (err != (int)cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, NH, B);
  flash_f32_tile_kernel<HDP, MASKED><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, mk, S, T, NH, NKV, Hd, scale_log2);
  return (int)cudaGetLastError();
}

template <int HDP, int NR, bool MASKED>
int launch_split(const float* q, const float* k, const float* v, float* out,
                 const Masks& mk, int B, int S, int T, int NH, int NKV,
                 int Hd, float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = sizeof(SplitSmem<HDP, NR>);
  static bool configured = false;
  const int err = allow_smem(flash_f32_split_kernel<HDP, NR, MASKED>, smem,
                             configured);
  if (err != (int)cudaSuccess) return err;
  const int tsb = ((T + CLUSTER - 1) / CLUSTER + WROWS - 1) / WROWS * WROWS;
  dim3 grid(CLUSTER, NH, B);
  flash_f32_split_kernel<HDP, NR, MASKED><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, mk, S, T, NH, NKV, Hd, scale_log2, tsb);
  return (int)cudaGetLastError();
}

template <int HDP, bool MASKED>
int launch_rows(const float* q, const float* k, const float* v, float* out,
                const Masks& mk, int B, int S, int T, int NH, int NKV,
                int Hd, float scale_log2, cudaStream_t stream) {
  if (S == 1 && T > SPLIT_MIN_T)
    return launch_split<HDP, 1, MASKED>(q, k, v, out, mk, B, S, T, NH, NKV,
                                        Hd, scale_log2, stream);
  if (S <= SMALL_S && T > SPLIT_MIN_T)
    return launch_split<HDP, SMALL_S, MASKED>(q, k, v, out, mk, B, S, T, NH,
                                              NKV, Hd, scale_log2, stream);
  return launch_tiles<HDP, MASKED>(q, k, v, out, mk, B, S, T, NH, NKV, Hd,
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
// (per_batch) or NULL. Hd a multiple of 4, at most 128 (tiled at 32, 64,
// 72 or 128).
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
  if (Hd <= 32)
    return launch_any<32>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, Hd, sl, st);
  if (Hd <= 64)
    return launch_any<64>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, Hd, sl, st);
  if (Hd <= 72)
    return launch_any<72>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, Hd, sl, st);
  return launch_any<128>(qq, kk, vv, oo, mk, B, S, T, NH, NKV, Hd, sl, st);
}

const char* detikzify_flash_attention_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
