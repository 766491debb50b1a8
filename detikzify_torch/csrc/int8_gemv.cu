// K5: int8 weight-only dequant GEMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// detikzify_tpu/ops/quant_matmul.py::_int8_gemv (-> _kernel), dispatched by
// int8_matmul:  y[M, N] = (x[M, K] . bf16(q)^T) * scale[N], accumulated in
// fp32 and written as bf16 or fp32. The port stores q as [N, K] int8
// (nn.Linear's [out, in]), so one output channel's K weights are
// contiguous; scale[n] belongs to row n of q, also in the fused qkv/gateup
// matrices, whose rows and scales are concatenated in the same order.
//
// What bounds it on the H100: the int8 weights, N * K bytes read once, at
// 3.35 TB/s. Decode has M <= 64 rows (8 slots; 8 x 5 in a speculate=4
// verify forward), so the product does 2 M operations per weight byte, at
// most 128, below the card's ~295 ridge: the design is about bytes and
// about keeping enough of them in flight.
//
// Design. Two kernels, chosen from M.
// - Core: mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the weights as
//   the 16-row A side and 8 rows of x as the B side. At 64 rows the
//   lm_head needs ~0.43 PFLOP/s at its byte bound, inside mma.sync's rate;
//   on the H100 it runs at 0.30 ms against a bound of 0.167 and at 0.24 at
//   40 rows, where the tensor cores do 5/8 of the work, so the core is not
//   what holds it back.
// - Narrow blocks (M <= 8, one n-tile): 16 output channels a block, its 8
//   warps along K (chunk c to warp c % 8), 3 blocks an SM (qkv's 384 in
//   one wave). Each lane loads its weights of a chunk from global memory
//   straight into registers with 16-byte ld.global.cs loads and reads its
//   x (at most 8 rows, held in L1 and L2) with 16-byte loads; the 8
//   partial sums meet in shared memory in warp order. There is no barrier
//   before that sum and no chunk is loaded ahead: on the H100 a
//   shared-memory ring, or registers holding 1-3 chunks ahead, made these
//   products slower, not faster (most at 1 row). x is read once per 16
//   channels, (N / 16) * M * K * 2 bytes, at 8 rows as many as the
//   weights. qkv, o and down get 256-384 blocks without a split.
// - Wide blocks (M > 8): 128 channels, 8 warps each with a slice of 16
//   channels. One ring of stages in shared memory, filled with
//   cp.async.cg, carries both operands: a stage holds one 128-wide K chunk
//   of the block's weights (16 KB, loaded with an evict-first L2 policy:
//   they are read once) and of x (all M rows). As many stages as fit 2
//   blocks an SM (3 to 6) keep all but one in flight with no registers
//   spent on them.
// - x traffic: a wide block reads x once for 128 channels: (N / 128) * M *
//   K * 2 bytes from L2 instead of the (N / 16) * M * K * 2 of one read per
//   16 channels, 0.33 GB instead of 2.6 GB for the lm_head at 40 rows. The
//   warps read their B fragments from the stage with 16-byte loads on a
//   swizzled layout (no bank conflicts).
// - Tile count: the wide kernel is templated on NT = ceil(M / 8) n-tiles
//   of 8 rows, 2 to 8, so 40 rows do 5 tiles of work, not 8. Rows of the
//   last tile beyond M are neither read from x nor written in the stage.
// - Occupancy: where wide blocks are fewer than the SMs (qkv, o, down and
//   the MAP head), the wrapper splits K over gridDim.y blocks
//   (ops/quant_matmul.py::gemv_plan): each writes fp32 partials
//   [split][M][N], and a second kernel, launched as a programmatic
//   dependent, sums them in split order (no atomics: two launches on the
//   same inputs are bit-identical) and applies scale[n] once. Without a
//   split the block applies scale itself.
//
// Inside a chunk the K order is permuted, identically for A and B (a dot
// product does not depend on the order of its terms), so that each lane's
// A and B operands are contiguous in memory: in step s = 4h + j (h = 0, 1;
// j = 0..3) lane (g, t) holds logical k {2t, 2t+1, 2t+8, 2t+9}, which it
// maps to physical k 64h + 16t + 4j + {0,1,2,3}. Its weights are two
// 16-byte loads a chunk and row; its x is one 16-byte load per two steps
// (bf16) or per step (fp32).
//
// The int8 -> bf16 conversion is exact (through fp32 bit patterns, not the
// quarter-rate int-to-float unit). An fp32 x is split into three bf16
// terms (hi + mid + lo equals it to within 2^-24 relative), each
// multiplied exactly in the tensor cores, so an fp32 input is never
// rounded to bf16. The output is rounded once.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using detikzify_sm90::cp_async_commit;
using detikzify_sm90::cp_async_wait;
using detikzify_sm90::cp_async16;
using detikzify_sm90::pack_bf16;
using detikzify_sm90::smem_u32;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SLICE = 16;                // output channels per warp (mma M)
constexpr int CHUNK_K = 128;             // K of a chunk
constexpr int NARROW_ROWS = 8;           // narrow blocks up to this M
constexpr int NARROW_PER_SM = 3;         // qkv's 384 narrow blocks: 1 wave
constexpr int BLOCK_N = WARPS * SLICE;   // wide: output channels a block
constexpr int W_STAGE = BLOCK_N * CHUNK_K;  // wide: weight bytes a stage
constexpr int WIDE_PER_SM = 2;
constexpr int WIDE_SMEM = 110 * 1024;    // wide: ring bytes a block
constexpr int REDUCE_THREADS = 256;

// 4 signed int8 -> two bf16x2 registers {b0, b1} and {b2, b3}, exactly:
// byte u = b + 128 placed in the mantissa of 2^23 gives 2^23 + u in fp32;
// subtracting 2^23 + 128 leaves b, an integer of at most 8 bits, whose
// fp32 upper half is its bf16.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// D = A B + D, A 16x16 bf16 (row), B 16x8 bf16 (col), D 16x8 fp32. Not
// volatile: the compiler may move it among the loads.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An L2 policy that marks lines for eviction first: the weights are read
// once, so they should not push out what L2 holds for later (activations,
// the KV cache, x).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// a 16-byte cp.async with an L2 cache policy
__device__ __forceinline__ void cp_async16_hint(uint32_t dst, const void* src,
                                                uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
      :: "r"(dst), "l"(src), "l"(policy) : "memory");
}

// One chunk of a warp's weights in registers: lane (g, t) holds the bytes
// [16t, 16t + 16) (lo0, hi0) and [64 + 16t, 80 + 16t) (lo1, hi1) of the
// chunk for channel g (lo) and channel g + 8 (hi).
struct WChunk {
  uint4 lo0, lo1, hi0, hi1;
};

// A of step s: {row g, k 2t..2t+1}, {row g+8, same}, {row g, k 2t+8..2t+9},
// {row g+8, same}
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], uint32_t lo,
                                       uint32_t hi) {
  i8x4_to_bf16(lo, a[0], a[2]);
  i8x4_to_bf16(hi, a[1], a[3]);
}

// acc[nt] += W(16 channels x 128) . x(chunk, rows 8 nt..)^T, where xu(row,
// u) gives the 16 bytes of unit u of the chunk in row `row` of x (8 bf16
// or 4 fp32 values)
template <typename XT, int NT, typename XU>
__device__ __forceinline__ void mma_chunk(float (&acc)[NT][4],
                                          const WChunk& w, XU xu, int g,
                                          int t) {
  const uint32_t wl[8] = {w.lo0.x, w.lo0.y, w.lo0.z, w.lo0.w,
                          w.lo1.x, w.lo1.y, w.lo1.z, w.lo1.w};
  const uint32_t wh[8] = {w.hi0.x, w.hi0.y, w.hi0.z, w.hi0.w,
                          w.hi1.x, w.hi1.y, w.hi1.z, w.hi1.w};
  if constexpr (sizeof(XT) == 2) {
#pragma unroll
    for (int s2 = 0; s2 < 4; ++s2) {       // steps 2 s2 and 2 s2 + 1
      uint32_t a0[4], a1[4];
      a_frag(a0, wl[2 * s2], wh[2 * s2]);
      a_frag(a1, wl[2 * s2 + 1], wh[2 * s2 + 1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {    // B column = x row
        const uint4 v = xu(nt * 8 + g, 8 * (s2 >> 1) + 2 * t + (s2 & 1));
        mma_bf16(acc[nt], a0, v.x, v.y);
        mma_bf16(acc[nt], a1, v.z, v.w);
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      uint32_t a[4];
      a_frag(a, wl[s], wh[s]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4 v = xu(nt * 8 + g, 16 * (s >> 2) + 4 * t + (s & 3));
        float r[4] = {__uint_as_float(v.x), __uint_as_float(v.y),
                      __uint_as_float(v.z), __uint_as_float(v.w)};
#pragma unroll
        for (int p = 0; p < 3; ++p) {       // hi, mid, lo bf16 terms
          float h[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            h[j] = __bfloat162float(__float2bfloat16_rn(r[j]));
            r[j] -= h[j];                  // exact: the rounding error of h
          }
          mma_bf16(acc[nt], a, pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
        }
      }
    }
  }
}

__device__ __forceinline__ void store(float* y, float v) { *y = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}

// Narrow block bx: channels [16 bx, 16 bx + 16) for M <= 8 rows, warp w
// over the chunks w, w + 8, ...; y = (the warps' sums in warp order) *
// scale.
template <typename XT, typename OT>
__global__ void __launch_bounds__(THREADS, NARROW_PER_SM)
int8_gemv_narrow_kernel(const XT* __restrict__ x,
                        const int8_t* __restrict__ q,
                        const float* __restrict__ scale, OT* __restrict__ y,
                        int M, int N, int K) {
  __shared__ float red[WARPS][NARROW_ROWS][SLICE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nw = blockIdx.x * SLICE;
  const int chunks = K / CHUNK_K;
  const int8_t* w_lo = q + (size_t)(nw + g) * K + 16 * t;   // channel g
  const int8_t* w_hi = w_lo + (size_t)8 * K;                // channel g + 8
  // row g of x; rows g >= M read row M - 1 instead: row j of x reaches
  // only row j of the result, which is then not stored
  const char* xr = reinterpret_cast<const char*>(
      x + (size_t)(g < M ? g : M - 1) * K);

  float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
  for (int c = warp; c < chunks; c += WARPS) {
    const size_t k0 = (size_t)c * CHUNK_K;
    WChunk w;
    w.lo0 = __ldcs(reinterpret_cast<const uint4*>(w_lo + k0));
    w.lo1 = __ldcs(reinterpret_cast<const uint4*>(w_lo + k0 + 64));
    w.hi0 = __ldcs(reinterpret_cast<const uint4*>(w_hi + k0));
    w.hi1 = __ldcs(reinterpret_cast<const uint4*>(w_hi + k0 + 64));
    const char* xc = xr + k0 * sizeof(XT);
    mma_chunk<XT, 1>(acc, w, [xc](int, int u) {
      return __ldg(reinterpret_cast<const uint4*>(xc + u * 16));
    }, g, t);
  }

  // D fragment: {ch g, row 2t}, {ch g, row 2t+1}, {ch g+8, row 2t}, ...
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    red[warp][2 * t + h][g] = acc[0][h];
    red[warp][2 * t + h][g + 8] = acc[0][2 + h];
  }
  __syncthreads();
  if ((int)threadIdx.x < M * SLICE) {
    const int r = threadIdx.x / SLICE, ch = threadIdx.x % SLICE;
    float sum = red[0][r][ch];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum += red[w][r][ch];
    store(y + (size_t)r * N + nw + ch, sum * scale[nw + ch]);
  }
}

// The weight tile of a wide stage: BLOCK_N rows of one chunk, 8 16-byte
// units a row; unit u of row r sits at u ^ (4 (r % 2)). Lane (g, t) reads
// units t and 4 + t in rows g and g + 8 of its slice, so a load phase
// (rows g, g + 1) hits 8 distinct bank groups.
__device__ __forceinline__ int w_offset(int row, int u) {
  return row * CHUNK_K + ((u ^ ((row & 1) << 2)) << 4);
}

// The x tile of a wide stage: 8 NT rows of one chunk, UPR 16-byte units a
// row. In one 16-byte load phase (8 lanes: rows g and g + 1, columns t =
// 0..3) lane (g, t) reads unit 8h + 2t + s2 % 2 (bf16, steps 2 s2 and 2 s2
// + 1, h = s2 / 2) or 16h + 4t + j (fp32, step 4h + j). Unit u of row r is
// stored at u ^ (r % 2), and for fp32 also with bit 1 flipped by bit 3 of
// u, so the 8 lanes of a phase hit 8 distinct bank groups; the swizzle
// permutes aligned groups of 8 units, so a warp copying a row writes 8
// distinct ones.
template <typename XT>
struct XTile {
  static constexpr int UPR = CHUNK_K * (int)sizeof(XT) / 16;  // 16 or 32
  __device__ static __forceinline__ int offset(int row, int u) {
    const int su = sizeof(XT) == 2 ? u ^ (row & 1)
                                   : u ^ (row & 1) ^ (((u >> 3) & 1) << 1);
    return (row * UPR + su) * 16;
  }
};

// cp.async the weights of channels [nb, nb + BLOCK_N) and chunk c into the
// stage at dst, evict-first in L2; channels at or beyond N are left as
// they are (no warp reads them)
__device__ __forceinline__ void stage_w(uint32_t dst,
                                        const int8_t* __restrict__ q, int N,
                                        int K, int nb, int c,
                                        uint64_t policy) {
  constexpr int UNITS = W_STAGE / 16;
#pragma unroll
  for (int i0 = 0; i0 < UNITS; i0 += THREADS) {
    const int i = i0 + (int)threadIdx.x;
    const int row = i / 8, u = i % 8;
    if (nb + row < N)
      cp_async16_hint(dst + w_offset(row, u),
                      q + (size_t)(nb + row) * K + (size_t)c * CHUNK_K +
                          u * 16,
                      policy);
  }
}

// cp.async the rows [0, M) of x's chunk c into the stage at dst; rows M..8
// NT - 1 are read but left as they are: row j of x is column j of the
// mma's B, which reaches only column j of its result, an output row that
// is never stored.
template <typename XT, int NT>
__device__ __forceinline__ void stage_x(uint32_t dst, const XT* __restrict__ x,
                                        int M, int K, int c) {
  using T = XTile<XT>;
  constexpr int UNITS = NT * 8 * T::UPR;
  const char* base = reinterpret_cast<const char*>(x) +
                     (size_t)c * CHUNK_K * sizeof(XT);
#pragma unroll
  for (int i0 = 0; i0 < UNITS; i0 += THREADS) {
    const int i = i0 + (int)threadIdx.x;
    const int row = i / T::UPR, u = i % T::UPR;
    if ((UNITS % THREADS == 0 || i < UNITS) && row < M)
      cp_async16(dst + T::offset(row, u),
                 base + (size_t)row * K * sizeof(XT) + u * 16, true);
  }
}

// The wide ring: a stage holds one chunk of weights (16 KB) and of x (8 NT
// rows); as many stages as fit the block's share of the SM, 3 to 6.
template <typename XT, int NT>
struct Ring {
  static constexpr int STAGE = W_STAGE + NT * 8 * CHUNK_K * (int)sizeof(XT);
  static constexpr int FIT = WIDE_SMEM / STAGE;
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 6 ? 6 : FIT);
  static constexpr int BYTES = STAGES * STAGE;
};

// Wide block (bx, split): channels [BLOCK_N bx, BLOCK_N (bx + 1)) over the
// chunks [split C / S, (split + 1) C / S) of the C = K / 128, S =
// gridDim.y; warp w takes the slice of 16 channels w. S == 1: y = acc *
// scale; else part[split][M][N] = acc.
template <typename XT, typename OT, int NT>
__global__ void __launch_bounds__(THREADS, WIDE_PER_SM)
int8_gemv_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, OT* __restrict__ y,
                 float* __restrict__ part, int M, int N, int K) {
  using R = Ring<XT, NT>;
  extern __shared__ __align__(128) unsigned char ring[];
  // the reduce kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nsplit = gridDim.y, split = blockIdx.y;
  const int chunks = K / CHUNK_K;
  const int c0 = (int)((long long)split * chunks / nsplit);
  const int c1 = (int)((long long)(split + 1) * chunks / nsplit);
  const int nb = blockIdx.x * BLOCK_N;
  const int nw = nb + warp * SLICE;          // the warp's channels
  const bool active = nw < N;      // N % 16 == 0: a slice is whole or absent
  const uint32_t ring_s = smem_u32(ring);
  const uint64_t policy = evict_first_policy();

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // stage i holds chunk c0 + i in ring slot i % STAGES; the slot of stage
  // i - 1 is refilled before stage i is multiplied (STAGES - 1 in flight)
  constexpr int AHEAD = R::STAGES - 1;
  const int nstages = c1 - c0;
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) {
    if (i < nstages) {
      stage_w(ring_s + i * R::STAGE, q, N, K, nb, c0 + i, policy);
      stage_x<XT, NT>(ring_s + i * R::STAGE + W_STAGE, x, M, K, c0 + i);
    }
    cp_async_commit();
  }
  int slot = 0;
  for (int i = 0; i < nstages; ++i) {
    cp_async_wait<AHEAD - 1>();    // this thread's copies of stage i
    __syncthreads();                 // everyone's; stage i - 1 is consumed
    const int next = i + AHEAD;
    if (next < nstages) {            // into the slot of stage i - 1
      const int ns = slot == 0 ? R::STAGES - 1 : slot - 1;
      stage_w(ring_s + ns * R::STAGE, q, N, K, nb, c0 + next, policy);
      stage_x<XT, NT>(ring_s + ns * R::STAGE + W_STAGE, x, M, K, c0 + next);
    }
    cp_async_commit();
    if (active) {
      const unsigned char* ws = ring + slot * R::STAGE;
      const unsigned char* xs = ws + W_STAGE;
      const int row = warp * SLICE + g;
      WChunk w;
      w.lo0 = *reinterpret_cast<const uint4*>(ws + w_offset(row, t));
      w.lo1 = *reinterpret_cast<const uint4*>(ws + w_offset(row, 4 + t));
      w.hi0 = *reinterpret_cast<const uint4*>(ws + w_offset(row + 8, t));
      w.hi1 = *reinterpret_cast<const uint4*>(ws + w_offset(row + 8, 4 + t));
      mma_chunk<XT, NT>(acc, w, [xs](int r, int u) {
        return *reinterpret_cast<const uint4*>(xs + XTile<XT>::offset(r, u));
      }, g, t);
    }
    slot = slot == R::STAGES - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();
  if (!active) return;

  // D fragment: {ch g, row 2t}, {ch g, row 2t+1}, {ch g+8, row 2t}, ...
  const int n_lo = nw + g, n_hi = n_lo + 8;
  const float s_lo = nsplit == 1 ? scale[n_lo] : 1.f;
  const float s_hi = nsplit == 1 ? scale[n_hi] : 1.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = nt * 8 + 2 * t + h;
      if (r >= M) continue;
      if (nsplit == 1) {
        store(y + (size_t)r * N + n_lo, acc[nt][h] * s_lo);
        store(y + (size_t)r * N + n_hi, acc[nt][2 + h] * s_hi);
      } else {
        float* p = part + ((size_t)split * M + r) * N;
        p[n_lo] = acc[nt][h];
        p[n_hi] = acc[nt][2 + h];
      }
    }
  }
}

__device__ __forceinline__ void store4(float* y, float4 v) {
  *reinterpret_cast<float4*>(y) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* y, float4 v) {
  uint2 o;
  o.x = pack_bf16(v.x, v.y);
  o.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(y) = o;
}

// y[m, n..n+3] = (sum over splits, in split order, of part[split][m][n..])
// * scale[n..]; one thread a 4-wide group of y
template <typename OT>
__global__ void __launch_bounds__(REDUCE_THREADS)
int8_gemv_reduce_kernel(const float* __restrict__ part,
                        const float* __restrict__ scale, OT* __restrict__ y,
                        int M, int N, int nsplit) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the partials
  const size_t groups = (size_t)M * N / 4;
  const size_t i = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= groups) return;
  const float4* p = reinterpret_cast<const float4*>(part) + i;
  float4 s = p[0];
#pragma unroll 4
  for (int sp = 1; sp < nsplit; ++sp) {
    const float4 v = p[sp * groups];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const int n = (int)((i * 4) % N);
  const float4 sc = *reinterpret_cast<const float4*>(scale + n);
  store4(y + i * 4, make_float4(s.x * sc.x, s.y * sc.y, s.z * sc.z,
                                s.w * sc.w));
}

template <typename XT, typename OT, int NT>
cudaError_t launch_wide(const void* x, const void* q, const void* scale,
                        void* y, void* scratch, int M, int N, int K,
                        int nsplit, cudaStream_t st) {
  constexpr int smem = Ring<XT, NT>::BYTES;
  auto* kernel = int8_gemv_kernel<XT, OT, NT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const float* ss = static_cast<const float*>(scale);
  OT* yy = static_cast<OT*>(y);
  float* part = static_cast<float*>(scratch);
  const dim3 grid((N + BLOCK_N - 1) / BLOCK_N, nsplit);
  kernel<<<grid, THREADS, smem, st>>>(static_cast<const XT*>(x),
                                      static_cast<const int8_t*>(q), ss, yy,
                                      part, M, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  // the reduce as a programmatic dependent: its launch overlaps the tail.
  // A CUDA graph capture (the decode engine's) records it as a
  // programmatic edge (CUDA 12.3 and later), so a replay keeps the overlap
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  const size_t groups = (size_t)M * N / 4;
  cfg.gridDim = dim3((unsigned)((groups + REDUCE_THREADS - 1) /
                                REDUCE_THREADS));
  cfg.blockDim = dim3(REDUCE_THREADS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_gemv_reduce_kernel<OT>,
                            static_cast<const float*>(part), ss, yy, M, N,
                            nsplit);
}

template <typename XT, typename OT>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y,
                   void* scratch, int M, int N, int K, int nsplit,
                   cudaStream_t st) {
  if (M <= NARROW_ROWS) {
    int8_gemv_narrow_kernel<XT, OT><<<N / SLICE, THREADS, 0, st>>>(
        static_cast<const XT*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<OT*>(y), M, N, K);
    return cudaGetLastError();
  }
#define K5_WIDE(NT) \
  launch_wide<XT, OT, NT>(x, q, scale, y, scratch, M, N, K, nsplit, st)
  switch ((M + 7) / 8) {
    case 2: return K5_WIDE(2);
    case 3: return K5_WIDE(3);
    case 4: return K5_WIDE(4);
    case 5: return K5_WIDE(5);
    case 6: return K5_WIDE(6);
    case 7: return K5_WIDE(7);
    default: return K5_WIDE(8);
  }
#undef K5_WIDE
}

}  // namespace

extern "C" {

// x [M, K] (bf16, or fp32 when x_f32) contiguous and 16-byte aligned,
// q [N, K] int8, scale [N] fp32, y [M, N] (fp32 when y_f32, else bf16);
// 1 <= M <= 64, K a multiple of 128, N a multiple of 16; an fp32 x needs
// an fp32 y. M <= 8 takes narrow blocks, which do not split K (nsplit =
// 1); above, K is split over 1 <= nsplit <= K / 128 wide blocks, and
// nsplit > 1 needs scratch of nsplit * M * N floats, 16-byte aligned.
int detikzify_int8_gemv(const void* x, const void* q, const void* scale,
                        void* y, void* scratch, int M, int N, int K,
                        int nsplit, int x_f32, int y_f32, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (M > 64 || N % SLICE != 0 || K <= 0 || K % CHUNK_K != 0 ||
      (x_f32 && !y_f32) || nsplit < 1 || nsplit > K / CHUNK_K ||
      (M <= NARROW_ROWS && nsplit != 1) ||
      (nsplit > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_f32)
    err = launch<float, float>(x, q, scale, y, scratch, M, N, K, nsplit, st);
  else if (y_f32)
    err = launch<__nv_bfloat16, float>(x, q, scale, y, scratch, M, N, K,
                                       nsplit, st);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, q, scale, y, scratch, M, N,
                                               K, nsplit, st);
  return (int)err;
}

const char* detikzify_int8_gemv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
