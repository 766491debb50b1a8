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
// 3.35 TB/s. Decode has M <= 64 rows (8 slots at v2-8b), so x and y are
// small and the 2 * M * N * K operations sit far below the tensor cores'
// rate.
//
// Design: one block of 8 warps per 16 output channels. K is cut into
// 128-wide chunks dealt round-robin to the block's warps. For each chunk a
// lane reads 32 contiguous weight bytes of channel g and of channel g + 8
// (g = lane / 4) with 16-byte streaming loads (ld.global.cs: read once,
// not kept in L1), turns the int8 into bf16 in registers exactly (through
// fp32 bit patterns, not the quarter-rate int-to-float unit) and issues
// mma.sync m16n8k16 with fp32 accumulators: the 16 channels are the rows
// of A, 8 rows of x the columns of B, one n-tile per 8 rows of x. Inside a
// chunk the K order is permuted, identically for A and B (a dot product
// does not depend on the order of its terms), so that each lane's A and B
// operands are contiguous in memory: in step s lane (g, t) holds logical k
// {2t, 2t+1, 2t+8, 2t+9}, which it maps to physical k 32t + 4s + {0,1,2,3}.
// x is read straight from global memory through L1 (it is at most 64 x K
// bf16). At the end the 8 warps' partial sums meet in shared memory and
// scale[n] is applied once per output. A chunk whose rows of x lie beyond
// M feeds zeros.
//
// An fp32 x is split into three bf16 terms (hi + mid + lo equals it to
// within 2^-24 relative), each multiplied exactly in the tensor cores, so
// an fp32 input is never rounded to bf16.
//
// Interface: plain C, launched on the caller's stream; returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_N = 16;     // output channels per block (the mma's M)
constexpr int CHUNK_K = 128;   // K per warp iteration
constexpr int STEPS = CHUNK_K / 16;

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

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// D = A B + D, A 16x16 bf16 (row), B 16x8 bf16 (col), D 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four consecutive x values -> B registers (physical k pairs (0,1), (2,3)),
// as SPLIT bf16 terms whose sum is x.
template <typename XT>
struct XLoad;

template <>
struct XLoad<__nv_bfloat16> {
  static constexpr int SPLIT = 1;
  __device__ static void run(const __nv_bfloat16* p, bool ok,
                             uint32_t (&b)[1][2]) {
    uint2 v = make_uint2(0u, 0u);
    if (ok) v = __ldg(reinterpret_cast<const uint2*>(p));
    b[0][0] = v.x;
    b[0][1] = v.y;
  }
};

template <>
struct XLoad<float> {
  static constexpr int SPLIT = 3;
  __device__ static void run(const float* p, bool ok, uint32_t (&b)[3][2]) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) v = __ldg(reinterpret_cast<const float4*>(p));
    float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      float h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = __bfloat162float(__float2bfloat16_rn(r[j]));
        r[j] -= h[j];                  // exact: the rounding error of h
      }
      b[s][0] = pack_bf16(h[0], h[1]);
      b[s][1] = pack_bf16(h[2], h[3]);
    }
  }
};

__device__ __forceinline__ void store(float* y, float v) { *y = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}

// NT n-tiles of 8 rows of x: handles M <= 8 * NT
template <typename XT, typename OT, int NT>
__global__ void __launch_bounds__(THREADS)
int8_gemv_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, OT* __restrict__ y, int M,
                 int N, int K) {
  __shared__ float part[WARPS][TILE_N][NT * 8];
  constexpr int SPLIT = XLoad<XT>::SPLIT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TILE_N;
  const int nchunks = K / CHUNK_K;

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int8_t* w_lo = q + (size_t)(n0 + g) * K + 32 * t;   // channel g
  const int8_t* w_hi = w_lo + (size_t)8 * K;                // channel g + 8
  const XT* xl = x + 32 * t;

  for (int c = warp; c < nchunks; c += WARPS) {
    const size_t k0 = (size_t)c * CHUNK_K;
    const uint4 l0 = __ldcs(reinterpret_cast<const uint4*>(w_lo + k0));
    const uint4 l1 = __ldcs(reinterpret_cast<const uint4*>(w_lo + k0 + 16));
    const uint4 h0 = __ldcs(reinterpret_cast<const uint4*>(w_hi + k0));
    const uint4 h1 = __ldcs(reinterpret_cast<const uint4*>(w_hi + k0 + 16));
    const uint32_t wl[STEPS] = {l0.x, l0.y, l0.z, l0.w,
                                l1.x, l1.y, l1.z, l1.w};
    const uint32_t wh[STEPS] = {h0.x, h0.y, h0.z, h0.w,
                                h1.x, h1.y, h1.z, h1.w};
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      // A: {row g, k 2t..2t+1}, {row g+8, same}, {row g, k 2t+8..2t+9},
      // {row g+8, same}
      uint32_t a0, a1, a2, a3;
      i8x4_to_bf16(wl[s], a0, a2);
      i8x4_to_bf16(wh[s], a1, a3);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int row = nt * 8 + g;                 // B column = x row
        uint32_t b[SPLIT][2];
        XLoad<XT>::run(xl + (size_t)row * K + k0 + 4 * s, row < M, b);
#pragma unroll
        for (int p = 0; p < SPLIT; ++p)
          mma_bf16(acc[nt], a0, a1, a2, a3, b[p][0], b[p][1]);
      }
    }
  }

  // D fragment: {ch g, row 2t}, {ch g, row 2t+1}, {ch g+8, row 2t}, ...
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int r = nt * 8 + 2 * t;
    part[warp][g][r] = acc[nt][0];
    part[warp][g][r + 1] = acc[nt][1];
    part[warp][g + 8][r] = acc[nt][2];
    part[warp][g + 8][r + 1] = acc[nt][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < M * TILE_N; e += THREADS) {
    const int r = e / TILE_N, ch = e % TILE_N;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += part[w][ch][r];
    store(y + (size_t)r * N + n0 + ch, sum * scale[n0 + ch]);
  }
}

template <typename XT, typename OT>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y,
                   int M, int N, int K, cudaStream_t st) {
  const dim3 grid(N / TILE_N);
  const XT* xx = static_cast<const XT*>(x);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(scale);
  OT* yy = static_cast<OT*>(y);
  if (M <= 8)
    int8_gemv_kernel<XT, OT, 1><<<grid, THREADS, 0, st>>>(xx, qq, ss, yy, M,
                                                         N, K);
  else if (M <= 16)
    int8_gemv_kernel<XT, OT, 2><<<grid, THREADS, 0, st>>>(xx, qq, ss, yy, M,
                                                         N, K);
  else if (M <= 32)
    int8_gemv_kernel<XT, OT, 4><<<grid, THREADS, 0, st>>>(xx, qq, ss, yy, M,
                                                         N, K);
  else
    int8_gemv_kernel<XT, OT, 8><<<grid, THREADS, 0, st>>>(xx, qq, ss, yy, M,
                                                         N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] (bf16, or fp32 when x_f32) contiguous and 16-byte aligned,
// q [N, K] int8, scale [N] fp32, y [M, N] (fp32 when y_f32, else bf16).
// 1 <= M <= 64, K a multiple of 128, N a multiple of 16; an fp32 x needs
// an fp32 y.
int detikzify_int8_gemv(const void* x, const void* q, const void* scale,
                        void* y, int M, int N, int K, int x_f32, int y_f32,
                        void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (M > 64 || N % TILE_N != 0 || K <= 0 || K % CHUNK_K != 0 ||
      (x_f32 && !y_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_f32)
    err = launch<float, float>(x, q, scale, y, M, N, K, st);
  else if (y_f32)
    err = launch<__nv_bfloat16, float>(x, q, scale, y, M, N, K, st);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, q, scale, y, M, N, K, st);
  return (int)err;
}

const char* detikzify_int8_gemv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
