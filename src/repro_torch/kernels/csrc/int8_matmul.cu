// W8A16 matrix product for Hopper (sm_90a): x (M, K) bf16 or fp32 times
// int8 weights w_q (K, N) with one fp32 scale per output channel, out (M, N)
// in x's type.
//
// Replaces: src/repro/kernels/int8_matmul.py::int8_matmul (the Pallas TPU
// kernel `_kernel`).  Same function: x rounded to bf16 (as the Pallas body
// casts it), w_q widened to bf16 (exact: |w| <= 128 needs 8 mantissa bits),
// the product accumulated in fp32 over all of K, the scale applied once at
// the end, the result rounded to x's type.  The TPU grid walks K as its
// sequential axis with the accumulator in VMEM scratch; here one CTA owns a
// 64 x 64 output tile and loops over K itself, accumulating in registers.
//
// What bounds it on this card: at decode sizes (M = 4, K = 4096, N = 14336)
// the function reads 59 MB of int8 weights for 0.5 GFLOP, so the bound is
// bytes (~18 us at 3.35 TB/s, half the bf16 weights' time: the reason for
// W8A16); at prefill sizes (M = 1536) it does 180 GFLOP, bound by the
// tensor cores (~0.18 ms at 989 TFLOP/s).  The design is the simple one:
// 16-byte loads where a row segment is whole and aligned (scalar loads at
// the ragged edges, which are masked to 0), int8 -> bf16 on the way into
// shared memory, mma.sync m16n8k16 bf16 with fp32 accumulation, four warps
// of 32 x 32 each; one shared-memory buffer, no cp.async/TMA pipeline and
// no wgmma, so it runs well below both bounds.
//
// Layout of the mma.sync fragments (lane = 4 * g + t), as in
// flash_attention.cu:
//   A 16x16: {a0,a1} (g, 2t..2t+1)  {a2,a3} (g+8, 2t..)  {a4,a5} (g, 2t+8..)
//            {a6,a7} (g+8, 2t+8..)
//   B 16x8 : {b0,b1} (k=2t..2t+1, n=g)  {b2,b3} (k=2t+8.., n=g)
//   C 16x8 : {c0,c1} (g, 2t..2t+1)  {c2,c3} (g+8, 2t..2t+1)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows per CTA
constexpr int BN = 64;        // output columns per CTA
constexpr int BK = 32;        // depth of one shared-memory tile
constexpr int THREADS = 128;  // 4 warps, each a 32 x 32 sub-tile
constexpr int XS = BK + 8;    // padded row stride (bf16) of x's tile [m][k]
constexpr int WS = BK + 8;    // ... and of the weights' tile, stored [n][k]

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TX>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ wq,
                   const float* __restrict__ scale, TX* __restrict__ out,
                   int M, int N, int K) {
  constexpr int XV = 16 / sizeof(TX);  // x elements per 16-byte load
  __shared__ __align__(16) __nv_bfloat16 xs[BM * XS];
  __shared__ __align__(16) __nv_bfloat16 ws[BN * WS];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  // whole 16-byte segments can be loaded as vectors only when every row
  // starts 16-byte aligned
  const bool x_vec = K % XV == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool w_vec = N % 16 == 0 && (reinterpret_cast<uintptr_t>(wq) & 15) == 0;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x's tile, rounded to bf16; zero outside M and K
    for (int i = tid; i < BM * BK / XV; i += THREADS) {
      const int mm = i / (BK / XV), kq = (i % (BK / XV)) * XV;
      const int gm = m0 + mm, gk = k0 + kq;
      float vals[XV];
      if (gm < M && x_vec && gk + XV <= K) {
        const int4 raw =
            *reinterpret_cast<const int4*>(x + (long long)gm * K + gk);
        const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
        for (int j = 0; j < XV; ++j) vals[j] = to_f32(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < XV; ++j)
          vals[j] = (gm < M && gk + j < K)
                        ? to_f32(x[(long long)gm * K + gk + j]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < XV; ++j)
        xs[mm * XS + kq + j] = __float2bfloat16_rn(vals[j]);
    }
    // the weights' tile, widened to bf16 and stored transposed ([n][k]);
    // zero outside K and N
    for (int i = tid; i < BK * BN / 16; i += THREADS) {
      const int kk = i / (BN / 16), nq = (i % (BN / 16)) * 16;
      const int gk = k0 + kk, gn = n0 + nq;
      alignas(16) int8_t vals[16];
      if (gk < K && w_vec && gn + 16 <= N) {
        *reinterpret_cast<int4*>(vals) =
            *reinterpret_cast<const int4*>(wq + (long long)gk * N + gn);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          vals[j] = (gk < K && gn + j < N) ? wq[(long long)gk * N + gn + j]
                                            : static_cast<int8_t>(0);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
        ws[(nq + j) * WS + kk] = __float2bfloat16_rn(static_cast<float>(vals[j]));
    }
    __syncthreads();

#pragma unroll
    for (int kb = 0; kb < BK; kb += 16) {
      uint32_t a[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* p = xs + (wm + mt * 16 + g) * XS + kb + 2 * t;
        a[mt][0] = ld32(p);
        a[mt][1] = ld32(p + 8 * XS);
        a[mt][2] = ld32(p + 8);
        a[mt][3] = ld32(p + 8 * XS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* p = ws + (wn + nt * 8 + g) * WS + kb + 2 * t;
        bf[nt][0] = ld32(p);
        bf[nt][1] = ld32(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], bf[nt]);
    }
    __syncthreads();  // the next tile overwrites xs / ws
  }

  // the scale once, at the end; masked stores of the ragged edges
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mt * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn + nt * 8 + 2 * t + (e & 1);
        if (row < M && col < N)
          store(out + (long long)row * N + col, acc[mt][nt][e] * scale[col]);
      }
}

template <typename TX>
int launch(const void* x, const void* wq, const void* scale, void* out,
           int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<TX><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<TX*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), w_q (K, N) int8, scale (N,) fp32 and out (M, N) are contiguous;
// x_is_bf16 selects bf16 (1) or fp32 (0) for x and out.  Returns the
// cudaError_t of the launch (0 = cudaSuccess); -1 for a shape this file does
// not take (the Python wrapper checks first).
extern "C" int int8_matmul_launch(const void* x, const void* wq,
                                  const void* scale, void* out, int M, int N,
                                  int K, int x_is_bf16, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + BM - 1) / BM > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16>(x, wq, scale, out, M, N, K, s)
                   : launch<float>(x, wq, scale, out, M, N, K, s);
}
