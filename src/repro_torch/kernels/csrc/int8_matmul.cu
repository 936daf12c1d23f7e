// W8A16 matrix product for Hopper (sm_90a): x (M, K) bf16 or fp32 times
// int8 weights w_q (K, N) with one fp32 scale per output channel, out (M, N)
// in x's type.
//
// Replaces: src/repro/kernels/int8_matmul.py::int8_matmul (the Pallas TPU
// kernel `_kernel`).  Same function: x rounded to bf16 (as the Pallas body
// casts it), w_q widened to bf16 (exact: |w| <= 128 needs 8 mantissa bits),
// the product accumulated in fp32 over all of K, the scale applied once at
// the end, the result rounded to x's type.  The TPU grid walks K as its
// sequential axis with the accumulator in VMEM scratch; here a CTA loops
// over K itself, accumulating in registers.
//
// Three designs, chosen by shape, dtype and alignment in the Python wrapper
// (`int8_matmul.route`):
//
//   wgmma (bf16 x, M above the split-K limit, K % 8 == 0, N % 16 == 0,
//   16-byte aligned x and w_q).  Prefill M is bound by the tensor cores
//   (M = 1536, K = 4096, N = 14336: 180 GFLOP, ~0.18 ms at 989 TFLOP/s,
//   against ~0.02 ms of bytes).  The CTA computes a tile of out^T = w^T x^T:
//   the int8 operand is wgmma's A side, as in mixed-input GEMMs, so each
//   warpgroup widens only its own 64 weight columns and the two need no
//   barrier between them.  One CTA: two warpgroups, 128 weight columns x BX
//   rows of x (192 or 256, `wgmma_tile`), K in steps of 64 through a ring
//   of TMA stages (x's tile 128-byte swizzled; the raw int8 tile, 64 K rows
//   x 128 columns, swizzled too), thread 0 also the producer.  Per step a
//   warpgroup widens its 64 x 64 int8 block to a bf16 [k][n] tile in shared
//   memory (double-buffered, 128-byte swizzled), fences it to the async
//   proxy, syncs its 128 threads on a named barrier and issues four wgmma
//   m64nBXk16 with A MN-major (the transpose bit) and x as a K-major B.
//   Accumulators stay in registers over all of K; the products of one step
//   run while the next step is widened (wgmma.wait_group 1), and nothing in
//   the loop touches the accumulators, or the compiler would wait for every
//   product.  The weights cross device memory once per BX rows of x, as
//   int8.  The widening is exact: with m = w & 0x7F and sg = w & 0x80,
//   w = (128 + m) - (128 + sg), two bf16 of exponent 2^7 built by a byte
//   permute and a mask, one bf16x2 subtraction for two weights.  TMA's zero
//   fill covers ragged M, N and K; the epilogue applies the scale once and
//   masks the ragged edges (widened columns are stored even-then-odd, so a
//   lane's two accumulator rows are adjacent columns: 4-byte stores).
//   Deterministic: one CTA per output tile, K in order, no atomics.
//
//   splitk (M <= the split-K limit, bf16 or fp32 x, N % 16 == 0, aligned).
//   Decode M is bound by bytes (M = 4: 58.7 MB of int8 weights, ~0.018 ms
//   at 3.35 TB/s, for 0.5 GFLOP).  The grid is column blocks of 128 x K
//   splits, sized so that every CTA is resident at once (`split_plan`);
//   each CTA streams its int8 slab by TMA through a ring of SK_STAGES 8 KB
//   stages, so ~100 KB are in flight per SM.  Its x rows for its K slice
//   are loaded once, by 16-byte vectors, rounded to bf16, into shared
//   memory.  Products on mma.sync m16n8k16 with the weights as the A
//   operand (16 output columns) and x^T as B (8 rows), so M pads to 8, not
//   16, and only in registers.  K inside each 16-step is permuted (the 16
//   rows 4t..4t+3 belong to lane quad t) so that a lane's weights for a
//   tile are 16-byte row segments and its x values 8 contiguous bytes.
//   The four warps take the four 16-row steps of each 64-row stage and are
//   summed in warp order through shared memory; the CTA writes its fp32
//   partial to a (splits, M, N) workspace and a second kernel, started as a
//   programmatic dependent launch, sums the splits in split order, scales
//   and casts.  Deterministic: fixed orders, no atomics.
//
//   general (every other shape: fp32 x above the limit, N % 16 != 0,
//   K % 8 != 0, unaligned pointers).  The simple kernel: 64 x 64 output
//   tiles, four warps of mma.sync m16n8k16, one shared-memory buffer of
//   BK = 32, 16-byte loads where a row segment is whole and aligned.
//
// Layout of the mma.sync fragments (lane = 4 * g + t), as in
// flash_attention.cu:
//   A 16x16: {a0,a1} (g, 2t..2t+1)  {a2,a3} (g+8, 2t..)  {a4,a5} (g, 2t+8..)
//            {a6,a7} (g+8, 2t+8..)
//   B 16x8 : {b0,b1} (k=2t..2t+1, n=g)  {b2,b3} (k=2t+8.., n=g)
//   C 16x8 : {c0,c1} (g, 2t..2t+1)  {c2,c3} (g+8, 2t..2t+1)
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- mbarriers (as in flash_attention.cu) --------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait that
// never completes (a copy that never lands) traps instead of hanging the
// card: ~2^26 polls is seconds, against microseconds for any real wait.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// --- TMA: one box of a 2-D tensor map into shared memory ----------------
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Programmatic dependent launch (as in decode_attention.cu).
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void start_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// =========================================================================
// general: the simple kernel, for every shape the other two do not take
// =========================================================================
constexpr int BM = 64;        // output rows per CTA
constexpr int BN = 64;        // output columns per CTA
constexpr int BK = 32;        // depth of one shared-memory tile
constexpr int THREADS = 128;  // 4 warps, each a 32 x 32 sub-tile
constexpr int XS = BK + 8;    // padded row stride (bf16) of x's tile [m][k]
constexpr int WS = BK + 8;    // ... and of the weights' tile, stored [n][k]

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

// =========================================================================
// wgmma: prefill M, bf16 x, TMA-aligned shapes
// =========================================================================
constexpr int WG_BN = 128;       // weight columns per CTA: two warpgroups
constexpr int WG_BK = 64;        // K per ring stage: one 128-byte swizzled row
constexpr int WG_THREADS = 256;  // two warpgroups; thread 0 also the producer
constexpr int ROW_BYTES = 128;   // one swizzled row: 64 bf16

// Shared-memory matrix descriptor for a 128-byte-swizzled operand whose
// 8-row swizzle atoms (1024 bytes) are 1024-byte aligned (as in
// flash_attention.cu).  K-major: sbo = the stride between 8-row groups (lbo
// unused); MN-major: lbo = the stride between 64-element column blocks, sbo
// = the stride between 8-row groups of the reduction dim.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;  // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 192, fp32) += A B, A MN-major (the transpose bit) and B K-major,
// both from shared memory
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 256, fp32) += A B, A MN-major (the transpose bit) and B K-major,
// both from shared memory
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_x(float (&d)[96], uint64_t da,
                                        uint64_t db) {
  wgmma_n192(d, da, db);
}
__device__ __forceinline__ void wgmma_x(float (&d)[128], uint64_t da,
                                        uint64_t db) {
  wgmma_n256(d, da, db);
}

// Two int8 weights, the low bytes of the 16-bit halves of `s` (the high
// bytes are ignored), as bf16x2, exactly: with m = w & 0x7F and the sign
// bit sg = w & 0x80, w = (128 + m) - (128 + sg), and both terms are bf16
// with exponent 2^7 (0x4300 | m and 0x4300 | sg).
__device__ __forceinline__ uint32_t widen2(uint32_t s) {
  const uint32_t v = (s & 0x007F007Fu) | 0x43004300u;
  const uint32_t o = (s & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&o));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Shared memory, from a 1024-byte aligned base: STAGES stages of x's tile
// (BX rows of 128 swizzled bytes: 64 of K) and the weights' raw int8 tile
// (64 K rows of 128 swizzled bytes: 128 columns); each warpgroup's two
// widened bf16 tiles (64 K rows of its 64 columns, 128 swizzled bytes);
// then the mbarriers.
template <int BX>
struct WgSmem {
  static_assert(BX == 192 || BX == 256, "the two tiles of wgmma_tile");
  static constexpr int STAGES = BX == 192 ? 5 : 4;  // ~192 KB either way
  static constexpr int X_BYTES = BX * ROW_BYTES;
  static constexpr int W_BYTES = WG_BK * WG_BN;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int A_OFF = STAGES * STAGE;
  static constexpr int A_BYTES = WG_BK * ROW_BYTES;  // one widened tile
  static constexpr int BAR_OFF = A_OFF + 4 * A_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * 2 * STAGES;  // full, empty
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

// The CTA computes out^T's tile: 128 weight columns (two warpgroups of 64,
// the wgmma M side) x BX rows of x (the wgmma N side), K in order.
template <int BX>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap,
             const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
             int M, int N, int K) {
  using L = WgSmem<BX>;
  constexpr int S = L::STAGES;
  constexpr int ACC = BX / 2;  // 64 x BX fp32 over 128 threads
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // base, as a pointer
  const uint32_t bar0 = base + L::BAR_OFF;
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (S + s); };

  // x's row tiles fastest: the CTAs resident together share weight slabs
  const int n_mt = (M + BX - 1) / BX;
  const int m0 = (blockIdx.x % n_mt) * BX;
  const int n0 = (blockIdx.x / n_mt) * WG_BN;
  const int nk = (K + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // Thread 0 is also the producer: it issues every copy.
  auto load = [&](int i) {
    const int st = i % S;
    mbar_expect_tx(full(st), L::STAGE);
    tma_load(&xmap, base + st * L::STAGE, full(st), i * WG_BK, m0);
    tma_load(&wmap, base + st * L::STAGE + L::X_BYTES, full(st), n0,
             i * WG_BK);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(S, nk); ++i) load(i);

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;

  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

  for (int i = 0; i < nk; ++i) {
    const int st = i % S;
    mbar_wait(full(st), (i / S) & 1);
    // widen this warpgroup's 64 columns of the stage into its bf16 tile of
    // this step's parity (last read by the products of step i - 2, which
    // have ended): an item is 16 int8 of one K row, columns 16q..16q+15,
    // two swizzled chunks: the even columns, then the odd.  So A row
    // 16q + g is column 16q + 2g and row 16q + 8 + g column 16q + 2g + 1,
    // and a lane's two output rows are adjacent columns.
    const uint8_t* ws = gbase + st * L::STAGE + L::X_BYTES;
    uint8_t* as = gbase + L::A_OFF + (wg * 2 + (i & 1)) * L::A_BYTES;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int it = tid + 128 * r, k = it / 4, q = it % 4;
      const uint4 w = *reinterpret_cast<const uint4*>(
          ws + k * ROW_BYTES + (((wg * 4 + q) ^ (k & 7)) << 4));
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
      uint32_t h[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = widen2(__byte_perm(u[j], 0u, 0x0200));      // 4j, 4j + 2
        h[4 + j] = widen2(__byte_perm(u[j], 0u, 0x0301));  // 4j+1, 4j+3
      }
      uint8_t* row = as + k * ROW_BYTES;
      *reinterpret_cast<uint4*>(row + (((2 * q) ^ (k & 7)) << 4)) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(row + (((2 * q + 1) ^ (k & 7)) << 4)) =
          make_uint4(h[4], h[5], h[6], h[7]);
    }
    // the tile is read by wgmma, in the async proxy, by the whole
    // warpgroup: fence, then a barrier of this warpgroup alone
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // A: the widened tile, MN-major, 16 K rows a step; B: x's BX rows,
      // K-major, a K step 32 bytes into the swizzled rows
      const uint64_t da =
          make_desc(smem_u32(as) + kk * 16 * ROW_BYTES, WG_BK * ROW_BYTES,
                    1024);
      const uint64_t db =
          make_desc(base + st * L::STAGE + kk * 32, 16, 1024);
      wgmma_x(acc, da, db);
    }
    wgmma_commit();
    // refill the stage of step i - 2, which both warpgroups released a
    // step ago (so this rarely waits), with step i - 2 + S
    if (threadIdx.x == 0 && i >= 2 && i - 2 + S < nk) {
      mbar_wait(empty((i - 2) % S), ((i - 2) / S) & 1);
      load(i - 2 + S);
    }
    // the products of step i - 1 have ended (no register of acc is
    // touched in the loop: a read there would make the compiler wait for
    // every product)
    wgmma_wait<1>();
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((i - 1) % S));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // out^T's fragment: rows g and g + 8 of warp w's 16 are the adjacent
  // weight columns c and c + 1; acc[4j + e] is column c + (e >> 1), x row
  // 8j + 2t + (e & 1).  The scale once, masked stores of the ragged edges.
  const int g = lane / 4, t = lane % 4;
  const int c = n0 + wg * 64 + warp * 16 + 2 * g;
  if (c < N) {  // N is even: c + 1 < N too
    const float s0 = scale[c], s1 = scale[c + 1];
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j) {
      const int row = m0 + j * 8 + 2 * t;
      if (row < M)
        *reinterpret_cast<uint32_t*>(out + (long long)row * N + c) =
            pack_bf16(acc[4 * j] * s0, acc[4 * j + 2] * s1);
      if (row + 1 < M)
        *reinterpret_cast<uint32_t*>(out + (long long)(row + 1) * N + c) =
            pack_bf16(acc[4 * j + 1] * s0, acc[4 * j + 3] * s1);
    }
  }
}

// =========================================================================
// splitk: decode M, bf16 or fp32 x, a deterministic split-K weight stream
// =========================================================================
constexpr int SK_BN = 128;        // output columns per CTA
constexpr int SK_BK = 64;         // K rows per ring stage: 8 KB of int8
constexpr int SK_STAGES = 4;      // ring depth
constexpr int SK_THREADS = 128;   // 4 warps: one 16-row K step of a stage each
constexpr int SK_X_BYTES = 22528; // most shared memory for x's slice
constexpr int SK_XPAD = 32;       // bytes after each x row (spreads banks)
constexpr int SK_RING = SK_STAGES * SK_BK * SK_BN;
// dynamic shared memory at the largest x slice: four CTAs fit on an SM
constexpr int SK_ALLOC = 1024 + SK_RING + SK_X_BYTES + 16 * SK_STAGES;

// MB: 8-row tiles of x (M <= 8 MB).  Grid (column blocks, splits); split s
// takes K rows [s chunk, min(K, (s + 1) chunk)), chunk a multiple of SK_BK,
// and writes its fp32 partial (M x 128) to part[s].
template <typename TX, int MB>
__global__ void __launch_bounds__(SK_THREADS)
splitk_kernel(const __grid_constant__ CUtensorMap wmap,
              const TX* __restrict__ x, float* __restrict__ part, int M,
              int N, int K, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const int xstr = chunk * 2 + SK_XPAD;  // bytes per bf16 x row
  uint8_t* const xs = gbase + SK_RING;
  const uint32_t bar0 = base + SK_RING + MB * 8 * xstr;
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (SK_STAGES + s); };

  const int n0 = blockIdx.x * SK_BN, split = blockIdx.y;
  const int k_lo = split * chunk, k_hi = min(K, k_lo + chunk);
  const int nt = (k_hi - k_lo + SK_BK - 1) / SK_BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  if (tid == 0) {
    for (int s = 0; s < SK_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int i) {
    const int st = i % SK_STAGES;
    mbar_expect_tx(full(st), SK_BK * SK_BN);
    tma_load(&wmap, base + st * SK_BK * SK_BN, full(st), n0,
             k_lo + i * SK_BK);
  };
  if (tid == 0)
    for (int i = 0; i < min(SK_STAGES, nt); ++i) load(i);

  // x's rows for this K slice, rounded to bf16, while the weights land;
  // zero past M and past the slice.  By 16-byte vectors, four loads in
  // flight a thread, where every row segment is whole and aligned.
  constexpr int V = 16 / sizeof(TX);
  if (K % V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    // vectors a row: nv in shared memory, kv in this slice of x
    const int nv = chunk / V, kv = (k_hi - k_lo) / V;
    const int total = MB * 8 * nv;
    for (int i0 = tid; i0 < total; i0 += 4 * SK_THREADS) {
      uint4 r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = i0 + u * SK_THREADS, m = idx / nv, v = idx % nv;
        r[u] = make_uint4(0u, 0u, 0u, 0u);
        if (idx < total && m < M && v < kv)
          r[u] = *reinterpret_cast<const uint4*>(x + (long long)m * K +
                                                  k_lo + v * V);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = i0 + u * SK_THREADS, m = idx / nv, v = idx % nv;
        if (idx >= total) break;
        const TX* e = reinterpret_cast<const TX*>(&r[u]);
        uint32_t h[V / 2];
#pragma unroll
        for (int j = 0; j < V / 2; ++j)
          h[j] = pack_bf16(to_f32(e[2 * j]), to_f32(e[2 * j + 1]));
        uint8_t* dst = xs + m * xstr + v * V * 2;
        if constexpr (V == 8)
          *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
        else
          *reinterpret_cast<uint2*>(dst) = make_uint2(h[0], h[1]);
      }
    }
  } else {
    for (int idx = tid; idx < MB * 8 * (chunk / 2); idx += SK_THREADS) {
      const int m = idx / (chunk / 2), kp = idx % (chunk / 2);
      const int k = k_lo + 2 * kp;
      const TX* xr = x + (long long)m * K;
      const float v0 = (m < M && k < k_hi) ? to_f32(xr[k]) : 0.f;
      const float v1 = (m < M && k + 1 < k_hi) ? to_f32(xr[k + 1]) : 0.f;
      *reinterpret_cast<uint32_t*>(xs + m * xstr + 4 * kp) =
          pack_bf16(v0, v1);
    }
  }
  __syncthreads();

  float acc[8][MB][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][mb][e] = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int st = i % SK_STAGES;
    mbar_wait(full(st), (i / SK_STAGES) & 1);
    // this warp's K step: stage rows warp * 16 + 4t + j (j = 0..3), the
    // 16 columns 16g..16g+15
    const uint8_t* wr = gbase + st * SK_BK * SK_BN +
                        (warp * 16 + 4 * t) * SK_BN + 16 * g;
    uint32_t u[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 w = *reinterpret_cast<const uint4*>(wr + j * SK_BN);
      u[j][0] = w.x;
      u[j][1] = w.y;
      u[j][2] = w.z;
      u[j][3] = w.w;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
    // refill the stage of step i - 1 once every warp has read it: a step
    // late, so thread 0 rarely waits for the other warps
    const int j = i - 1;
    if (tid == 0 && j >= 0 && j + SK_STAGES < nt) {
      mbar_wait(empty(j % SK_STAGES), (j / SK_STAGES) & 1);
      load(j + SK_STAGES);
    }
    // B = x^T: rows mb * 8 + g, K rows 4t..4t+3 of the step, 8 bytes
    uint32_t b[MB][2];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          xs + (mb * 8 + g) * xstr + (i * SK_BK + warp * 16 + 4 * t) * 2);
      b[mb][0] = v.x;
      b[mb][1] = v.y;
    }
    // A = w^T, tile q: row g is column 16g + 2q, row g + 8 column
    // 16g + 2q + 1; logical k 2t, 2t+1 are K rows 4t, 4t+1 and 2t+8, 2t+9
    // are 4t+2, 4t+3 (as B's)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      // byte sb of one word into the low half, of the other into the high
      const int c = q / 2, sb = (q % 2) * 2;
      constexpr int lo = 0x400, hi = 0x501;  // selectors at sb = 0
      uint32_t a[4];
      a[0] = widen2(__byte_perm(u[0][c], u[1][c], lo + sb * 0x101));
      a[1] = widen2(__byte_perm(u[0][c], u[1][c], hi + sb * 0x101));
      a[2] = widen2(__byte_perm(u[2][c], u[3][c], lo + sb * 0x101));
      a[3] = widen2(__byte_perm(u[2][c], u[3][c], hi + sb * 0x101));
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) mma_bf16(acc[q][mb], a, b[mb]);
    }
  }
  __syncthreads();  // every warp is done with the ring: it becomes `red`
  start_next();     // the combine may start; it waits for this grid's end

  // the four warps' sums in warp order, then the partial's rows m < M
  constexpr int RS = SK_BN + 4;
  float* red = reinterpret_cast<float*>(gbase);
  for (int w = 0; w < 4; ++w) {
    if (warp == w) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& r = red[(mb * 8 + 2 * t + (e & 1)) * RS + 16 * g + 2 * q +
                           (e >> 1)];
            r = w == 0 ? acc[q][mb][e] : r + acc[q][mb][e];
          }
    }
    __syncthreads();
  }
  if (n0 + tid < N)
    for (int m = 0; m < M; ++m)
      part[((long long)split * M + m) * N + n0 + tid] = red[m * RS + tid];
}

// out = (the splits' partials summed in split order) x scale, in x's type;
// four consecutive elements a thread (N % 16 == 0)
template <typename TX>
__global__ void __launch_bounds__(256)
splitk_combine(const float* __restrict__ part,
               const float* __restrict__ scale, TX* __restrict__ out,
               long long MN, int N, int splits) {
  wait_for_previous();
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= MN) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 p = *reinterpret_cast<const float4*>(part + sp * MN + i);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  const int n = static_cast<int>(i % N);
  store(out + i, s.x * scale[n]);
  store(out + i + 1, s.y * scale[n + 1]);
  store(out + i + 2, s.z * scale[n + 2]);
  store(out + i + 3, s.w * scale[n + 3]);
}

// ---- host side -------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: reached through the runtime,
// so the library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map over a row-major (rows, cols) matrix of `esize`-byte elements;
// boxes of box_cols x box_rows, zero-filled past the edges.
bool encode2d(CUtensorMap* map, CUtensorMapDataType type, int esize,
              const void* ptr, int rows, int cols, int box_cols,
              int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TX>
int launch_general(const void* x, const void* wq, const void* scale,
                   void* out, int M, int N, int K, cudaStream_t stream) {
  if ((M + BM - 1) / BM > 65535) return -1;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<TX><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<TX*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int BX>
int launch_wgmma(const void* x, const void* wq, const void* scale, void* out,
                 int M, int N, int K, cudaStream_t stream) {
  CUtensorMap xm, wm;
  if (!encode2d(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, WG_BK, BX,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode2d(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, K, N, WG_BN, WG_BK,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgmma_kernel<BX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WgSmem<BX>::ALLOC);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const long long tiles =
      (long long)((M + BX - 1) / BX) * ((N + WG_BN - 1) / WG_BN);
  if (tiles > 0x7fffffff) return -1;
  wgmma_kernel<BX><<<(unsigned)tiles, WG_THREADS, WgSmem<BX>::ALLOC,
                     stream>>>(xm, wm, static_cast<const float*>(scale),
                               static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, int MB>
int launch_splitk(const void* x, const void* wq, const void* scale,
                  void* out, float* work, int M, int N, int K, int splits,
                  int chunk, cudaStream_t stream) {
  const int xbytes = MB * 8 * (chunk * 2 + SK_XPAD);
  if (chunk < SK_BK || chunk % SK_BK || xbytes > SK_X_BYTES ||
      (long long)splits * chunk < K || (long long)(splits - 1) * chunk >= K ||
      splits > 65535)
    return -1;  // not a plan of int8_matmul.split_plan
  CUtensorMap wm;
  if (!encode2d(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, K, N, SK_BN,
                SK_BK, CU_TENSOR_MAP_SWIZZLE_NONE))
    return -2;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        splitk_kernel<TX, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SK_ALLOC);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((N + SK_BN - 1) / SK_BN, splits);
  splitk_kernel<TX, MB>
      <<<grid, SK_THREADS, 1024 + SK_RING + xbytes + 16 * SK_STAGES,
         stream>>>(wm, static_cast<const TX*>(x), work, M, N, K, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the combine with programmatic dependent launch
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  const long long MN = (long long)M * N;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((MN / 4 + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, splitk_combine<TX>,
                         static_cast<const float*>(work),
                         static_cast<const float*>(scale),
                         static_cast<TX*>(out), MN, N, splits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX>
int launch_splitk_m(const void* x, const void* wq, const void* scale,
                    void* out, float* work, int M, int N, int K, int splits,
                    int chunk, cudaStream_t s) {
  if (M <= 8)
    return launch_splitk<TX, 1>(x, wq, scale, out, work, M, N, K, splits,
                                chunk, s);
  if (M <= 16)
    return launch_splitk<TX, 2>(x, wq, scale, out, work, M, N, K, splits,
                                chunk, s);
  if (M <= 32)
    return launch_splitk<TX, 4>(x, wq, scale, out, work, M, N, K, splits,
                                chunk, s);
  return -1;
}

}  // namespace

// x (M, K), w_q (K, N) int8, scale (N,) fp32 and out (M, N) are contiguous;
// x_is_bf16 selects bf16 (1) or fp32 (0) for x and out.  route: 0 general,
// 1 wgmma (bf16 x; K % 8 == 0, N % 16 == 0, x and w_q 16-byte aligned;
// `tile` x rows per CTA, 192 or 256), 2 splitk (M <= 32; N % 16 == 0, w_q
// 16-byte aligned; `work` holds splits x M x N floats).  tile, splits and
// chunk come from int8_matmul.wgmma_tile / split_plan.  Returns the
// cudaError_t of the launches (0 = cudaSuccess); -1 for a shape or plan the
// route does not take (the Python wrapper checks first), -2 when a tensor
// map cannot be encoded.
extern "C" int int8_matmul_launch(const void* x, const void* wq,
                                  const void* scale, void* out, void* work,
                                  int M, int N, int K, int x_is_bf16,
                                  int route, int tile, int splits, int chunk,
                                  void* stream) {
  if (M < 1 || N < 1 || K < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = N % 16 == 0 &&
                       (reinterpret_cast<uintptr_t>(wq) & 15) == 0;
  float* w = static_cast<float*>(work);
  switch (route) {
    case 0:
      return x_is_bf16 ? launch_general<__nv_bfloat16>(x, wq, scale, out, M,
                                                       N, K, s)
                       : launch_general<float>(x, wq, scale, out, M, N, K, s);
    case 1:
      if (!x_is_bf16 || !aligned || K % 8 ||
          (reinterpret_cast<uintptr_t>(x) & 15))
        return -1;
      if (tile == 192)
        return launch_wgmma<192>(x, wq, scale, out, M, N, K, s);
      if (tile == 256)
        return launch_wgmma<256>(x, wq, scale, out, M, N, K, s);
      return -1;
    case 2:
      if (!aligned) return -1;
      return x_is_bf16
                 ? launch_splitk_m<__nv_bfloat16>(x, wq, scale, out, w, M, N,
                                                  K, splits, chunk, s)
                 : launch_splitk_m<float>(x, wq, scale, out, w, M, N, K,
                                          splits, chunk, s);
  }
  return -1;
}
