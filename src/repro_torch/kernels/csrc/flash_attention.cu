// Flash attention forward for Hopper (sm_90a): causal / sliding window /
// full, GQA, tanh softcap, bf16 in and out, fp32 softmax statistics.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel `_kernel`).  Same function, not the same blocking: the
// TPU kernel carries m/l/acc in VMEM scratch across a sequential kv grid
// axis; here one CTA owns a 128-row query tile of one (batch, head) and
// walks the 128-key tiles itself, keeping m/l/acc in registers.
//
// What bounds it on this card: tensor-core throughput.  Causal prefill at
// S=1536, H=16, D=128 does 9.7 GFLOP of bf16 products against ~13 MB of
// q/k/v/o traffic, far above the H100's ~295 FLOP/byte ridge.  The design:
//   * both products on wgmma, the only way to the Hopper tensor-core rate:
//     S = Q K^T with Q and K from shared memory (K-major, no transpose), and
//     O += P V with P from registers (the S accumulator's layout is the A
//     fragment's, so P never touches shared memory) and V from shared
//     memory through the descriptor's transpose bit (MN-major B), so V is
//     never transposed by hand;
//   * two warpgroups of 64 query rows each; thread 0 is also the producer:
//     it keeps K and V tiles in flight through TMA into a ring of STAGES
//     buffers, signalled by mbarriers (full: bytes arrived; empty: the 8
//     warps are done with the stage), refilling a stage one iteration after
//     it was released, so copies overlap the products.  Inside a
//     warpgroup, tile i's S = Q K^T and tile i-1's P V are in flight
//     together, and tile i's softmax runs while P V finishes.  The tensor
//     maps are 4-D over q/k/v's (B, S, heads, D) strides, read in place,
//     128-byte swizzled (a D=128 row is two 64-column boxes); keys and rows
//     past the end are zero-filled by the hardware;
//   * causal and window: query tiles are issued heaviest first (the grid is
//     one axis, tile-major, last tile first), key tiles outside the band are
//     never loaded, and only tiles that cross the band's edge or the end of
//     the keys pay for the mask;
//   * deterministic: each (batch, head, query tile) is one CTA, with no
//     split of a row's keys across CTAs and no atomics.
// P is rounded to bf16 before P V, as the reference rounds it to v.dtype;
// l sums the unrounded p.  The softmax runs in the log2 domain (ex2).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;       // query rows per CTA: two warpgroups of 64
constexpr int BK = 128;       // keys per K/V tile
constexpr int STAGES = 3;     // K/V ring depth
// two warpgroups; a CTA of more warps (a producer warp beside them) is
// allocated registers for 12 warps, which caps a thread at 168 registers,
// too few for S, O and P in flight together (spills)
constexpr int THREADS = 256;
constexpr int ROW_BYTES = 128;  // one swizzled row: 64 bf16
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// --- mbarriers ---------------------------------------------------------
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

// --- TMA: one box of a 4-D tensor map into shared memory ----------------
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma ---------------------------------------------------------------
// Shared-memory matrix descriptor for a 128-byte-swizzled operand whose
// 8-row swizzle atoms (1024 bytes) are 1024-byte aligned.  lbo / sbo in
// bytes: K-major, sbo = the stride between 8-row groups (lbo unused);
// MN-major, lbo = the stride between 64-element column blocks, sbo = the
// stride between 8-row groups of the reduction dim.
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

// D (64 x 128, fp32) (+)= A B, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A B, A from registers, B from shared memory
// (MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A B, A from registers, B from shared memory
// (MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// The products' widths follow the accumulators' sizes: S is 64 x BK (64
// regs), O is 64 x D (32 regs at D = 64, 64 at D = 128).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma_ss_n128(d, da, db, scale_d);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

// Shared memory, from a 1024-byte aligned base: Q (HALVES boxes of BQ rows),
// then STAGES K tiles, STAGES V tiles (HALVES boxes of BK rows each), then
// the mbarriers.  A box is rows of 64 bf16, 128-byte swizzled by TMA.
template <int D>
struct Smem {
  static constexpr int HALVES = D / 64;
  static constexpr int Q_BYTES = HALVES * BQ * ROW_BYTES;
  static constexpr int KV_BYTES = HALVES * BK * ROW_BYTES;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // qfull, kfull[STAGES], vfull[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          __nv_bfloat16* __restrict__ o, int B, int Sq, int Skv, int H, int G,
          int causal, int window, float softcap, float scale) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + L::Q_OFF;
  const uint32_t bar0 = base + L::BAR_OFF;
  auto qfull = [&]() { return bar0; };
  auto kfull = [&](int s) { return bar0 + 8u * (1 + s); };
  auto vfull = [&](int s) { return bar0 + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar0 + 8u * (1 + 2 * STAGES + s); };
  auto k_s = [&](int s) { return base + L::K_OFF + s * L::KV_BYTES; };
  auto v_s = [&](int s) { return base + L::V_OFF + s * L::KV_BYTES; };

  // heaviest query tiles first: tile-major, the last tile first
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % (B * H);
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / (B * H));
  const int h = bh % H, b = bh / H, kvh = h / G;
  const int q0 = qt * BQ;

  // key tiles that can interact with this query tile (the band test)
  int kt_end = (Skv + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (min(q0 + BQ, Sq) - 1) / BK + 1);
  const int kt_begin = window ? max(0, q0 - window + 1) / BK : 0;
  const int n_kt = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(qfull(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(vfull(s), 1);
      mbar_init(empty(s), 8);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread 0 is also the producer: it issues every copy.
  auto load_kv = [&](int i) {
    const int st = i % STAGES, k0 = (kt_begin + i) * BK;
    mbar_expect_tx(kfull(st), L::KV_BYTES);
    for (int hf = 0; hf < L::HALVES; ++hf)
      tma_load(&kmap, k_s(st) + hf * BK * ROW_BYTES, kfull(st), hf * 64, k0,
               kvh, b);
    mbar_expect_tx(vfull(st), L::KV_BYTES);
    for (int hf = 0; hf < L::HALVES; ++hf)
      tma_load(&vmap, v_s(st) + hf * BK * ROW_BYTES, vfull(st), hf * 64, k0,
               kvh, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qfull(), L::Q_BYTES);
    for (int hf = 0; hf < L::HALVES; ++hf)
      tma_load(&qmap, q_s + hf * BQ * ROW_BYTES, qfull(), hf * 64, q0, h, b);
    for (int i = 0; i < min(STAGES, n_kt); ++i) load_kv(i);
  }
  {
    // ---- each warpgroup: 64 query rows -----------------------------------
    const int wg = threadIdx.x / 128;
    constexpr int SN = BK / 2;  // S accumulator: BK/8 tiles x 4
    constexpr int ON = D / 2;   // O accumulator: D/8 tiles x 4
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wq0 = q0 + wg * 64;                // this warpgroup's first row
    const int r0 = wq0 + warp * 16 + g, r1 = r0 + 8;
    const uint32_t qw = q_s + wg * 64 * ROW_BYTES;
    // Scores stay as the product gives them (or softcapped, which scales
    // them first); the max is taken there, and the scale into the log2
    // domain is folded into ex2's argument: p = 2^(x sl - m sl).
    const float sl = (softcap > 0.f ? 1.f : scale) * LOG2E;

    float acc[ON];
#pragma unroll
    for (int i = 0; i < ON; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float s[SN] = {};
    uint32_t pa[BK / 16][4];  // P of the tile whose P V is next

    // S = Q K^T of tile i into s, committed as one wgmma group: D/16
    // k-steps, a k-step 32 bytes into the swizzled rows
    auto issue_qk = [&](int i) {
      const int st = i % STAGES;
      mbar_wait(kfull(st), (i / STAGES) & 1);
      fence_regs(s);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da =
            make_desc(qw + (kk / 4) * BQ * ROW_BYTES + off, 16, 1024);
        const uint64_t db =
            make_desc(k_s(st) + (kk / 4) * BK * ROW_BYTES + off, 16, 1024);
        wgmma_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of tile i, P from registers, V MN-major (D contiguous); a
    // key step is 16 rows
    auto issue_pv = [&](int i) {
      const int st = i % STAGES;
      mbar_wait(vfull(st), (i / STAGES) & 1);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = make_desc(v_s(st) + kk * 16 * ROW_BYTES,
                                      BK * ROW_BYTES, 1024);
        wgmma_rs(acc, pa[kk], db);
      }
      wgmma_commit();
    };
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(i % STAGES));
    };
    // Tile i's scores (in s) to probabilities: the softcap, the mask where
    // the tile crosses the band's edge or the end of the keys, then the
    // online softmax per row half (i2 = 0: row r0, 1: row r1).  Returns
    // the factors O must be rescaled by, which the caller applies once the
    // P V in flight has finished.
    auto softmax = [&](int i, float (&corr)[2]) {
      const int k0 = (kt_begin + i) * BK;
      const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > wq0) ||
                        (window && k0 <= wq0 + 63 - window);
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        float x = s[j];
        if (softcap > 0.f) x = tanhf(x * scale / softcap) * softcap;
        if (edge) {
          const int row = (j & 2) ? r1 : r0;
          const int col = k0 + (j / 4) * 8 + 2 * t + (j & 1);
          bool ok = col < Skv;
          if (causal) ok = ok && col <= row;
          if (window) ok = ok && col > row - window;
          x = ok ? x : NEG_INF;
        }
        s[j] = x;
      }
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        float mx = m[i2];
#pragma unroll
        for (int j = 0; j < SN / 4; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i2], s[4 * j + 2 * i2 + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[i2] = ex2((m[i2] - mx) * sl);
        m[i2] = mx;
        // a row masked so far keeps p = 0: with mx = NEG_INF the FFMA's
        // exact product against a rounded mx * sl would leave a residual
        // of ~1e22, and ex2 of that is inf
        const float mxl = mx == NEG_INF ? 0.f : mx * sl;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < SN / 4; ++j) {
          const float p0 = ex2(fmaf(s[4 * j + 2 * i2], sl, -mxl));
          const float p1 = ex2(fmaf(s[4 * j + 2 * i2 + 1], sl, -mxl));
          s[4 * j + 2 * i2] = p0;
          s[4 * j + 2 * i2 + 1] = p1;
          sum += p0 + p1;
        }
        l[i2] = l[i2] * corr[i2] + sum;  // this lane's share
      }
    };
    // O *= corr, then P (bf16) as wgmma A fragments: key step kk is S
    // tiles 2kk and 2kk+1
    auto rescale_and_pack = [&](const float (&corr)[2]) {
#pragma unroll
      for (int d = 0; d < ON / 4; ++d) {
        acc[4 * d] *= corr[0];
        acc[4 * d + 1] *= corr[0];
        acc[4 * d + 2] *= corr[1];
        acc[4 * d + 3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // Software pipeline: tile i's S = Q K^T and tile i-1's P V are in
    // flight together; tile i's softmax runs while P V finishes.
    float corr[2];
    mbar_wait(qfull(), 0);
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0, corr);
    rescale_and_pack(corr);
    for (int i = 1; i < n_kt; ++i) {
      // refill the stage of tile i - 2, which both warpgroups released an
      // iteration ago, with tile i - 2 + STAGES
      if (threadIdx.x == 0 && i >= 2 && i - 2 + STAGES < n_kt) {
        mbar_wait(empty((i - 2) % STAGES), ((i - 2) / STAGES) & 1);
        load_kv(i - 2 + STAGES);
      }
      issue_qk(i);
      issue_pv(i - 1);
      wgmma_wait<1>();  // S of tile i has landed
      fence_regs(s);
      softmax(i, corr);
      wgmma_wait<0>();  // P V of tile i - 1 too
      fence_regs(acc);
      release(i - 1);
      rescale_and_pack(corr);
    }
    fence_regs(acc);
    wgmma_fence();
    issue_pv(n_kt - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    release(n_kt - 1);

#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 1);
      l[i2] += __shfl_xor_sync(0xffffffffu, l[i2], 2);
      l[i2] = 1.f / fmaxf(l[i2], 1e-30f);
    }
    // o is a fresh contiguous (B, Sq, H, D) tensor
#pragma unroll
    for (int d = 0; d < ON / 4; ++d) {
      const int col = d * 8 + 2 * t;
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(
            o + ((long long)(b * Sq + r0) * H + h) * D + col) =
            pack_bf16(acc[4 * d] * l[0], acc[4 * d + 1] * l[0]);
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(
            o + ((long long)(b * Sq + r1) * H + h) * D + col) =
            pack_bf16(acc[4 * d + 2] * l[1], acc[4 * d + 3] * l[1]);
    }
  }
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

// A 4-D map over (D, S, heads, B) from the tensor's element strides
// st = (batch, seq, head); boxes of 64 columns x `rows` rows of one head.
bool encode(CUtensorMap* map, const void* ptr, int D, int S, int heads,
            int B, const long long* st, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const long long given[3] = {st[1], st[2], st[0]};
  const long long packed[3] = {(long long)heads * D, D,
                               (long long)S * heads * D};
  const int sizes[3] = {S, heads, B};
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                        (cuuint64_t)B};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)  // a size-1 dim's stride is never stepped
    strides[i] = 2ull * (sizes[i] > 1 ? given[i] : packed[i]);
  cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, const long long* st, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!encode(&qm, q, D, Sq, H, B, st, BQ) ||
      !encode(&km, k, D, Skv, KV, B, st + 3, BK) ||
      !encode(&vm, v, D, Skv, KV, B, st + 6, BK))
    return -2;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D>::ALLOC);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int n_qt = (Sq + BQ - 1) / BQ;
  flash_fwd<D><<<n_qt * B * H, THREADS, Smem<D>::ALLOC, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), B, Sq, Skv, H, H / KV,
      causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 9 element strides (batch, seq, head) of q, k, v in that order.
// Returns the cudaError_t of the launch (0 = cudaSuccess); -1 for a head
// dim this file was not built for, -2 when a tensor map cannot be encoded
// (no driver entry point, or strides TMA does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int D,
                                      const long long* strides, int causal,
                                      int window, float softcap, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, o, B, Sq, Skv, H, KV, strides, causal,
                       window, softcap, scale, s);
  if (D == 64)
    return launch<64>(q, k, v, o, B, Sq, Skv, H, KV, strides, causal, window,
                      softcap, scale, s);
  return -1;
}
