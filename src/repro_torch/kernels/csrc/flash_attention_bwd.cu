// Flash attention backward for Hopper (sm_90a): dQ, dK, dV of the forward
// in flash_attention.cu (causal / sliding window / full, GQA, tanh
// softcap), bf16 in and out, fp32 accumulators.
//
// The Pallas package has no backward kernel (its train step differentiates
// the blockwise jnp attention); this is the port's own, behind the
// `FlashAttention` autograd function of kernels/flash_attention.py.  It
// recomputes the probabilities from the forward's row log-sum-exp (LSE, in
// the scaled and softcapped score domain the forward uses):
//   x    = s * scale, or c * tanh(s * scale / c) under a softcap c
//   p    = exp(x - lse), 0 where the forward masks
//   dV   = P^T dO            dP = dO V^T
//   dX   = P o (dP - delta), delta = rowsum(dO o O)
//   dS   = dX * scale, times (1 - tanh^2) under a softcap
//   dQ   = dS K              dK = dS^T Q
// Three kernels:
//   * bwd_delta: delta, one warp a (batch, row, head), fp32;
//   * bwd_dkdv: one CTA a (batch, kv head, 64-key tile); it walks the G
//     query heads of its group and, per head, the 64-row query tiles that
//     meet its keys (the forward's band), in a fixed order; each warp owns
//     16 keys and keeps its dK and dV rows in registers;
//   * bwd_dq: one CTA a (batch, head, 64-row query tile); it walks the key
//     tiles of the forward's band; each warp owns 16 query rows.
// Every sum runs in a fixed order and nothing is added atomically, so a
// second call gives the same bits (the determinism a restart from a
// checkpoint rests on).  Products are mma.sync m16n8k16 (bf16 in, fp32
// accumulate); P and dS are rounded to bf16 as their products' A operand.
// Tiles come in by cp.async (16-byte chunks, rows past the end zero-filled)
// into rows padded by 16 bytes, which ldmatrix reads without bank conflicts.
// The accumulators cover a chunk of DC head-dim columns at a time (Tile<D>);
// a wider head dim walks its chunks in turn and recomputes S and dP for
// each (D 256 in four dK/dV chunks of 64 and two dQ chunks of 128; D 160
// in two dK/dV chunks of 80): registers for S, dP and both accumulators of
// a whole 256-column row would pass 255.  Shared memory: four 64-row tiles,
// 67.6 KB at D 128, 135.2 KB at D 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows a tile
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 128;  // four warps of 16 rows
constexpr float LOG2E = 1.4426950408889634f;
// the LSE of a row past the end: p = 2^(x sl - BIG) is 0
constexpr float BIG = 1e30f;

typedef __nv_bfloat16 bf16;

template <int D>
struct Tile {
  static constexpr int LD = D + 8;                 // smem row, bf16
  static constexpr int DC_KV = D == 160 ? 80 : 64;  // dK/dV chunk
  static constexpr int DC_Q = D == 256 ? 128 : D;   // dQ chunk
  static constexpr int ELEMS = 64 * LD;             // one tile
  static constexpr int BYTES = 4 * ELEMS * 2 + 2 * 64 * 4;
  static_assert(D % 16 == 0 && DC_KV % 16 == 0 && DC_Q % 16 == 0, "");
};

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

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// C (16 x 8, fp32) += A (16 x 16, row) B (16 x 8, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix row addresses of one lane (tiles row-major, LD elements a row):
// the A fragment of rows r..r+15, columns c..c+15
template <int LD>
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int r, int c) {
  const int lane = threadIdx.x % 32;
  return base +
         2u * ((r + (lane % 8) + ((lane / 8) & 1) * 8) * LD + c + (lane / 16) * 8);
}
// B fragments of two 8-column tiles n..n+15 for the k-step k..k+15, from a
// tile stored [n][k] (B^T row-major): regs 0, 1 the first tile, 2, 3 the
// second
template <int LD>
__device__ __forceinline__ uint32_t bn_addr(uint32_t base, int n, int k) {
  const int lane = threadIdx.x % 32;
  return base +
         2u * ((n + (lane % 8) + (lane / 16) * 8) * LD + k + ((lane / 8) & 1) * 8);
}
// the same from a tile stored [k][n] (read with .trans)
template <int LD>
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int k, int n) {
  const int lane = threadIdx.x % 32;
  return base +
         2u * ((k + (lane % 8) + ((lane / 8) & 1) * 8) * LD + n + (lane / 16) * 8);
}

// rows r0..r0+63 of one head of a contiguous (B, S, heads, D) tensor into a
// padded tile; rows past S are zero-filled (cp.async with 0 source bytes)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int r0, int S, int heads,
                                          int head) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < 64 * CH; i += THREADS) {
    const int r = i / CH, c = i % CH, row = r0 + r;
    const bf16* g =
        src + ((static_cast<long long>(b) * S + min(row, S - 1)) * heads + head) *
                  D + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_u32(dst + r * Tile<D>::LD + c * 8)),
                 "l"(g), "r"(row < S ? 16 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void load_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// x (the forward's score), p, and dS for one element of a score tile
struct Elem {
  float softcap, scale, sl;
  int causal, window, Sq, Skv;
  __device__ __forceinline__ void apply(float& s, float& dp, int row, int col,
                                        float lse, float delta) const {
    float x = s, t = 0.f;
    if (softcap > 0.f) {
      t = tanhf(x * scale / softcap);
      x = t * softcap;
    }
    bool ok = row < Sq && col < Skv;
    if (causal) ok = ok && col <= row;
    if (window) ok = ok && col > row - window;
    const float p = ok ? ex2(fmaf(x, sl, -lse * LOG2E)) : 0.f;
    float ds = p * (dp - delta) * scale;
    if (softcap > 0.f) ds *= 1.f - t * t;
    s = p;
    dp = ds;
  }
};

__global__ void bwd_delta(const bf16* __restrict__ o,
                          const bf16* __restrict__ dout,
                          float* __restrict__ delta, int rows, int Sq, int H,
                          int D) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= rows) return;
  // w = (b * Sq + i) * H + h
  const __nv_bfloat162* a =
      reinterpret_cast<const __nv_bfloat162*>(o + static_cast<long long>(w) * D);
  const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(
      dout + static_cast<long long>(w) * D);
  float acc = 0.f;
  for (int j = lane; j < D / 2; j += 32) {
    const float2 x = __bfloat1622float2(a[j]), y = __bfloat1622float2(g[j]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int m = 16; m >= 1; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    const int h = w % H, bi = w / H, i = bi % Sq, b = bi / Sq;
    delta[(static_cast<long long>(b) * H + h) * Sq + i] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, const bf16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int Sq, int Skv,
         int H, int G, int causal, int window, float softcap, float scale) {
  using T = Tile<D>;
  constexpr int LD = T::LD, DC = T::DC_KV;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + T::ELEMS;
  bf16* q_s = v_s + T::ELEMS;
  bf16* o_s = q_s + T::ELEMS;  // dO
  float* lse_s = reinterpret_cast<float*>(o_s + T::ELEMS);
  float* dl_s = lse_s + 64;
  const uint32_t ku = smem_u32(k_s), vu = smem_u32(v_s), qu = smem_u32(q_s),
                 ou = smem_u32(o_s);

  const int KV = H / G;
  const int n_kt = (Skv + BK - 1) / BK, n_qt = (Sq + BQ - 1) / BQ;
  const int kt = blockIdx.x % n_kt, bk = blockIdx.x / n_kt;
  const int kvh = bk % KV, b = bk / KV, k0 = kt * BK;
  // query tiles that meet these keys: causal rows from k0 on, a window's
  // rows before the last key + window
  const int qt_begin = causal ? min(k0 / BQ, n_qt) : 0;
  int qt_end = n_qt;
  if (window) qt_end = min(n_qt, (k0 + BK - 1 + window - 1) / BQ + 1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, kw = warp * 16;
  const Elem el{softcap, scale, (softcap > 0.f ? 1.f : scale) * LOG2E,
                causal, window, Sq, Skv};

  load_tile<D>(k_s, k, b, k0, Skv, KV, kvh);
  load_tile<D>(v_s, v, b, k0, Skv, KV, kvh);
  load_wait();
  for (int dc = 0; dc < D; dc += DC) {
    float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
    for (int gi = 0; gi < G; ++gi) {
      const int h = kvh * G + gi;
      for (int qt = qt_begin; qt < qt_end; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();  // the last tile's readers are done
        load_tile<D>(q_s, q, b, q0, Sq, H, h);
        load_tile<D>(o_s, dout, b, q0, Sq, H, h);
        for (int i = threadIdx.x; i < 64; i += THREADS) {
          const int r = q0 + i;
          const long long at = (static_cast<long long>(b) * H + h) * Sq + r;
          lse_s[i] = r < Sq ? lse[at] : BIG;
          dl_s[i] = r < Sq ? delta[at] : 0.f;
        }
        load_wait();

        // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 rows
        float s[8][4], dp[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ak[4], av[4];
          ldsm(ak, a_addr<LD>(ku, kw, kk * 16));
          ldsm(av, a_addr<LD>(vu, kw, kk * 16));
#pragma unroll
          for (int n = 0; n < 8; n += 2) {
            uint32_t bq[4], bo[4];
            ldsm(bq, bn_addr<LD>(qu, n * 8, kk * 16));
            mma(s[n], ak, bq[0], bq[1]);
            mma(s[n + 1], ak, bq[2], bq[3]);
            ldsm(bo, bn_addr<LD>(ou, n * 8, kk * 16));
            mma(dp[n], av, bo[0], bo[1]);
            mma(dp[n + 1], av, bo[2], bo[3]);
          }
        }
        // P^T and dS^T; element e of tile n: key row g (+8 for e >= 2),
        // query column n * 8 + 2t (+1 for odd e)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = n * 8 + 2 * t + (e & 1);
            el.apply(s[n][e], dp[n][e], q0 + qi, k0 + kw + g + (e & 2) * 4,
                     lse_s[qi], dl_s[qi]);
          }
        // dV += P^T dO, dK += dS^T Q over this chunk's columns; the score
        // accumulators are the A fragments of the query k-steps
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
          const uint32_t da[4] = {
              pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
          for (int n = 0; n < DC / 8; n += 2) {
            uint32_t bo[4], bq[4];
            ldsm_t(bo, bt_addr<LD>(ou, kk * 16, dc + n * 8));
            mma(dva[n], pa, bo[0], bo[1]);
            mma(dva[n + 1], pa, bo[2], bo[3]);
            ldsm_t(bq, bt_addr<LD>(qu, kk * 16, dc + n * 8));
            mma(dka[n], da, bq[0], bq[1]);
            mma(dka[n + 1], da, bq[2], bq[3]);
          }
        }
      }
    }
    // rows k0 + kw + g and + 8, columns dc + n * 8 + 2t
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + kw + g + half * 8;
      if (key >= Skv) continue;
      const long long row = ((static_cast<long long>(b) * Skv + key) * KV + kvh) * D;
#pragma unroll
      for (int n = 0; n < DC / 8; ++n) {
        const int col = dc + n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dk + row + col) =
            pack_bf16(dka[n][2 * half], dka[n][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(dv + row + col) =
            pack_bf16(dva[n][2 * half], dva[n][2 * half + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, const bf16* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       bf16* __restrict__ dq, int B, int Sq, int Skv, int H, int G, int causal,
       int window, float softcap, float scale) {
  using T = Tile<D>;
  constexpr int LD = T::LD, DC = T::DC_Q;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* o_s = q_s + T::ELEMS;  // dO
  bf16* k_s = o_s + T::ELEMS;
  bf16* v_s = k_s + T::ELEMS;
  const uint32_t qu = smem_u32(q_s), ou = smem_u32(o_s), ku = smem_u32(k_s),
                 vu = smem_u32(v_s);

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int h = bh % H, b = bh / H, kvh = h / G, KV = H / G, q0 = qt * BQ;
  // the forward's band
  int kt_end = (Skv + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (min(q0 + BQ, Sq) - 1) / BK + 1);
  const int kt_begin = window ? max(0, q0 - window + 1) / BK : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, qw = warp * 16;
  const int r0 = q0 + qw + g, r1 = r0 + 8;
  const Elem el{softcap, scale, (softcap > 0.f ? 1.f : scale) * LOG2E,
                causal, window, Sq, Skv};
  const long long at = (static_cast<long long>(b) * H + h) * Sq;
  const float lse0 = r0 < Sq ? lse[at + r0] : BIG,
              lse1 = r1 < Sq ? lse[at + r1] : BIG;
  const float dl0 = r0 < Sq ? delta[at + r0] : 0.f,
              dl1 = r1 < Sq ? delta[at + r1] : 0.f;

  load_tile<D>(q_s, q, b, q0, Sq, H, h);
  load_tile<D>(o_s, dout, b, q0, Sq, H, h);
  load_wait();
  for (int dc = 0; dc < D; dc += DC) {
    float dqa[DC / 8][4];
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int k0 = kt * BK;
      __syncthreads();  // the last tile's readers are done
      load_tile<D>(k_s, k, b, k0, Skv, KV, kvh);
      load_tile<D>(v_s, v, b, k0, Skv, KV, kvh);
      load_wait();

      // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t aq[4], ao[4];
        ldsm(aq, a_addr<LD>(qu, qw, kk * 16));
        ldsm(ao, a_addr<LD>(ou, qw, kk * 16));
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          uint32_t bk_[4], bv[4];
          ldsm(bk_, bn_addr<LD>(ku, n * 8, kk * 16));
          mma(s[n], aq, bk_[0], bk_[1]);
          mma(s[n + 1], aq, bk_[2], bk_[3]);
          ldsm(bv, bn_addr<LD>(vu, n * 8, kk * 16));
          mma(dp[n], ao, bv[0], bv[1]);
          mma(dp[n + 1], ao, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          el.apply(s[n][e], dp[n][e], lo ? r0 : r1, k0 + n * 8 + 2 * t + (e & 1),
                   lo ? lse0 : lse1, lo ? dl0 : dl1);
        }
      // dQ += dS K over this chunk's columns
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t da[4] = {
            pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
            pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < DC / 8; n += 2) {
          uint32_t bk_[4];
          ldsm_t(bk_, bt_addr<LD>(ku, kk * 16, dc + n * 8));
          mma(dqa[n], da, bk_[0], bk_[1]);
          mma(dqa[n + 1], da, bk_[2], bk_[3]);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? r1 : r0;
      if (row >= Sq) continue;
      bf16* out = dq + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
      for (int n = 0; n < DC / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + dc + n * 8 + 2 * t) =
            pack_bf16(dqa[n][2 * half], dqa[n][2 * half + 1]);
    }
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* delta, bf16* dq,
           bf16* dk, bf16* dv, int B, int Sq, int Skv, int H, int KV,
           int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<D>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bwd_dq<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<D>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int G = H / KV, rows = B * Sq * H;
  bwd_delta<<<(rows + 7) / 8, 256, 0, stream>>>(o, dout, delta, rows, Sq, H,
                                                D);
  const int n_kt = (Skv + BK - 1) / BK, n_qt = (Sq + BQ - 1) / BQ;
  bwd_dkdv<D><<<n_kt * B * KV, THREADS, Tile<D>::BYTES, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H, G, causal, window,
      softcap, scale);
  bwd_dq<D><<<n_qt * B * H, THREADS, Tile<D>::BYTES, stream>>>(
      q, k, v, dout, lse, delta, dq, B, Sq, Skv, H, G, causal, window, softcap,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every tensor contiguous: q, o, dout, dq (B, Sq, H, D); k, v, dk, dv
// (B, Skv, KV, D), bf16; lse and the workspace delta (B, H, Sq) fp32.
// Returns the cudaError_t of the launches (0 = cudaSuccess); -1 for a head
// dim this file was not built for.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int KV, int D, int causal,
    int window, float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS                                                                 \
  static_cast<const bf16*>(q), static_cast<const bf16*>(k),                  \
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),              \
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),        \
      static_cast<float*>(delta), static_cast<bf16*>(dq),                    \
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Skv, H, KV,     \
      causal, window, softcap, scale, s
  if (D == 64) return launch<64>(ARGS);
  if (D == 128) return launch<128>(ARGS);
  if (D == 160) return launch<160>(ARGS);
  if (D == 256) return launch<256>(ARGS);
#undef ARGS
  return -1;
}
