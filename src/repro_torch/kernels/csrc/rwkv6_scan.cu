// Chunked RWKV6 linear attention for Hopper (sm_90a): a (D, D) fp32 matrix
// state carried across chunks, data-dependent per-channel decay, fp32 in
// and out.
//
// Replaces: src/repro/kernels/rwkv6_scan.py::rwkv6_scan (the Pallas TPU
// kernel `_kernel`).  Same function, the same chunk boundaries and the same
// formulas, per chunk of C rows (C <= 64):
//   cum    = cumsum_t log w                  (per column, in row order)
//   A_excl = exp(cum - log w),  A_incl = exp(cum),  A_end = A_incl[C-1]
//   rA     = r * A_excl,        kA = k / max(A_incl, 1e-24)
//   y      = rA S + tril_{-1}(rA kA^T) v + (r . (u * k)) v
//   S'     = A_end * S + (kA * A_end)^T v
// The TPU grid walks (batch, head, chunk) with the chunk axis sequential
// and the state in VMEM scratch.  Here a CTA walks its chunks itself, in
// order, with its part of the state in shared memory (nothing may carry
// between CTAs, which run in no order).  r, k, v and w are read in place
// in their (B, T, H, D) layout through strides.
//
// What bounds it on this card: at B = 1, T = 1536, H = 64, D = 64 a call
// moves ~128 MB (r, k, v, w, y once: ~38 us at 3.35 TB/s) and does ~2.4
// GFLOP of products (~36 us on the fp32 CUDA cores).  The chunks of a head
// are sequential, so the design is about keeping every SM busy through
// that sequence:
//
// 1. Split over value columns.  Column j of y and of the state depends only
//    on column j of v and S, so one CTA owns one (batch, head, block of DV
//    value columns); grid (D / DV, H, B).  The D / DV CTAs of a head each
//    recompute that head's decays and scores.  DV comes from the Python
//    rule `rwkv6_scan.split(B, H, D)`, one DV per head dim: 32 at D = 64,
//    which at the timed shape is 128 CTAs of 16 warps, one an SM (the
//    two-stage fp32 ring alone is 125 KB at D = 64); 16 below it.  Sharing the decays
//    and scores between the two CTAs of a head through a cluster's
//    distributed shared memory was not done: it costs two cluster
//    barriers a chunk and a second path for D / DV = 1 (PERF.md names it
//    as the next step).
// 2. Chunks prefetched asynchronously.  r, k, w (C x D) and the CTA's v
//    block (C x DV) of chunk c + 1 come in by TMA, four boxes of a 4-D
//    tensor map over (D, H, T, B) issued by one thread into the other
//    stage of a two-stage ring while chunk c computes.  A box is D + 4 (or
//    DV + 8) columns wide: the columns past the head are zero-filled and
//    land as the tile's row padding, so the rows need no copy.  Inputs
//    whose pointers or strides are not 16-byte aligned load by 4-byte
//    cp.async instead (a second instance, `TMA` false).  Pad rows (C up
//    to a multiple of 16) are zeroed once and never loaded.
// 3. The decay cumsum over the whole CTA.  Thread (row block rb, column d)
//    loads its rows of r, k and log w into registers and sums log w; the
//    row blocks' totals combine in order through shared memory; each
//    thread then scales its own rows (every row of a block at once, with
//    no branch per row).  A_end is the same sum every thread of a column
//    forms, so it equals A_incl of the last row bit for bit.  The bonus
//    r . (u * k) is summed from the same registers by a halving butterfly
//    over the lanes, in a fixed order.
// 4. Products on tensor cores: mma.sync m16n8k8 TF32, each fp32 operand
//    split as hi + lo (hi = tf32(x), lo = tf32(x - hi), rounded to
//    nearest) and accumulated in fp32 as lo*hi + hi*lo into one sum and
//    hi*hi into another (3xTF32), which keeps a product within ~2^-21 of
//    fp32's.  The A operands (rA, the scores, v) are split once a chunk
//    into hi and lo tiles; the B operands at their loads.  Tasks are 16 x
//    16 tiles, one warp each: the strictly lower score tiles (those on or
//    below the diagonal, the diagonal masked); the state update as
//    S'^T = v^T (kA * A_end), so its A operand is v read row-major; and
//    y.  Operand tiles have row strides of 4 (mod 32) floats (r, k,
//    scores) or 8 / 24 (v, state), so the fragment loads hit 32 banks.
//
// Per chunk: wait for its copies, barrier, issue chunk c + 1; (i) r, k,
// log w into registers, the row-block sums, lo(v), the bonus; barrier;
// (ii) prefixes, A_excl / A_incl, hi / lo of rA and kA in place; barrier;
// (A) the score tiles, and state tiles on the warps they leave idle;
// barrier; (B) y to global, the other state tiles into the other state
// buffer.  Deterministic: fixed orders, no atomics.  expf / logf and IEEE
// division: built without --use_fast_math.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 64;
constexpr int PA = MAX_C + 4;  // row stride of the (C, C) score tile

// threads of one CTA: 16 warps at D = 64 (one CTA an SM), 8 below it
__host__ __device__ constexpr int threads_for(int D) {
  return D == 64 ? 512 : 256;
}

struct Strides {  // element strides (batch, time, head) of r, k, v, w
  long long rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh;
};

// shared-memory layout, in floats; every buffer a multiple of 4 floats
template <int D, int DV>
struct Smem {
  static constexpr int PD = D + 4;     // r, k, w rows
  static constexpr int PV = DV + 8;    // v and state rows
  static constexpr int TILE = MAX_C * PD;
  static constexpr int STAGE = 3 * TILE + MAX_C * PV;  // r, k, w, v
  static constexpr int ATT = 2 * STAGE;                // scores, hi
  static constexpr int ATTLO = ATT + MAX_C * PA;       // scores, lo
  static constexpr int VLO = ATTLO + MAX_C * PA;       // v - hi(v)
  static constexpr int S = VLO + MAX_C * PV;           // two [D][PV]
  static constexpr int TOT = S + 2 * D * PV;           // [threads]
  static constexpr int BONUS = TOT + threads_for(D);   // [2][MAX_C]
  static constexpr int AEND = BONUS + 2 * MAX_C;       // [D]
  static constexpr int U = AEND + D;                   // [D]
  static constexpr int BAR = U + D;                    // two mbarriers
  static constexpr int FLOATS = BAR + 4;
  static constexpr int BYTES = 4 * FLOATS + 128;       // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one box of a 4-D tensor map (D, H, T, B) into shared memory, its bytes
// counted on the mbarrier
__device__ __forceinline__ void tma_load(const CUtensorMap* map, float* dst,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

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

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// x rounded to TF32, to nearest with ties away from zero (cvt.rna's
// rounding): half a TF32 ulp added to the magnitude's bits, the 13 low
// bits cleared
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// lo = tf32(x - hi(x)), as a float (the mma reads its TF32 bits)
__device__ __forceinline__ float lo_of(float x) {
  return __uint_as_float(tf32(x - __uint_as_float(tf32(x))));
}

// One k-step of two 16 x 8 tiles sharing the A fragment, in 3xTF32: the
// hi*hi products into cb, the lo*hi + hi*lo products into cs (two
// independent chains; the tile is cb + cs).  Fragments (lane = 4 g + t):
//   A 16x8 : a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B 8x8  : b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C 16x8 : c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
__device__ __forceinline__ void mma3(float (&cb)[2][4], float (&cs)[2][4],
                                     const uint32_t* ah, const uint32_t* al,
                                     const uint32_t (&bh)[2][2],
                                     const uint32_t (&bl)[2][2]) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    mma(cs[n], al, bh[n]);
    mma(cs[n], ah, bl[n]);
    mma(cb[n], ah, bh[n]);
  }
}

// A fragment at (row0, col0) of a tile split ahead of time into hi and lo
// tiles (row stride P)
template <int P>
__device__ __forceinline__ void frag_a(uint32_t* ah, uint32_t* al,
                                       const float* hi, const float* lo,
                                       int row0, int col0, int g, int t) {
  const int o = (row0 + g) * P + col0 + t;
  const int off[4] = {0, 8 * P, 4, 8 * P + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = __float_as_uint(hi[o + off[i]]);
    al[i] = __float_as_uint(lo[o + off[i]]);
  }
}

template <int D, int DV, bool TMA>
__global__ void __launch_bounds__(threads_for(D), D == 64 ? 1 : 2)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ out, float* __restrict__ sT,
                  float* __restrict__ states, int T, int H, int C, Strides st,
                  const __grid_constant__ CUtensorMap rmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap vmap) {
  using L = Smem<D, DV>;
  constexpr int THREADS = threads_for(D), WARPS = THREADS / 32;
  constexpr int PD = L::PD, PV = L::PV;
  constexpr int NRB = THREADS / D;   // row blocks of the decay pass
  constexpr int RBM = MAX_C / NRB;   // most rows a row block holds
  extern __shared__ __align__(128) float smem_raw[];
  // TMA boxes land on 128-byte boundaries: the base is aligned, and every
  // tile of a stage is a multiple of 128 bytes
  float* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127) / 4;
  float* att = smem + L::ATT;
  float* attlo = smem + L::ATTLO;
  float* vlo = smem + L::VLO;
  float* tot = smem + L::TOT;
  float* bonus = smem + L::BONUS;
  float* aend = smem + L::AEND;
  float* us = smem + L::U;

  const int j0 = blockIdx.x * DV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int CP = (C + 15) / 16 * 16, MB = CP / 16;
  const int nchunks = T / C;
  const float* rp = r + b * st.rb + h * st.rh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh + j0;
  const float* wp = w + b * st.wb + h * st.wh;
  const long long sbase = ((long long)b * H + h) * D * D;

  // chunk c's r, k, w rows and v block into stage s (rows < C only): by
  // TMA, four boxes issued by thread 0 and counted on the stage's
  // mbarrier, where every pointer and stride is 16-byte aligned; else by
  // 4-byte cp.async from every thread
  const uint32_t bars = smem_u32(smem + L::BAR);
  auto load = [&](int s, int c) {
    float* base = smem + s * L::STAGE;
    if constexpr (TMA) {
      if (tid != 0) return;
      const uint32_t bar = bars + 8 * s;
      mbar_expect_tx(bar, 4 * C * (3 * PD + PV));
      tma_load(&rmap, base, bar, 0, h, c * C, b);
      tma_load(&kmap, base + L::TILE, bar, 0, h, c * C, b);
      tma_load(&wmap, base + 2 * L::TILE, bar, 0, h, c * C, b);
      tma_load(&vmap, base + 3 * L::TILE, bar, j0, h, c * C, b);
    } else {
      const long long t0 = (long long)c * C;
      const float* src[4] = {rp + t0 * st.rt, kp + t0 * st.kt,
                             wp + t0 * st.wt, vp + t0 * st.vt};
      const long long ts[4] = {st.rt, st.kt, st.wt, st.vt};
#pragma unroll
      for (int m = 0; m < 3; ++m)
        for (int i = tid; i < C * D; i += THREADS)
          cp4(base + m * L::TILE + i / D * PD + i % D,
              src[m] + i / D * ts[m] + i % D);
      for (int i = tid; i < C * DV; i += THREADS)
        cp4(base + 3 * L::TILE + i / DV * PV + i % DV,
            src[3] + i / DV * ts[3] + i % DV);
      cp_commit();
    }
  };

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  load(0, 0);
  // pad rows C..CP-1 of r, k, v in both stages: zero, never loaded
  for (int s = 0; s < 2; ++s) {
    float* base = smem + s * L::STAGE;
    for (int i = tid; i < (CP - C) * D; i += THREADS) {
      const int row = C + i / D, col = i % D;
      base[row * PD + col] = 0.f;
      base[L::TILE + row * PD + col] = 0.f;
      base[2 * L::TILE + row * PD + col] = 0.f;
    }
    for (int i = tid; i < (CP - C) * DV; i += THREADS)
      base[3 * L::TILE + (C + i / DV) * PV + i % DV] = 0.f;
  }
  for (int i = tid; i < D * DV; i += THREADS) {
    const int d = i / DV, j = i % DV;
    smem[L::S + d * PV + j] = s0[sbase + (long long)d * D + j0 + j];
  }
  for (int i = tid; i < D; i += THREADS) us[i] = u[h * D + i];

  const int dcol = tid % D, rb = tid / D;       // the decay pass's cell
  const int RB = (CP + NRB - 1) / NRB;          // rows per row block
  const int rlo = rb * RB;

  for (int ci = 0; ci < nchunks; ++ci) {
    if constexpr (TMA)
      mbar_wait(bars + 8 * (ci & 1), (ci >> 1) & 1);
    else
      cp_wait_all();
    __syncthreads();  // chunk ci landed; chunk ci - 1 is done everywhere
    if (ci + 1 < nchunks) load((ci + 1) & 1, ci + 1);

    float* R = smem + (ci & 1) * L::STAGE;      // r, then hi(rA)
    float* K = R + L::TILE;                     // k, then kA
    const float* W = K + L::TILE;
    float* Wlo = K + L::TILE;                   // w, then lo(rA)
    const float* V = W + L::TILE;
    const float* Sold = smem + L::S + (ci & 1) * D * PV;
    float* Snew = smem + L::S + ((ci + 1) & 1) * D * PV;
    const int c0 = ci * C;
    // the chunk's start state, for the backward (rwkv6_scan_bwd.cu), when
    // asked: (B, H, T / C, D, D), this CTA's DV columns
    if (states != nullptr) {
      float* sg = states + (sbase / (D * D) * nchunks + ci) * D * D + j0;
      for (int i = tid; i < D * DV; i += THREADS)
        sg[i / DV * D + i % DV] = Sold[i / DV * PV + i % DV];
    }

    // (i) this thread's rows of r, k and log w into registers, the sum of
    //     log w; the bonus r_t . (u * k_t), a warp's rows side by side
    float rr[RBM], kr[RBM], lw[RBM];
    float run = 0.f;
    // every row of the 64 is allocated: load them all, then select, so
    // the rows' loads and logs overlap (no branch per row)
#pragma unroll
    for (int i = 0; i < RBM; ++i) {
      const int row = rlo + i;
      rr[i] = R[row * PD + dcol];
      kr[i] = K[row * PD + dcol];
      lw[i] = W[row * PD + dcol];
    }
#pragma unroll
    for (int i = 0; i < RBM; ++i) {
      const bool real = i < RB && rlo + i < C;
      rr[i] = real ? rr[i] : 0.f;
      kr[i] = real ? kr[i] : 0.f;
      lw[i] = logf(real ? lw[i] : 1.f);
      run += lw[i];
    }
    tot[rb * D + dcol] = run;
#pragma unroll
    for (int q = 0; q < MAX_C * DV / THREADS; ++q) {
      const int i = tid + q * THREADS;   // all 64 rows: rows past CP unread
      vlo[i / DV * PV + i % DV] = lo_of(V[i / DV * PV + i % DV]);
    }
    // the bonus r_t . (u * k_t): this thread's terms, summed over the
    // LG lanes of its warp that share its row block by a halving
    // butterfly (log2 RBM steps leave each lane one row's sum, the rest
    // sum across lanes); one partial per 32 columns, added in order in (B)
    {
      constexpr int LG = D < 32 ? D : 32;
      float p[RBM];
#pragma unroll
      for (int i = 0; i < RBM; ++i) p[i] = rr[i] * (us[dcol] * kr[i]);
      int row = 0;
#pragma unroll
      for (int off = LG / 2, n = RBM; off >= 1; off >>= 1) {
        if (n > 1) {
          const bool upper = lane & off;
#pragma unroll
          for (int j = 0; j < n / 2; ++j) {
            const float send = upper ? p[j] : p[j + n / 2];
            const float keep = upper ? p[j + n / 2] : p[j];
            p[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
          row += upper ? n / 2 : 0;
          n /= 2;
        } else {
          p[0] += __shfl_xor_sync(0xffffffffu, p[0], off);
        }
      }
      // lanes below the halving bits hold duplicates: the lowest writes;
      // slots past the block's RB rows hold zeros that are not its rows
      if ((lane & (LG / RBM - 1)) == 0 && row < RB)
        bonus[(dcol / 32) * MAX_C + rlo + row] = p[0];
    }
    __syncthreads();

    // (ii) cum = (sum of the earlier row blocks) + (running sum in the
    //      block); rA and kA in place; A_end from the same sums
    {
      float pre = 0.f, all = 0.f;
      // all = the whole sum in block order, as the last real row sees it
#pragma unroll
      for (int q = 0; q < NRB; ++q) {
        const float x = tot[q * D + dcol];
        if (q < rb) pre += x;
        all += x;
      }
      if (rb == 0) aend[dcol] = expf(all);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < RBM; ++i) {
        part += lw[i];
        const float cum = pre + part;
        rr[i] *= expf(cum - lw[i]);
        kr[i] = kr[i] / fmaxf(expf(cum), 1e-24f);
      }
#pragma unroll
      for (int i = 0; i < RBM; ++i) {
        const int row = rlo + i;
        if (i < RB && row < C) {
          R[row * PD + dcol] = __uint_as_float(tf32(rr[i]));
          Wlo[row * PD + dcol] = lo_of(rr[i]);
          K[row * PD + dcol] = kr[i];
        }
      }
    }
    __syncthreads();

    // The products, as tasks of 16-row tiles, each on one warp:
    //   score : scores of row block tb, 8-column tiles sn = 2p, 2p + 1
    //           (sn < 2 (tb + 1): on or below the diagonal), masked to
    //           s < t and stored as hi / lo
    //   state : S'^T for 16 value columns mb and key tiles nt0, nt0 + 1
    //   y     : y of row block tb, 8-column tiles nt0, nt0 + 1
    auto score = [&](int tb, int p) {
      float cb[2][4] = {}, cs[2][4] = {};
      uint32_t ah[4], al[4], bh[2][2], bl[2][2];
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        frag_a<PD>(ah, al, R, Wlo, 16 * tb, 8 * kk, g, t4);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float* kb = K + (8 * (2 * p + n) + g) * PD + 8 * kk + t4;
          split(kb[0], bh[n][0], bl[n][0]);
          split(kb[4], bh[n][1], bl[n][1]);
        }
        mma3(cb, cs, ah, al, bh, bl);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int row = 16 * tb + g, col = 8 * (2 * p + n) + 2 * t4;
        const float x[4] = {col < row ? cb[n][0] + cs[n][0] : 0.f,
                            col + 1 < row ? cb[n][1] + cs[n][1] : 0.f,
                            col < row + 8 ? cb[n][2] + cs[n][2] : 0.f,
                            col + 1 < row + 8 ? cb[n][3] + cs[n][3] : 0.f};
        const int o[4] = {row * PA + col, row * PA + col + 1,
                          (row + 8) * PA + col, (row + 8) * PA + col + 1};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          att[o[i]] = __uint_as_float(tf32(x[i]));
          attlo[o[i]] = lo_of(x[i]);
        }
      }
    };
    auto state = [&](int q) {
      // S'^T[j][d] = A_end[d] S[d][j] + sum_s v[s][j] (kA[s][d] A_end[d]):
      // A[m = j][k = s] = v[s][j], B[k = s][n = d] = kA[s][d] A_end[d]
      const int mb = q / (D / 16), nt0 = q % (D / 16) * 2, j = 16 * mb + g;
      float cb[2][4], cs[2][4] = {}, ae[2];
      uint32_t ah[4], al[4], bh[2][2], bl[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int d = 8 * (nt0 + n) + 2 * t4;
        cb[n][0] = aend[d] * Sold[d * PV + j];
        cb[n][1] = aend[d + 1] * Sold[(d + 1) * PV + j];
        cb[n][2] = aend[d] * Sold[d * PV + j + 8];
        cb[n][3] = aend[d + 1] * Sold[(d + 1) * PV + j + 8];
        ae[n] = aend[8 * (nt0 + n) + g];
      }
#pragma unroll
      for (int kk = 0; kk < MAX_C / 8; ++kk) {
        if (kk >= CP / 8) break;
        const int o = (8 * kk + t4) * PV + 16 * mb + g;
        const int off[4] = {0, 8, 4 * PV, 4 * PV + 8};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = tf32(V[o + off[i]]);
          al[i] = __float_as_uint(vlo[o + off[i]]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float* kb = K + (8 * kk + t4) * PD + 8 * (nt0 + n) + g;
          split(kb[0] * ae[n], bh[n][0], bl[n][0]);
          split(kb[4 * PD] * ae[n], bh[n][1], bl[n][1]);
        }
        mma3(cb, cs, ah, al, bh, bl);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int d = 8 * (nt0 + n) + 2 * t4;
        Snew[d * PV + j] = cb[n][0] + cs[n][0];
        Snew[(d + 1) * PV + j] = cb[n][1] + cs[n][1];
        Snew[d * PV + j + 8] = cb[n][2] + cs[n][2];
        Snew[(d + 1) * PV + j + 8] = cb[n][3] + cs[n][3];
      }
    };
    auto ytile = [&](int tb, int nt0) {
      float cb[2][4] = {}, cs[2][4] = {};
      uint32_t ah[4], al[4], bh[2][2], bl[2][2];
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {     // rA S
        frag_a<PD>(ah, al, R, Wlo, 16 * tb, 8 * kk, g, t4);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float* sb = Sold + (8 * kk + t4) * PV + 8 * (nt0 + n) + g;
          split(sb[0], bh[n][0], bl[n][0]);
          split(sb[4 * PV], bh[n][1], bl[n][1]);
        }
        mma3(cb, cs, ah, al, bh, bl);
      }
#pragma unroll
      for (int kk = 0; kk < MAX_C / 8; ++kk) {  // scores v
        if (kk >= 2 * (tb + 1)) break;
        frag_a<PA>(ah, al, att, attlo, 16 * tb, 8 * kk, g, t4);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int o = (8 * kk + t4) * PV + 8 * (nt0 + n) + g;
          bh[n][0] = tf32(V[o]);
          bl[n][0] = __float_as_uint(vlo[o]);
          bh[n][1] = tf32(V[o + 4 * PV]);
          bl[n][1] = __float_as_uint(vlo[o + 4 * PV]);
        }
        mma3(cb, cs, ah, al, bh, bl);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 8 * (nt0 + n) + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * tb + g + 8 * half;
          if (row < C) {
            const float bo = D > 32 ? bonus[row] + bonus[MAX_C + row]
                                    : bonus[row];
            float2 y;
            y.x = (cb[n][2 * half] + cs[n][2 * half]) + bo * V[row * PV + col];
            y.y = (cb[n][2 * half + 1] + cs[n][2 * half + 1]) +
                  bo * V[row * PV + col + 1];
            *reinterpret_cast<float2*>(
                out + (((long long)b * T + c0 + row) * H + h) * D + j0 + col) =
                y;
          }
        }
      }
    };

    // (A) the score tiles (MB (MB + 1) / 2 pairs), and on the warps they
    //     leave idle the first state tiles
    const int nsc = MB * (MB + 1) / 2, nst = (DV / 16) * (D / 16);
    const int st_a = nsc < WARPS ? min(nst, WARPS - nsc) : 0;
    for (int task = warp; task < nsc + st_a; task += WARPS) {
      if (task < nsc) {
        int tb = 0, p = task;
        while (p >= tb + 1) p -= ++tb;
        score(tb, p);
      } else {
        state(task - nsc);
      }
    }
    __syncthreads();

    // (B) y = rA S + scores v + bonus v, rows < C to (B, T, H, D), in
    //     tile pairs; then the other state tiles on the warps the y tiles
    //     leave idle (or after them)
    const int ny = MB * (DV / 16);
    for (int task = warp; task < ny; task += WARPS)
      ytile(task / (DV / 16), task % (DV / 16) * 2);
    {
      const int first = ny < WARPS ? ny : 0;
      for (int q = st_a + warp - first; warp >= first && q < nst;
           q += WARPS - first)
        state(q);
    }
    // this chunk's writes to its stage, before the copies that refill it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  cp_wait_all();
  __syncthreads();
  const float* Sfin = smem + L::S + (nchunks & 1) * D * PV;
  for (int i = tid; i < D * DV; i += THREADS) {
    const int d = i / DV, j = i % DV;
    sT[sbase + (long long)d * D + j0 + j] = Sfin[d * PV + j];
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: reached through the runtime,
// so the library needs no -lcuda (as in flash_attention.cu).
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

// A 4-D fp32 map over (D, H, T, B) with element strides (1, sh, st, sb);
// boxes of `cols` columns (past D: zero-filled, the tile's row padding) x
// C rows of one head, so a box lands as C rows of `cols` floats.
bool encode(CUtensorMap* map, const void* ptr, int D, int H, int T, int B,
            long long sh, long long st, long long sb, int cols, int C) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {4ull * sh, 4ull * st, 4ull * sb};
  cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)C, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV, bool TMA>
int launch_one(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, void* out, void* sT,
               void* states, int B, int T, int H, int C, const Strides& st,
               const CUtensorMap* maps, cudaStream_t stream) {
  constexpr int bytes = Smem<D, DV>::BYTES;
  // above 48 KB only as opted-in dynamic shared memory
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_scan_kernel<D, DV, TMA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  rwkv6_scan_kernel<D, DV, TMA>
      <<<dim3(D / DV, H, B), threads_for(D), bytes, stream>>>(
          static_cast<const float*>(r), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(w),
          static_cast<const float*>(u), static_cast<const float*>(s0),
          static_cast<float*>(out), static_cast<float*>(sT),
          static_cast<float*>(states), T, H, C, st, maps[0], maps[1], maps[2],
          maps[3]);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* sT, void* states,
           int B, int T, int H, int C, bool tma, const Strides& st,
           cudaStream_t stream) {
  using L = Smem<D, DV>;
  CUtensorMap maps[4] = {};
  if (!tma)
    return launch_one<D, DV, false>(r, k, v, w, u, s0, out, sT, states, B, T,
                                    H, C, st, maps, stream);
  if (!(encode(&maps[0], r, D, H, T, B, st.rh, st.rt, st.rb, L::PD, C) &&
        encode(&maps[1], k, D, H, T, B, st.kh, st.kt, st.kb, L::PD, C) &&
        encode(&maps[2], w, D, H, T, B, st.wh, st.wt, st.wb, L::PD, C) &&
        encode(&maps[3], v, D, H, T, B, st.vh, st.vt, st.vb, L::PV, C)))
    return -2;
  return launch_one<D, DV, true>(r, k, v, w, u, s0, out, sT, states, B, T, H,
                                 C, st, maps, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// strides: 12 element strides (batch, time, head) of r, k, v, w in that
// order; u (H, D), state0 / stateT (B, H, D, D) and out (B, T, H, D) are
// contiguous; DV the value columns a CTA owns (`split` in the wrapper);
// tma 1 to load by TMA (`aligned` in the wrapper), 0 by 4-byte copies;
// states, when not null, (B, H, T / C, D, D) contiguous: the state at the
// start of each chunk, which the backward reads.
// Returns the cudaError_t of the launch (0 = cudaSuccess); -1 for a shape
// this file does not take (the Python wrapper checks first), -2 when a
// tensor map cannot be encoded.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u,
                                 const void* s0, void* out, void* sT, int B,
                                 int T, int H, int D, int C, int DV,
                                 int tma, const long long* strides,
                                 void* stream, void* states) {
  if (B < 1 || T < 1 || H < 1 || C < 1 || C > MAX_C || T % C) return -1;
  // a size-1 dim's stride is never stepped: give it the packed value
  long long s[12];
  for (int i = 0; i < 12; i += 3) {
    s[i] = B > 1 ? strides[i] : (long long)T * H * D;
    s[i + 1] = T > 1 ? strides[i + 1] : (long long)H * D;
    s[i + 2] = H > 1 ? strides[i + 2] : D;
  }
  const Strides st{s[0], s[1], s[2], s[3], s[4],  s[5],
                   s[6], s[7], s[8], s[9], s[10], s[11]};
  // TMA (the wrapper's `aligned` rule) needs every row start of r, k, w
  // and v 16-byte aligned: the pointers, and every stride a multiple of 4
  bool aligned = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w);
  for (int i = 0; i < 12; ++i) aligned = aligned && s[i] % 4 == 0;
  if (tma && !aligned) return -1;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define RWKV6_CASE(d, dv)                                                   \
  if (D == d && DV == dv)                                                  \
    return launch<d, dv>(r, k, v, w, u, s0, out, sT, states, B, T, H, C,   \
                         tma != 0, st, cs);
  RWKV6_CASE(16, 16)
  RWKV6_CASE(32, 16)
  RWKV6_CASE(64, 32)
#undef RWKV6_CASE
  return -1;
}
