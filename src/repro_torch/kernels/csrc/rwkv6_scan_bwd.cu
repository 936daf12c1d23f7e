// The backward of the chunked RWKV6 scan for Hopper (sm_90a): every
// input's gradient of `rwkv6_scan` (csrc/rwkv6_scan.cu) at the same chunk,
// fp32 in and out.
//
// Replaces: no TPU kernel.  The JAX package differentiates the jnp chunk
// body (src/repro/models/rwkv6.py::timemix_parallel) with autograd and has
// no Pallas backward; this kernel is the port's own, so that a train step
// on the card runs a hand-written kernel both ways.  Its plain version is
// `rwkv6_scan.plain_backward`, whose docstring states the formulas.  Per
// chunk of C rows, walked in reverse with dS (the gradient of the chunk's
// end state) carried, S the chunk's start state, E = A_end:
//   P    = tril_{-1}(rA kA^T),     dP = tril_{-1}(dy v^T)
//   dv   = P^T dy + bonus * dy + (kA * E) dS
//   drA  = dy S^T + dP kA,         dkA = dP^T rA + E * (v dS^T)
//   dE   = rowsum(S * dS) + sum_s kA_s * (v dS^T)_s
//   dr   = drA * A_excl + (dy . v) u * k
//   dk   = (dy . v) r * u + dkA / max(A_incl, 1e-24)
//   dcum = drA r A_excl + [A_incl >= 1e-24] (-dkA kA / A_incl) A_incl
//          + [last row] dE * E
//   dw   = (revcumsum(dcum) - drA r A_excl) / w
//   dS  <- rA^T dy + E * dS
// The start states come from the forward kernel, which writes them when
// asked (its `states` output, (B, H, T / C, D, D)): no recompute here.
//
// What bounds it on this card: at the rwkv6-7b train shape (B = 4, T =
// 1536, H = 64, D = 64, chunk 8) a call must read r, k, v, w, dy (~503
// MB) and the chunk-start states (~805 MB) and write dr, dk, dv, dw (~403
// MB): ~0.51 ms at 3.35 TB/s, and its products are ~15 GFLOP (~0.22 ms
// at the fp32 CUDA-core peak), so bytes bound it.  Only dS runs through
// the chunks in sequence, and only five terms of a chunk read it; the
// rest of a chunk (P, dP, the bonus, dy S^T, every elementwise term) does
// not wait on the chunks after it.  So the call is two kernels.  (On the
// card the body is bound instead by the latency of a chunk's five short
// phases at two CTAs an SM: PERF.md row 6c.)
//
// 1. The chain, `rwkv6_bwd_chain`: dS alone, walked through every chunk
//    in reverse.  Column j of dS depends only on column j of dy and of
//    dS, so one CTA owns a (batch, head, block of DV value columns); grid
//    (D / DV, H, B), DV from the Python rule `rwkv6_scan.chain_split`.
//    Each CTA walks blocks of 64 / C chunks: their r, w and its dy block
//    come in by TMA into a two-stage ring; rA and E of every chunk of a
//    block are formed at once, a thread a (chunk, column), in the order
//    of the body's decays below; then the updates run with no barrier
//    between chunks, each thread's dS block in its registers.  It writes
//    dS at the end of every G-th chunk as a checkpoint, (B, H, ceil(NC /
//    G), D, D), and dstate0.
// 2. The body, `rwkv6_bwd_body`: grid (ceil(NC / G), H, B), G from the
//    Python rule `rwkv6_scan.groups` (6144 CTAs at G 8 on the train
//    shape, where one CTA a head gave 256).  Each CTA starts from its
//    checkpoint and walks its G chunks in reverse with the formulas
//    above, recomputing dS inside the group with the chain's operations
//    (the same decay passes and the same FMAs in the same order, so its
//    dS equals the chain's bit for bit, whatever G and DV).  A chunk's r,
//    k, v, w, dy and S (TMA boxes) land in a two-stage ring while the
//    chunk before computes; at C > 32 the ring does not fit and a single
//    stage holds r, k, v, w, dy, S read straight from device
//    memory.  du leaves as a partial per (batch, head, group), which the
//    wrapper sums over the groups and then the batch, in order.
//
// In the body, dS lives in registers, a 4 x 4 block a thread at D = 64 (D
// / 16 square below), rows 4 xg + a, columns 4 jg + b, xg = tid / 16, jg
// = tid % 16, where rowsum(S dS) (summed over the 16 lanes of a half-warp
// by a fixed butterfly) and the update run; a mirror of it in shared
// memory feeds the products.  Every product of a chunk but the update runs
// on the fp64 tensor cores (mma m8n8k4), 8 x 8 tiles a warp each, rows of
// every tile padded to D + 4 floats so that the fragment loads hit 32
// banks: dy S^T, v dS^T, dP = dy v^T (its diagonal is dy . v), (kA E) dS
// and P = rA kA^T.  Sums over the value columns of products with dy (dy .
// v_t, dy_t . v_s, dy_t . S_x) must be taken in fp64: the per-head
// groupnorm's backward makes each dy row orthogonal to its output row, so
// these sums cancel (fp32 sums put dk and du at 1.3x the limit of
// chip_smoke's rule in rwkv6-7b's train step).  The elementwise tail's
// short sums and dw's reverse cumsum are double-float pairs (`df`).  A
// chunk is five phases between barriers: (1) what its decays leave alone
// (rowsum(S dS), dy S^T, v dS^T, dP, the bonus) and the decays' pass A;
// (2) their pass B; (3) (kA E) dS, P and the update of dS; (4) the
// elementwise terms, dv, dr and dk to memory; (5) dw.
//
// The decays of a chunk run over all 256 threads: thread (column x, row
// block rb) sums log w over its rows, the row blocks' sums combine in
// block order, and each thread then forms A_excl, A_incl and kA for its
// rows; the reverse cumsum of dcum is spread the same way.  w is read once
// into shared memory.  Deterministic: fixed orders, no atomics, no split
// of a sum between CTAs.  expf / logf and IEEE division: built without
// --use_fast_math.
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 64;
constexpr float EPS = 1e-24f;        // the clamp of kA's divisor
constexpr int SMEM_MAX = 232448;     // shared memory a block may opt into

__host__ __device__ constexpr int up32(int n) { return (n + 31) / 32 * 32; }

// The body's shared memory, in floats, for head dim D and chunk C: two
// stages holding S too (`staged`), or where those do not fit one stage
// without S.  Stage rows are PS = D + 4 floats (TMA boxes D + 4 wide, the
// columns past D zero-filled), and so are the rows of the chunk's own
// buffers and of dS's mirror, so that the fp64 mma's fragment loads, 8
// rows x 4 columns, hit 32 banks.  Tiles hold CR rows: C rounded up to 8
// and to the row batch of the products (16 / (D / 16) rows); rows past C
// are never written and their results never read.  Every buffer starts
// on 128 bytes.
struct BodyLayout {
  int CR, PS, TILE, STAGE, staged, nst;
  int ST, AE, AI, KA, VDS, DRAS, DVS, PDP, MIR, E, DEA, U, BON, DBON,
      TOT, DUP, BAR, FLOATS;
  __host__ __device__ BodyLayout(int D, int C, bool staged_)
      : staged(staged_), nst(staged_ ? 2 : 1) {
    const int q = 256 / D > 8 ? 256 / D : 8;
    CR = (C + q - 1) / q * q;
    PS = D + 4;
    TILE = up32(CR * PS);        // a (CR, D) tile, rows of PS
    STAGE = 5 * TILE + (staged ? D * PS : 0);  // r, k, v, w, dy[, S]
    int o = 0;
    ST = o;   o += nst * STAGE;
    AE = o;   o += TILE;         // A_excl
    AI = o;   o += TILE;         // A_incl, then dlog w's own term (hi)
    KA = o;   o += TILE;         // kA
    VDS = o;  o += TILE;         // v dS^T
    DRAS = o; o += TILE;         // dy S^T, then dcum (hi)
    DVS = o;  o += TILE;         // (kA E) dS, then dcum (lo)
    PDP = o;  o += up32(CR * CR);  // P[t][s] below the diagonal, dP[t][s]
                                   // at [s][t] above it
    MIR = o;  o += up32(D * PS);   // the mirror of dS
    E = o;    o += up32(D);
    DEA = o;  o += up32(D);      // rowsum(S * dS)
    U = o;    o += up32(D);
    BON = o;  o += up32(CR);     // bonus_t = r_t . (u * k_t)
    DBON = o; o += up32(CR);     // dy_t . v_t
    TOT = o;  o += up32(2 * THREADS);  // a row block's sum, per column
                                       // (fp32 in the decays, then a pair)
    DUP = o;  o += up32(THREADS);      // a row block's du, per column
    BAR = o;  o += up32(2 * nst);  // one mbarrier a stage
    FLOATS = o;
  }
  __host__ __device__ int bytes() const { return 4 * FLOATS + 128; }
};

// The chain walks blocks of KB = 64 / C chunks (one where C > 32): a
// block's rows, at most 64, come in together.
__host__ __device__ constexpr int chain_chunks(int C) {
  return C > MAX_C / 2 ? 1 : MAX_C / C;
}

// The chain's shared memory: two stages of a block's r (then rA), w (KB C
// x D) and dy block (KB C x DV), and the block's E (KB x D).
struct ChainLayout {
  static constexpr int nst = 2;
  int TILE, DYT, STAGE, ST, E, BAR, FLOATS;
  __host__ __device__ ChainLayout(int D, int DV, int C) {
    const int rows = chain_chunks(C) * C;
    TILE = up32(rows * D);
    DYT = up32(rows * DV);
    STAGE = 2 * TILE + DYT;      // r (then rA), w, dy block
    int o = 0;
    ST = o;  o += nst * STAGE;
    E = o;   o += up32(chain_chunks(C) * D);
    BAR = o; o += up32(2 * nst);
    FLOATS = o;
  }
  __host__ __device__ int bytes() const { return 4 * FLOATS + 128; }
};

// the dynamic shared memory, its base rounded up to 128 bytes (TMA boxes
// land on 128-byte boundaries)
__device__ __forceinline__ float* smem_base() {
  extern __shared__ __align__(128) float smem_raw[];
  return smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127) / 4;
}

// N consecutive floats (N = 4, 2 or 1) as one load or store
template <int N>
__device__ __forceinline__ void load_row(float (&o)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x, o[1] = x.y;
  } else {
    o[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&o)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  } else {
    *p = o[0];
  }
}

// v[0 .. N) summed over the 16 lanes of a half-warp (xor offsets 8, 4, 2,
// 1; N a power of two) in a fixed order.  While more than one value is
// left, a step keeps half of them (lanes with bit OFF set the upper half)
// and adds the partner's; then whole values are added.  Afterwards lane l
// holds in v[0 .. max(N / 16, 1)) the sums of indices (l % 16) * N / 16 +
// i.  `mask` names the half-warp's lanes.
template <int OFF, int M, typename T, int N>
__device__ __forceinline__ void hw_sum(T (&v)[N], int lane, unsigned mask) {
  if constexpr (OFF > 0) {
    if constexpr (M > 1) {
      const bool up = lane & OFF;
#pragma unroll
      for (int i = 0; i < M / 2; ++i) {
        const T send = up ? v[i] : v[i + M / 2];
        const T keep = up ? v[i + M / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(mask, send, OFF);
      }
      hw_sum<OFF / 2, M / 2>(v, lane, mask);
    } else {
      v[0] += __shfl_xor_sync(mask, v[0], OFF);
      hw_sum<OFF / 2, 1>(v, lane, mask);
    }
  }
}
template <typename T, int N>
__device__ __forceinline__ void half_warp_sum(T (&v)[N], int lane) {
  hw_sum<8, N>(v, lane, 0xffffu << (lane & 16));
}

// Double-float numbers: hi + lo, two fp32 values with |lo| <= ulp(hi) / 2,
// ~44 bits.  Phase (4)-(5)'s sums cancel to ~1e-3 of their terms at a small
// w; fp32 there put dw at up to 3x the fp32 plain version's error, and
// fp64 costs a conversion (16 a clock an SM) per operand.  Every operation
// is an explicit intrinsic, never contracted or reordered.
struct df {
  float hi, lo;
};
// a + b exactly (Knuth's two-sum)
__device__ __forceinline__ df two_sum(float a, float b) {
  const float s = __fadd_rn(a, b), bb = __fsub_rn(s, a);
  return {s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb))};
}
// a * b exactly
__device__ __forceinline__ df two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  return {p, __fmaf_rn(a, b, -p)};
}
__device__ __forceinline__ df df_add(df x, df y) {
  const df s = two_sum(x.hi, y.hi);
  const float lo = __fadd_rn(s.lo, __fadd_rn(x.lo, y.lo));
  const float hi = __fadd_rn(s.hi, lo);
  return {hi, __fsub_rn(lo, __fsub_rn(hi, s.hi))};
}
// x * b, b a float
__device__ __forceinline__ df df_mul(df x, float b) {
  const df p = two_prod(x.hi, b);
  return df_add(p, {__fmul_rn(x.lo, b), 0.f});
}
__device__ __forceinline__ float df_float(df x) { return __fadd_rn(x.hi, x.lo); }

// One 8 x 8 tile of A B (K a multiple of 8) on the fp64 tensor cores, one
// warp: A[m][k] = a(m, k), B[k][n] = b(k, n), fp32 values widened; the sum
// over k in steps of 4 in two chains (even and odd steps) added at the
// end.  This lane gets the tile's elements (lane / 4, 2 (lane % 4) + i).
template <typename FA, typename FB>
__device__ __forceinline__ void dmma_tile(double (&out)[2], int K, int lane,
                                          FA a, FB b) {
  const int g = lane >> 2, q = lane & 3;
  double c0[2] = {0.0, 0.0}, c1[2] = {0.0, 0.0};
#pragma unroll 4
  for (int kk = 0; kk < K; kk += 8) {
    dmma_m8n8k4(c0, a(g, kk + q), b(kk + q, g));
    dmma_m8n8k4(c1, a(g, kk + 4 + q), b(kk + 4 + q, g));
  }
  out[0] = c0[0] + c1[0];
  out[1] = c0[1] + c1[1];
}

// The decays of one chunk as `_chunk_terms` forms them, over the CTA's 256
// threads: thread (column x = tid % D, row block rb = tid / D) owns rows
// r0 .. r0 + RB - 1 of its column, RB = ceil(C / NRB).  Both kernels run
// these passes with the same threads, so rA = r * A_excl and E agree
// between them bit for bit.
template <int D>
struct Rows {
  static constexpr int NRB = THREADS / D;  // row blocks
  static constexpr int RBM = MAX_C / NRB;  // the most rows a block holds
  int x, rb, RB, r0, r1;                   // rows [r0, r1)
  __device__ explicit Rows(int C)
      : x(threadIdx.x % D), rb(threadIdx.x / D), RB((C + NRB - 1) / NRB),
        r0(rb * RB), r1(min(C, rb * RB + RB)) {}
};

// pass A: lw = log w over the block's rows (in registers; w's rows PS
// apart), their sum in row order into tot[rb][x]
template <int D>
__device__ __forceinline__ void decay_a(const Rows<D>& q, const float* W,
                                        int PS, float* tot,
                                        float (&lw)[Rows<D>::RBM]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < Rows<D>::RBM; ++i) {
    if (q.r0 + i < q.r1) {
      lw[i] = logf(W[(q.r0 + i) * PS + q.x]);
      s = __fadd_rn(s, lw[i]);
    }
  }
  tot[q.rb * D + q.x] = s;
}

// pass B: cum = (the earlier blocks' sums, in block order) + the running
// sum in the block; A_excl = exp(cum - lw), A_incl = exp(cum), kA = k /
// max(A_incl, EPS) (every tile's rows PS apart); E = A_incl of the
// chunk's last row.
template <int D>
__device__ __forceinline__ void decay_b(const Rows<D>& q, const float* tot,
                                        const float (&lw)[Rows<D>::RBM],
                                        const float* K, int PS, float* AE,
                                        float* AI, float* KA, float* E,
                                        int C) {
  float pre = 0.f, part = 0.f;
  for (int p = 0; p < q.rb; ++p) pre = __fadd_rn(pre, tot[p * D + q.x]);
#pragma unroll
  for (int i = 0; i < Rows<D>::RBM; ++i) {
    const int t = q.r0 + i, o = t * PS + q.x;
    if (t < q.r1) {
      part = __fadd_rn(part, lw[i]);
      const float cum = __fadd_rn(pre, part);
      const float ai = expf(cum);
      AE[o] = expf(__fsub_rn(cum, lw[i]));
      AI[o] = ai;
      KA[o] = __fdiv_rn(K[o], fmaxf(ai, EPS));
      if (t == C - 1) E[q.x] = ai;
    }
  }
}

// One column of one chunk on one thread: rA = r * A_excl (in place of r,
// rows strided by D) and E, with the sums of `decay_a` / `decay_b` in the
// same association (the row blocks' sums in block order, then the running
// sum in the block), so both equal the body's bit for bit.
template <int D>
__device__ __forceinline__ void decay_column(float* R, const float* W,
                                             float* E, int C) {
  const int RB = (C + Rows<D>::NRB - 1) / Rows<D>::NRB;
  float pre = 0.f;
  for (int r0 = 0; r0 < C; r0 += RB) {
    const int r1 = min(C, r0 + RB);
    float part = 0.f;
    for (int t = r0; t < r1; ++t) {
      const float lw = logf(W[t * D]);
      part = __fadd_rn(part, lw);
      const float cum = __fadd_rn(pre, part);
      R[t * D] = __fmul_rn(R[t * D], expf(__fsub_rn(cum, lw)));
      if (t == C - 1) *E = expf(cum);
    }
    pre = __fadd_rn(pre, part);
  }
}

// ---------------------------------------------------------------------------
// the chain: dS through every chunk, checkpoints every G chunks
// ---------------------------------------------------------------------------

template <int D, int DV, bool TMA>
__global__ void __launch_bounds__(THREADS)
rwkv6_bwd_chain(const float* __restrict__ r, const float* __restrict__ w,
                const float* __restrict__ dy, const float* __restrict__ dsT,
                float* __restrict__ ckpt, float* __restrict__ ds0, int T,
                int H, int C, int G,
                const __grid_constant__ CUtensorMap rmap,
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap dymap) {
  constexpr int NA = D / 16, NB = DV / 16;  // a thread's rows, columns
  float* sm = smem_base();
  const ChainLayout L(D, DV, C);
  constexpr int nst = ChainLayout::nst;
  const int j0 = blockIdx.x * DV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, hi = tid >> 4, lo = tid & 15;
  const int NC = T / C, NG = (NC + G - 1) / G;
  const int KB = chain_chunks(C), NBK = (NC + KB - 1) / KB;
  const long long bh = (long long)b * H + h;
  const long long ts = (long long)H * D;   // a row's stride in (B, T, H, D)
  const long long head = (long long)b * T * ts + (long long)h * D;
  float* E = sm + L.E;
  const uint32_t bars = smem_u32(sm + L.BAR);

  // this thread's elements of dS: rows NA hi + a, columns j0 + NB lo + c
  float ds[NA][NB];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int c = 0; c < NB; ++c)
      ds[a][c] = dsT[bh * D * D + (NA * hi + a) * D + j0 + NB * lo + c];

  // step i's block (NBK - 1 - i: chunks from KB times it) into stage i %
  // nst; a TMA box past T is zero-filled
  auto issue = [&](int i) {
    const int t0 = (NBK - 1 - i) * KB * C;
    float* st = sm + L.ST + (i % nst) * L.STAGE;
    if constexpr (TMA) {
      if (tid != 0) return;
      const uint32_t bar = bars + 8 * (i % nst);
      mbar_expect_tx(bar, 4 * KB * C * (2 * D + DV));
      tma_load(&rmap, smem_u32(st), bar, 0, h, t0, b);
      tma_load(&wmap, smem_u32(st + L.TILE), bar, 0, h, t0, b);
      tma_load(&dymap, smem_u32(st + 2 * L.TILE), bar, j0, h, t0, b);
    } else {
      const int rows = min(T - t0, KB * C);
      const long long row0 = head + (long long)t0 * ts;
      for (int e = tid; e < rows * D; e += THREADS) {
        const long long g = row0 + (e / D) * ts + e % D;
        cp_async_4(st + e, r + g);
        cp_async_4(st + L.TILE + e, w + g);
      }
      for (int e = tid; e < rows * DV; e += THREADS)
        cp_async_4(st + 2 * L.TILE + e,
                   dy + row0 + (e / DV) * ts + j0 + e % DV);
    }
  };

  if (TMA && tid == 0) {
    for (int s = 0; s < nst; ++s) mbar_init(bars + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  for (int i = 0; i < nst - 1; ++i) {   // nst - 1 commit groups, always
    if (i < NBK) issue(i);
    if (!TMA) cp_async_commit();
  }
  for (int i = 0; i < NBK; ++i) {
    const int c0 = (NBK - 1 - i) * KB, nk = min(NC - c0, KB);
    __syncthreads();  // step i - 1 done everywhere: its stage may refill
    if (i + nst - 1 < NBK) issue(i + nst - 1);
    if constexpr (TMA) {
      mbar_wait(bars + 8 * (i % nst), (i / nst) & 1);
    } else {
      cp_async_commit();
      cp_async_wait(nst - 1);
      __syncthreads();
    }
    float* st = sm + L.ST + (i % nst) * L.STAGE;
    float* RA = st;                      // r, then rA
    const float* W = st + L.TILE;
    const float* DYB = st + 2 * L.TILE;

    // the decays of the block's chunks, a thread a (chunk, column)
    for (int p = tid; p < nk * D; p += THREADS) {
      const int k = p / D, x = p % D;
      decay_column<D>(RA + k * C * D + x, W + k * C * D + x, E + k * D + x,
                      C);
    }
    __syncthreads();
    for (int k = nk - 1; k >= 0; --k) {
      const int c = c0 + k;
      // the end-state gradient of a group's last chunk: its checkpoint
      if (c == NC - 1 || c % G == G - 1) {
        float* ck = ckpt + (bh * NG + c / G) * D * D;
#pragma unroll
        for (int a = 0; a < NA; ++a)
          store_row(ck + (NA * hi + a) * D + j0 + NB * lo, ds[a]);
      }
      // dS <- rA^T dy + E * dS: per element, fp32 FMAs in row order, then
      // E * dS added (the body's update, the same operations)
      const float* RK = RA + k * C * D;
      const float* YK = DYB + k * C * DV;
      float acc[NA][NB] = {}, e1[NA];
      for (int t = 0; t < C; ++t) {
        float ra[NA], yy[NB];
        load_row(ra, RK + t * D + NA * hi);
        load_row(yy, YK + t * DV + NB * lo);
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
          for (int cc = 0; cc < NB; ++cc)
            acc[a][cc] = __fmaf_rn(ra[a], yy[cc], acc[a][cc]);
      }
      load_row(e1, E + k * D + NA * hi);
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int cc = 0; cc < NB; ++cc)
          ds[a][cc] = __fmaf_rn(e1[a], ds[a][cc], acc[a][cc]);
    }
    fence_async_shared();  // this step's reads and writes before the
                           // copies that refill its stage
  }
#pragma unroll
  for (int a = 0; a < NA; ++a)
    store_row(ds0 + bh * D * D + (NA * hi + a) * D + j0 + NB * lo, ds[a]);
}

// ---------------------------------------------------------------------------
// the body: a group of G chunks from its checkpoint
// ---------------------------------------------------------------------------

template <int D, bool TMA>
__global__ void __launch_bounds__(THREADS, 2)
rwkv6_bwd_body(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u,
               const float* __restrict__ states,
               const float* __restrict__ dy, const float* __restrict__ ckpt,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ du_part, int T, int H, int C, int G,
               int staged,
               const __grid_constant__ CUtensorMap rmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap dymap,
               const __grid_constant__ CUtensorMap smap) {
  constexpr int TS = D / 16;   // a thread's block of dS is TS x TS
  float* sm = smem_base();
  const BodyLayout L(D, C, staged != 0);
  const int nst = L.nst;
  const Rows<D> q(C);
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hi = tid >> 4, lo = tid & 15;
  const int NC = T / C, NG = (NC + G - 1) / G;
  const int c_last = min(NC, g * G + G) - 1, n = c_last - g * G + 1;
  const long long bh = (long long)b * H + h;
  const long long ts = (long long)H * D;   // a row's stride in (B, T, H, D)
  const long long head = (long long)b * T * ts + (long long)h * D;
  const int CR = L.CR, PS = L.PS;
  const int SS = L.staged ? PS : D;   // S's row stride
  float* AE = sm + L.AE;
  float* AI = sm + L.AI;
  float* KA = sm + L.KA;
  float* VDS = sm + L.VDS;
  float* DRAS = sm + L.DRAS;
  float* DVS = sm + L.DVS;
  float* PDP = sm + L.PDP;
  float* MIR = sm + L.MIR;
  float* E = sm + L.E;
  float* DEA = sm + L.DEA;
  float* U = sm + L.U;
  float* BON = sm + L.BON;
  float* DBON = sm + L.DBON;
  float* TOT = sm + L.TOT;
  float* DUP = sm + L.DUP;
  const uint32_t bars = smem_u32(sm + L.BAR);

  // dS in registers: rows TS hi + a, columns TS lo + c (the checkpoint of
  // the group's last chunk), and its mirror
  float ds[TS][TS];
  {
    const float* ck = ckpt + (bh * NG + g) * D * D;
#pragma unroll
    for (int a = 0; a < TS; ++a) {
      load_row(ds[a], ck + (TS * hi + a) * D + TS * lo);
      store_row(MIR + (TS * hi + a) * PS + TS * lo, ds[a]);
    }
  }
  for (int i = tid; i < D; i += THREADS) U[i] = u[h * D + i];

  // step i's chunk (c_last - i) into stage i % nst
  auto issue = [&](int i) {
    const int c = c_last - i;
    float* st = sm + L.ST + (i % nst) * L.STAGE;
    const float* sg = states + (bh * NC + c) * D * D;
    if constexpr (TMA) {
      if (tid != 0) return;
      const uint32_t bar = bars + 8 * (i % nst);
      mbar_expect_tx(bar, 4 * PS * (5 * C + (L.staged ? D : 0)));
      tma_load(&rmap, smem_u32(st), bar, 0, h, c * C, b);
      tma_load(&kmap, smem_u32(st + L.TILE), bar, 0, h, c * C, b);
      tma_load(&vmap, smem_u32(st + 2 * L.TILE), bar, 0, h, c * C, b);
      tma_load(&wmap, smem_u32(st + 3 * L.TILE), bar, 0, h, c * C, b);
      tma_load(&dymap, smem_u32(st + 4 * L.TILE), bar, 0, h, c * C, b);
      if (L.staged)
        tma_load(&smap, smem_u32(st + 5 * L.TILE), bar, 0, 0, c, (int)bh);
    } else {
      const long long row0 = head + (long long)c * C * ts;
      for (int e = tid; e < C * D; e += THREADS) {
        const long long o = row0 + (e / D) * ts + e % D;
        const int d = e / D * PS + e % D;
        cp_async_4(st + d, r + o);
        cp_async_4(st + L.TILE + d, k + o);
        cp_async_4(st + 2 * L.TILE + d, v + o);
        cp_async_4(st + 3 * L.TILE + d, w + o);
        cp_async_4(st + 4 * L.TILE + d, dy + o);
      }
      if (L.staged)
        for (int e = tid; e < D * D; e += THREADS)
          cp_async_4(st + 5 * L.TILE + e / D * PS + e % D, sg + e);
    }
  };

  if (TMA && tid == 0) {
    for (int s = 0; s < nst; ++s) mbar_init(bars + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  for (int i = 0; i < nst - 1; ++i) {   // nst - 1 commit groups, always
    if (i < n) issue(i);
    if (!TMA) cp_async_commit();
  }
  float du = 0.f, du_c = 0.f;  // thread x < D: du over the chunks (Kahan)

  for (int i = 0; i < n; ++i) {
    const int c = c_last - i;
    __syncthreads();  // step i - 1 done everywhere: its stage may refill
    if (i + nst - 1 < n) issue(i + nst - 1);
    if constexpr (TMA) {
      mbar_wait(bars + 8 * (i % nst), (i / nst) & 1);
    } else {
      cp_async_commit();
      cp_async_wait(nst - 1);
      __syncthreads();
    }
    float* st = sm + L.ST + (i % nst) * L.STAGE;
    const float* R = st;
    const float* K = st + L.TILE;
    const float* V = st + 2 * L.TILE;
    const float* W = st + 3 * L.TILE;
    const float* DY = st + 4 * L.TILE;
    // S: this thread's block, from the stage or (one stage) from memory
    const float* S = L.staged ? st + 5 * L.TILE
                              : states + (bh * NC + c) * D * D;
    const long long row0 = head + (long long)c * C * ts;
    float s[TS][TS];
#pragma unroll
    for (int a = 0; a < TS; ++a)
      load_row(s[a], S + (TS * hi + a) * SS + TS * lo);

    // (1) what the chunk's decays leave alone, then their pass A:
    //     rowsum(S dS) on this thread's blocks, summed over the columns
    //     across the half-warp; on the fp64 tensor cores, 8 x 8 tiles a
    //     warp each, dy S^T (rows t, columns x), v dS^T (dS from its
    //     mirror) and dP = dy v^T (tiles on or below the diagonal; its
    //     diagonal is dy_t . v_t); bonus_t = r_t . (u * k_t), a warp a row
    const int NX = D / 8, MT = (C + 7) / 8, NTT = MT * NX;
    const int NTRI = MT * (MT + 1) / 2;
    const int g8 = lane >> 2, q4 = lane & 3;
    {
      float p[TS];
#pragma unroll
      for (int a = 0; a < TS; ++a) {
        p[a] = 0.f;
#pragma unroll
        for (int cc = 0; cc < TS; ++cc) p[a] = fmaf(s[a][cc], ds[a][cc], p[a]);
      }
      half_warp_sum(p, lane);
      if (lo * TS % 16 == 0) DEA[TS * hi + lo * TS / 16] = p[0];
    }
    for (int task = warp; task < 2 * NTT + NTRI; task += THREADS / 32) {
      const int kind = task < NTT ? 0 : task < 2 * NTT ? 1 : 2;
      int t0, n0;
      if (kind < 2) {
        t0 = task % NTT / NX * 8, n0 = task % NTT % NX * 8;
      } else {
        int tb = 0, sb = task - 2 * NTT;
        while (sb > tb) sb -= ++tb;
        t0 = 8 * tb, n0 = 8 * sb;
      }
      const float* A = (kind == 1 ? V : DY) + t0 * PS;
      const float* Bm = kind == 0 ? S + n0 * SS
                                  : (kind == 1 ? MIR : V) + n0 * PS;
      const int bs = kind == 0 ? SS : PS;
      double o2[2];
      dmma_tile(o2, D, lane, [&](int m, int kx) { return A[m * PS + kx]; },
                [&](int kx, int n) { return Bm[n * bs + kx]; });
      const int t = t0 + g8;
      if (t >= C) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = n0 + 2 * q4 + i;
        const float x = (float)o2[i];
        if (kind == 0) DRAS[t * PS + n] = x;
        else if (kind == 1) VDS[t * PS + n] = x;
        else if (n < t) PDP[n * CR + t] = x;
        else if (n == t) DBON[t] = x;
      }
    }
    {
      for (int t = warp; t < C; t += THREADS / 32) {
        float bon = 0.f;
        for (int x = lane; x < D; x += 32)
          bon = fmaf(R[t * PS + x], U[x] * K[t * PS + x], bon);
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          bon += __shfl_xor_sync(0xffffffffu, bon, off);
        if (lane == 0) BON[t] = bon;
      }
      float lw[Rows<D>::RBM];
      decay_a<D>(q, W, PS, TOT, lw);
      __syncthreads();
      // (2) pass B: A_excl, A_incl, kA, E
      decay_b<D>(q, TOT, lw, K, PS, AE, AI, KA, E, C);
    }
    __syncthreads();

    // (3) what needs the decays: on the fp64 tensor cores, (kA E) dS (rows
    //     t, columns j; dS from its mirror) and P = rA kA^T (tiles on or
    //     below the diagonal); then the update of dS
    for (int task = warp; task < NTT + NTRI; task += THREADS / 32) {
      const bool pt = task >= NTT;
      int t0, n0;
      if (!pt) {
        t0 = task / NX * 8, n0 = task % NX * 8;
      } else {
        int tb = 0, sb = task - NTT;
        while (sb > tb) sb -= ++tb;
        t0 = 8 * tb, n0 = 8 * sb;
      }
      double o2[2];
      if (!pt) {
        dmma_tile(o2, D, lane,
                  [&](int m, int kx) {
                    return __fmul_rn(KA[(t0 + m) * PS + kx], E[kx]);
                  },
                  [&](int kx, int n) { return MIR[kx * PS + n0 + n]; });
      } else {
        dmma_tile(o2, D, lane,
                  [&](int m, int kx) {
                    const int o = (t0 + m) * PS + kx;
                    return __fmul_rn(R[o], AE[o]);
                  },
                  [&](int kx, int n) { return KA[(n0 + n) * PS + kx]; });
      }
      const int t = t0 + g8;
      if (t >= C) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = n0 + 2 * q4 + i;
        const float x = (float)o2[i];
        if (!pt) DVS[t * PS + n] = x;
        else if (n < t) PDP[t * CR + n] = x;
      }
    }
    {
      // dS <- rA^T dy + E * dS: per element, fp32 FMAs in row order, then
      // E * dS added (the chain's update, the same operations)
      float acc[TS][TS] = {}, e1[TS];
      for (int t = 0; t < C; ++t) {
        float ra[TS], ae[TS], yy[TS];
        load_row(ra, R + t * PS + TS * hi);
        load_row(ae, AE + t * PS + TS * hi);
        load_row(yy, DY + t * PS + TS * lo);
#pragma unroll
        for (int a = 0; a < TS; ++a) ra[a] = __fmul_rn(ra[a], ae[a]);
#pragma unroll
        for (int a = 0; a < TS; ++a)
#pragma unroll
          for (int cc = 0; cc < TS; ++cc)
            acc[a][cc] = __fmaf_rn(ra[a], yy[cc], acc[a][cc]);
      }
      load_row(e1, E + TS * hi);
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int cc = 0; cc < TS; ++cc)
          ds[a][cc] = __fmaf_rn(e1[a], ds[a][cc], acc[a][cc]);
    }
    __syncthreads();

    // (4) per column x, the block's rows: drA, dkA, dv, dr, dk (to
    //     memory); dcum and dlog w's own term c2 = dcum - drA r A_excl =
    //     -dkA kA [+ dE E], double-float pairs into buffers only this
    //     element's thread reads from here on (DRAS, DVS, AI; V, read by no
    //     one after (1)); the block's sums of dcum and of du's terms.  The
    //     sums over the chunk's rows, dcum and dlog w in double-float: dlog
    //     w sums terms up to ~1e3 x itself at a small w.  Then the new dS's
    //     mirror.
#pragma unroll
    for (int a = 0; a < TS; ++a)
      store_row(MIR + (TS * hi + a) * PS + TS * lo, ds[a]);
    float* V2 = st + 2 * L.TILE;
    {
      const int x = q.x;
      const float e = E[x], ux = U[x];
      df dE = {0.f, 0.f};
      if (q.r0 <= C - 1 && C - 1 < q.r1) {
        dE = {DEA[x], 0.f};
        for (int s2 = 0; s2 < C; ++s2)
          dE = df_add(dE, two_prod(KA[s2 * PS + x], VDS[s2 * PS + x]));
      }
      df tot = {0.f, 0.f};
      float dup = 0.f;
      for (int t = q.r0; t < q.r1; ++t) {
        const int o = t * PS + x;
        const float rr = R[o], kk = K[o], ae = AE[o], ai = AI[o], ka = KA[o];
        df d = {DRAS[o], 0.f}, dka = {0.f, 0.f};
        float dvv = 0.f;
        for (int s2 = 0; s2 < t; ++s2)
          d = df_add(d, two_prod(PDP[s2 * CR + t], KA[s2 * PS + x]));
        for (int t2 = t + 1; t2 < C; ++t2) {
          dka = df_add(dka, two_prod(PDP[t * CR + t2],
                                     __fmul_rn(R[t2 * PS + x],
                                               AE[t2 * PS + x])));
          dvv = fmaf(PDP[t2 * CR + t], DY[t2 * PS + x], dvv);
        }
        dka = df_add(dka, two_prod(e, VDS[o]));
        const float df32 = df_float(d), dka32 = df_float(dka);
        const long long gi = row0 + t * ts + x;
        dv[gi] = (dvv + BON[t] * DY[o]) + DVS[o];
        dr[gi] = df32 * ae + DBON[t] * (ux * kk);
        dk[gi] = DBON[t] * rr * ux + dka32 / fmaxf(ai, EPS);
        // A_incl >= EPS: -dkA * (kA / A_incl) * A_incl = -dkA kA; else the
        // clamp passes no gradient
        df c2 = ai >= EPS ? df_mul({-dka.hi, -dka.lo}, ka) : df{0.f, 0.f};
        if (t == C - 1) c2 = df_add(c2, df_mul(dE, e));
        const df dc = df_add({__fmul_rn(__fmul_rn(df32, rr), ae), 0.f}, c2);
        DRAS[o] = dc.hi;
        DVS[o] = dc.lo;
        AI[o] = c2.hi;
        V2[o] = c2.lo;
        tot = df_add(tot, dc);
        dup += DBON[t] * rr * kk;
      }
      TOT[2 * (q.rb * D + x)] = tot.hi;
      TOT[2 * (q.rb * D + x) + 1] = tot.lo;
      DUP[q.rb * D + x] = dup;
    }
    __syncthreads();

    // (5) per column: dlog w = (dcum summed over the later rows) + c2, the
    //     later blocks' sums first, then the block's rows from its last;
    //     dw = dlog w / w; du += the chunk's sum of (dy . v) r k, in block
    //     order
    {
      const int x = q.x;
      df run = {0.f, 0.f};
      for (int p2 = Rows<D>::NRB - 1; p2 > q.rb; --p2)
        run = df_add(run, {TOT[2 * (p2 * D + x)], TOT[2 * (p2 * D + x) + 1]});
      for (int t = q.r1 - 1; t >= q.r0; --t) {
        const int o = t * PS + x;
        dw[row0 + t * ts + x] = df_float(df_add(run, {AI[o], V2[o]})) / W[o];
        run = df_add(run, {DRAS[o], DVS[o]});
      }
      if (q.rb == 0) {
        float part = 0.f;
        for (int p2 = 0; p2 < Rows<D>::NRB; ++p2) part += DUP[p2 * D + x];
        const float y = part - du_c, sum = du + y;
        du_c = (sum - du) - y;
        du = sum;
      }
    }
    fence_async_shared();  // this step's reads before the copies refill
  }
  if (tid < D) du_part[(bh * NG + g) * D + tid] = du;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A 4-D fp32 map over (D, H, T, B), packed; boxes of `cols` columns x
// `rows` rows of one head, landing as `rows` rows of `cols` floats (rows
// past T zero-filled).
bool encode_f32(CUtensorMap* map, const void* ptr, int D, int H, int T,
                int B, int cols, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {4ull * D, 4ull * H * D, 4ull * T * H * D};
  cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D fp32 map over the chunk-start states (D, D, NC, B H), packed;
// one box a chunk's state, rows padded to D + 4 floats (zero-filled).
bool encode_states(CUtensorMap* map, const void* ptr, int D, int NC,
                   int BH) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)D, (cuuint64_t)NC,
                        (cuuint64_t)BH};
  cuuint64_t strides[3] = {4ull * D, 4ull * D * D, 4ull * D * D * NC};
  cuuint32_t box[4] = {(cuuint32_t)D + 4, (cuuint32_t)D, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const float *r, *k, *v, *w, *u, *states, *dy, *dsT;
  float *dr, *dk, *dv, *dw, *du_part, *ds0, *ckpt;
  int B, T, H, C, G, DV;
  cudaStream_t stream;
};

// the body's layout: two stages holding S where they fit (C <= 32 at D =
// 64), else one stage with S read from memory
BodyLayout body_layout(int D, int C) {
  const BodyLayout two(D, C, true);
  return two.bytes() <= SMEM_MAX ? two : BodyLayout(D, C, false);
}

template <int D, int DV, bool TMA>
int launch_chain(const Args& a, const CUtensorMap* maps) {
  static bool opted_in = false;  // above 48 KB only as opted-in memory
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_bwd_chain<D, DV, TMA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  rwkv6_bwd_chain<D, DV, TMA>
      <<<dim3(D / DV, a.H, a.B), THREADS, ChainLayout(D, DV, a.C).bytes(),
         a.stream>>>(a.r, a.w, a.dy, a.dsT, a.ckpt, a.ds0, a.T, a.H, a.C,
                     a.G, maps[5], maps[6], maps[7]);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool TMA>
int launch_body(const Args& a, const CUtensorMap* maps) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_bwd_body<D, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const BodyLayout L = body_layout(D, a.C);
  const int NG = (a.T / a.C + a.G - 1) / a.G;
  rwkv6_bwd_body<D, TMA><<<dim3(NG, a.H, a.B), THREADS, L.bytes(), a.stream>>>(
      a.r, a.k, a.v, a.w, a.u, a.states, a.dy, a.ckpt, a.dr, a.dk, a.dv, a.dw,
      a.du_part, a.T, a.H, a.C, a.G, L.staged, maps[0], maps[1],
      maps[2], maps[3], maps[4], maps[8]);
  return static_cast<int>(cudaGetLastError());
}

// The chain at (D, DV), then the body; maps: the body's r, k, v, w, dy
// (boxes of C rows x D + 4 columns), the chain's r, w (a block's rows x
// D) and dy block (a block's rows x DV), the body's states.
template <int D, bool TMA>
int launch(const Args& a) {
  CUtensorMap maps[9] = {};
  if (TMA) {
    const void* src[5] = {a.r, a.k, a.v, a.w, a.dy};
    const int rows = chain_chunks(a.C) * a.C;
    for (int i = 0; i < 5; ++i)
      if (!encode_f32(&maps[i], src[i], D, a.H, a.T, a.B, D + 4, a.C))
        return -2;
    if (!(encode_f32(&maps[5], a.r, D, a.H, a.T, a.B, D, rows) &&
          encode_f32(&maps[6], a.w, D, a.H, a.T, a.B, D, rows) &&
          encode_f32(&maps[7], a.dy, D, a.H, a.T, a.B, a.DV, rows) &&
          encode_states(&maps[8], a.states, D, a.T / a.C, a.B * a.H)))
      return -2;
  }
  int err = -1;
#define RWKV6_BWD_CHAIN(d, dv)                                               \
  if (D == d && a.DV == dv) err = launch_chain<d, dv, TMA>(a, maps);
  RWKV6_BWD_CHAIN(16, 16)
  RWKV6_BWD_CHAIN(32, 16)
  RWKV6_BWD_CHAIN(32, 32)
  RWKV6_BWD_CHAIN(64, 16)
  RWKV6_BWD_CHAIN(64, 32)
  RWKV6_BWD_CHAIN(64, 64)
#undef RWKV6_BWD_CHAIN
  if (err != 0) return err;
  return launch_body<D, TMA>(a, maps);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Every tensor contiguous fp32: r, k, v, w, dy, dr, dk, dv, dw (B, T, H,
// D); u (H, D); states (B, H, T / C, D, D), the forward's chunk-start
// states, 16-byte aligned; dsT and ds0 (B, H, D, D); ckpt (B, H, NG, D, D)
// and du_part (B, H, NG, D), NG = ceil(T / C / G): the chain's checkpoints
// and the body's partials of du, one a (batch, head, group).  G: the
// chunks a body CTA walks (`groups` in the wrapper); DV: the value columns
// a chain CTA owns (`chain_split`); tma 1 to load by TMA (the wrapper's
// `aligned` rule), 0 by 4-byte cp.async copies.  Returns the cudaError_t
// of the first launch that failed (0 = cudaSuccess), -1 for a shape this
// file does not take (the Python wrapper checks first), -2 when a tensor
// map cannot be encoded.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* states, const void* dy, const void* dsT,
    void* dr, void* dk, void* dv, void* dw, void* du_part, void* ds0,
    void* ckpt, int B, int T, int H, int D, int C, int G, int DV, int tma,
    void* stream) {
  if (B < 1 || T < 1 || H < 1 || C < 1 || C > MAX_C || T % C || G < 1 ||
      DV < 16 || DV > D || D % DV || !aligned16(states))
    return -1;
  if (tma && !(aligned16(r) && aligned16(k) && aligned16(v) &&
               aligned16(w) && aligned16(dy)))
    return -1;
  const Args a{static_cast<const float*>(r),
               static_cast<const float*>(k),
               static_cast<const float*>(v),
               static_cast<const float*>(w),
               static_cast<const float*>(u),
               static_cast<const float*>(states),
               static_cast<const float*>(dy),
               static_cast<const float*>(dsT),
               static_cast<float*>(dr),
               static_cast<float*>(dk),
               static_cast<float*>(dv),
               static_cast<float*>(dw),
               static_cast<float*>(du_part),
               static_cast<float*>(ds0),
               static_cast<float*>(ckpt),
               B, T, H, C, G, DV,
               static_cast<cudaStream_t>(stream)};
#define RWKV6_BWD_CASE(d)                                                    \
  if (D == d) return tma ? launch<d, true>(a) : launch<d, false>(a);
  RWKV6_BWD_CASE(16)
  RWKV6_BWD_CASE(32)
  RWKV6_BWD_CASE(64)
#undef RWKV6_BWD_CASE
  return -1;
}
