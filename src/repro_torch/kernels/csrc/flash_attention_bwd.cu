// Flash attention backward for Hopper (sm_90a): dQ, dK, dV of the forward
// in flash_attention.cu (causal / sliding window / full, Sq != Skv, GQA,
// tanh softcap), bf16 in and out, fp32 accumulators.
//
// The Pallas package has no backward kernel (its train step differentiates
// the blockwise jnp attention, src/repro/models/attention.py:97); this is
// the port's own, behind the `FlashAttention` autograd function of
// kernels/flash_attention.py.  It recomputes the probabilities from the
// forward's row log-sum-exp (LSE, in the scaled and softcapped score domain
// the forward uses):
//   x    = s * scale, or c * tanh(s * scale / c) under a softcap c
//   p    = exp(x - lse), 0 where the forward masks
//   dV   = P^T dO            dP = dO V^T
//   dX   = P o (dP - delta), delta = rowsum(dO o O)
//   dS   = dX * scale, times (1 - tanh^2) under a softcap
//   dQ   = dS K              dK = dS^T Q
//
// What bounds it on this card: tensor-core throughput.  At llama-1.5b's
// causal S 1536 the five products (2.5x the forward's two) are 24 GFLOP
// against ~31 MB of traffic, far above the ~295 FLOP/byte ridge.  The two
// kernels below issue seven (S and dP are computed in both), the price of
// a dQ summed without atomics.  Three kernels a call, in stream order:
//   * bwd_delta: delta = rowsum(dO o O) and lse2 = lse * log2(e) for each
//     (batch, head, row), fp32, into a workspace padded to whole 128-row
//     tiles (lse2 = 1e30 and delta = 0 past Sq, so p = 0 there with no
//     compare); a group of lanes a row, 16-byte loads;
//   * dkdv_wgmma (D 64, 128): one CTA a (batch, kv head, key tile).  It
//     walks the G query heads of its group and, per head, the 64-row query
//     tiles that meet its keys (the forward's band), in a fixed order.
//     S^T = K Q^T and dP^T = V dO^T are SS wgmma (K and V resident; Q and
//     dO K-major); P^T and dS^T, computed in the accumulators' registers
//     and packed to bf16, are already the A fragments of dV += P^T dO and
//     dK += dS^T Q (RS wgmma, dO and Q MN-major through the descriptor's
//     transpose bit), so neither touches shared memory.  dK and dV stay in
//     registers.  A key tile is 128 keys, a warpgroup's 64 each, or, where
//     that grid would give the card's SMs fewer than two CTAs each (B 1),
//     64 keys, both warpgroups on them taking the steps in turn and summing
//     dK and dV through shared memory at the end (twice the CTAs, half the
//     heaviest CTA's steps);
//   * dq_wgmma (D 64, 128): one CTA a (batch, head, 128-row query tile),
//     two warpgroups of 64 rows walking the 64-key tiles of the band.  Its
//     Q and dO rows, read once into registers, are the A fragments of
//     S = Q K^T and dP = dO V^T (RS, K and V K-major), then dQ += dS K
//     (RS, K MN-major): shared memory holds only the K and V ring.
// In both, thread 0 is also the producer (the forward's header says why
// there is no producer warp): it keeps a ring of stages in flight through
// TMA (dK/dV: Q, dO and, by bulk copy, their 64 lse2 and delta values; dQ:
// K and V), signalled by mbarriers (full: the bytes landed; empty: the
// consuming warps are done with the stage), and refills a stage two steps
// after its use, so copies overlap the products.  The two warpgroups run
// unsynchronised, so one's elementwise pass (ex2, dS) runs while the
// other's products are in flight; without a softcap a dK/dV warpgroup
// also makes P while its own dP product runs, and at D 64 issues dV's
// product before making dS.  The tensor maps are 4-D over the (B, S,
// heads, D) tensors, 64-row boxes, 128-byte swizzled; rows past the end
// are zero-filled by the hardware, and a 64-row block wholly past it is
// not loaded.  Causal grids are issued heaviest tile first (dK/dV: key
// tile 0 first; dQ: the last query tile first); tiles outside the band
// are never loaded, a warpgroup whose 64 rows lie wholly outside it skips
// the tile's products, and only tiles that cross the band's edge (in dQ
// also the end of the keys) pay for the mask.
//
// Deterministic: every sum runs in a fixed order inside one CTA and nothing
// is added atomically, so a second call gives the same bits (the
// determinism a restart from a checkpoint and remat's recompute rest on).
//
// Head dims 160 and 256 keep the mma.sync design (dkdv_mma, dq_mma): a
// warpgroup's dK + dV accumulators alone would be D registers a thread (192
// for D 160, padded to whole 64-column boxes, and 256), past the 255 a
// thread may hold beside S and dP.  There one CTA of four warps takes
// (kv head, 64 keys) or (head, 64 rows), tiles come by cp.async, and a
// head dim wider than one chunk walks DC-column chunks, recomputing S and
// dP for each (D 256: four dK/dV chunks of 64, two dQ chunks of 128).
#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
// the lse2 of a row past the end: p = 2^(x sl - BIG) is 0
constexpr float BIG = 1e30f;

// The workspace: ws[w] = lse2 and ws[rows + w] = delta of row i of head h,
// w = (b H + h) SqP + i, SqP = Sq rounded up to 128.
__host__ __device__ __forceinline__ int padded(int Sq) {
  return (Sq + 127) / 128 * 128;
}

// A group of GS lanes a row of the workspace, each lane 16-byte chunks of O
// and dO (GS: the row's D / 8 chunks, rounded up to a power of two).
template <int D>
__global__ void bwd_delta(const bf16* __restrict__ o,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ ws, int rows, int Sq, int H) {
  constexpr int CH = D / 8;
  constexpr int GS = CH <= 8 ? 8 : CH <= 16 ? 16 : 32;
  const int id = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = id / GS, lane = id % GS;
  const int SqP = padded(Sq), bh = w / SqP, i = w % SqP;
  float acc = 0.f;
  if (w < rows && i < Sq) {
    const long long at =
        ((static_cast<long long>(bh / H) * Sq + i) * H + bh % H) * D;
    for (int c = lane; c < CH; c += GS) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + at + 8 * c);
      const uint4 y = *reinterpret_cast<const uint4*>(dout + at + 8 * c);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(xp[e]);
        const float2 b = __bfloat1622float2(yp[e]);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
      }
    }
  }
#pragma unroll
  for (int m = GS / 2; m >= 1; m /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (w < rows && lane == 0) {
    ws[w] = i < Sq ? lse[static_cast<long long>(bh) * Sq + i] * LOG2E : BIG;
    ws[rows + w] = acc;
  }
}

// ---- the wgmma design: D 64 and 128 ----------------------------------------
constexpr int THREADS = 256;         // two warpgroups; thread 0 produces too
constexpr int ROW_BYTES = 128;       // one swizzled row: 64 bf16
constexpr int BOX = 64 * ROW_BYTES;  // one TMA box: 64 rows x 64 columns

// Shared memory of the dK/dV kernel, from a 1024-byte aligned base: K and
// V of the CTA's KEYS keys (64-row tiles), then a ring of ST stages: Q and
// dO tiles of 64 rows (RA, RB) and their lse2[64] and delta[64] (VEC).  A
// tile is HALVES boxes, one a 64-column half of the head dim.  As many
// stages as ~200 KB holds, at most 8.
template <int D, int KEYS>
struct DkdvSmem {
  static constexpr int HALVES = D / 64;
  static constexpr int TILE = HALVES * BOX;
  static constexpr int FIX = KEYS / 64 * TILE;
  static constexpr int FIT = (200 * 1024 - 2 * FIX) / (2 * TILE + 512);
  static constexpr int ST = FIT < 8 ? FIT : 8;
  static constexpr int K = 0, V = FIX, RA = 2 * FIX;
  static constexpr int RB = RA + ST * TILE;
  static constexpr int VEC = RB + ST * TILE;
  static constexpr int BAR = VEC + ST * 512;
  // K and V landed, full[ST], empty[ST]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * ST);
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
  static_assert(ALLOC <= 232448, "past the 227 KB a CTA may use");
  static_assert(ST >= 3, "the refill rule needs three stages");
  static_assert(KEYS == 128 || 2 * 64 * D * 4 <= 2 * ST * TILE,
                "the warpgroups' halves of the sum past the ring");
};

// x (the forward's score: s * scale, or c tanh(s scale / c)) to p = 2^(x sl
// - lse2); th keeps tanh for the softcap's derivative
__device__ __forceinline__ float prob(float s, float sl, float lse2,
                                      float softcap, float scale, float& th) {
  float x = s;
  th = 0.f;
  if (softcap > 0.f) {
    th = tanhf(x * scale / softcap);
    x = th * softcap;
  }
  return ex2(fmaf(x, sl, -lse2));
}

// KEYS = 128: the CTA's two warpgroups own 64 keys each and walk every
// step.  KEYS = 64: both own the same 64 keys and take the steps in turn
// (even steps the first, odd the second); their dK and dV are summed
// through shared memory at the end.  A step is one 64-row query tile of one
// of the group's G heads.
template <int D, int KEYS>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
           const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap,
           const __grid_constant__ CUtensorMap omap,
           const float* __restrict__ ws, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int B, int Sq, int Skv, int H, int G,
           int causal, int window, float softcap, float scale) {
  using L = DkdvSmem<D, KEYS>;
  constexpr int ACC = D / 2, ST = L::ST;  // dK or dV: 64 keys x D
  constexpr bool SHARED = KEYS == 64;     // both warpgroups on one block
  // D 64: dV's product runs while dS is made (at D 128 the extra live
  // registers cost more than the overlap)
  constexpr bool EARLY_DV = D == 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_p = smem_raw + (base - raw);
  const float* vec = reinterpret_cast<const float*>(base_p + L::VEC);
  const uint32_t bar0 = base + L::BAR;  // K and V landed
  auto full = [&](int s) { return bar0 + 8u * (1 + s); };
  auto empty = [&](int s) { return bar0 + 8u * (1 + ST + s); };
  auto q_s = [&](int s) { return base + L::RA + s * L::TILE; };
  auto o_s = [&](int s) { return base + L::RB + s * L::TILE; };

  const int KV = H / G, SqP = padded(Sq), n_qt = (Sq + 63) / 64;
  // key tile 0 first: under a causal mask it meets the most query tiles
  const int bk = blockIdx.x % (B * KV), kt = blockIdx.x / (B * KV);
  const int kvh = bk % KV, b = bk / KV, k0 = kt * KEYS;
  // query tiles that meet these keys: causal rows from k0 on, a window's
  // rows before the last key + window
  const int qt_begin = causal ? min(k0 / 64, n_qt) : 0;
  int qt_end = n_qt;
  if (window) qt_end = min(n_qt, (k0 + KEYS - 1 + window - 1) / 64 + 1);
  const int nq = max(0, qt_end - qt_begin), n = G * nq;
  const int kblocks = min(KEYS / 64, (Skv - k0 + 63) / 64);  // hold keys

  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), SHARED ? 4 : 8);  // each consuming warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread 0 is also the producer.  Step i: query tile qt_begin + i % nq of
  // the group's head i / nq.
  auto load_step = [&](int i) {
    const int st = i % ST, h = kvh * G + i / nq;
    const int q0 = (qt_begin + i % nq) * 64;
    mbar_expect_tx(full(st), 2 * L::TILE + 512);
    for (int hf = 0; hf < L::HALVES; ++hf) {
      tma_load(&qmap, q_s(st) + hf * BOX, full(st), hf * 64, q0, h, b);
      tma_load(&omap, o_s(st) + hf * BOX, full(st), hf * 64, q0, h, b);
    }
    const float* src = ws + (static_cast<long long>(b) * H + h) * SqP + q0;
    const uint32_t dst = base + L::VEC + st * 512;
    bulk_load(dst, src, 256, full(st));
    bulk_load(dst + 256, src + static_cast<long long>(B) * H * SqP, 256,
              full(st));
  };
  int next = min(ST, n);  // the next step thread 0 loads
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(bar0, 2 * kblocks * L::TILE);
    for (int r = 0; r < kblocks; ++r)
      for (int hf = 0; hf < L::HALVES; ++hf) {
        const uint32_t off = r * L::TILE + hf * BOX;
        tma_load(&kmap, base + L::K + off, bar0, hf * 64, k0 + 64 * r, kvh,
                 b);
        tma_load(&vmap, base + L::V + off, bar0, hf * 64, k0 + 64 * r, kvh,
                 b);
      }
    for (int i = 0; i < next; ++i) load_step(i);
  }

  // ---- each warpgroup: 64 keys ---------------------------------------------
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int a = k0 + (SHARED ? 0 : wg * 64);  // this warpgroup's first key
  const int key0 = a + warp * 16 + g, key1 = key0 + 8;
  const uint32_t kw = base + L::K + (SHARED ? 0 : wg * L::TILE);
  const uint32_t vw = base + L::V + (SHARED ? 0 : wg * L::TILE);
  const float sl = (softcap > 0.f ? 1.f : scale) * LOG2E;
  float dka[ACC], dva[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) dka[j] = dva[j] = 0.f;
  float s[32] = {}, dp[32] = {};
  uint32_t pa[4][4], da[4][4];

  if (n > 0) mbar_wait(bar0, 0);
  for (int i = SHARED ? wg : 0; i < n; i += SHARED ? 2 : 1) {
    // every step up to i - 2 is released or about to be (its warpgroup is
    // past it): refill those stages
    if (threadIdx.x == 0)
      for (; next < n && next - ST <= i - 2; ++next) {
        mbar_wait(empty(next % ST), ((next - ST) / ST) & 1);
        load_step(next);
      }
    const int st = i % ST, q0 = (qt_begin + i % nq) * 64;
    mbar_wait(full(st), (i / ST) & 1);
    const bool skip = a >= Skv || (causal && a > q0 + 63) ||
                      (window && q0 - (a + 63) >= window);
    if (!skip) {
      const uint32_t qs = q_s(st), os = o_s(st);
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 rows, D/16 k-steps of
      // 32 bytes into the swizzled rows
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        wgmma_ss_n64(s, make_desc(kw + off, 16, 1024),
                     make_desc(qs + off, 16, 1024), kk > 0);
      }
      wgmma_commit();  // S apart from dP: P is made while dP's runs
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        wgmma_ss_n64(dp, make_desc(vw + off, 16, 1024),
                     make_desc(os + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      // element j: key key0 (key1 for j & 2), query row q0 + col(j)
      const bool edge = (causal && a + 63 > q0) ||
                        (window && q0 + 63 - a >= window);
      const float* lv = vec + st * 128;
      auto p_at = [&](int j, float& th) {
        const int col = 8 * (j / 4) + 2 * t + (j & 1);
        float p = prob(s[j], sl, lv[col], softcap, scale, th);
        if (edge) {
          const int key = (j & 2) ? key1 : key0, row = q0 + col;
          bool ok = true;
          if (causal) ok = key <= row;
          if (window) ok = ok && key > row - window;
          p = ok ? p : 0.f;
        }
        return p;
      };
      auto delta_at = [&](int j) {
        return lv[64 + 8 * (j / 4) + 2 * t + (j & 1)];
      };
      // the A fragments of query step kk: accumulator tiles 2kk and 2kk + 1
      auto pack = [&](uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            f[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
      };
      // dV += P^T dO and dK += dS^T Q, dO and Q MN-major: a step 16 rows
      auto issue_dv = [&]() {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(dva, pa[kk],
                   make_desc(os + kk * 16 * ROW_BYTES, BOX, 1024));
      };
      auto issue_dk = [&]() {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(dka, da[kk],
                   make_desc(qs + kk * 16 * ROW_BYTES, BOX, 1024));
      };
      if (EARLY_DV && softcap == 0.f) {
        wgmma_wait<1>();  // S landed
        fence_regs(s);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          float th;
          s[j] = p_at(j, th);
        }
        pack(pa, s);
        fence_regs(dva);
        wgmma_fence();
        issue_dv();
        wgmma_commit();
        wgmma_wait<1>();  // dP landed
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 32; ++j)
          dp[j] = s[j] * (dp[j] - delta_at(j)) * scale;
        pack(da, dp);
        fence_regs(dka);
        wgmma_fence();
        issue_dk();
        wgmma_commit();
      } else {
        if (softcap == 0.f) {
          wgmma_wait<1>();  // S landed
          fence_regs(s);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            float th;
            s[j] = p_at(j, th);
          }
          wgmma_wait<0>();
          fence_regs(dp);
#pragma unroll
          for (int j = 0; j < 32; ++j)
            dp[j] = s[j] * (dp[j] - delta_at(j)) * scale;
        } else {
          // the softcap's derivative needs each score's tanh: one pass
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            float th;
            const float p = p_at(j, th);
            float ds = p * (dp[j] - delta_at(j)) * scale;
            if (softcap > 0.f) ds *= 1.f - th * th;
            s[j] = p;
            dp[j] = ds;
          }
        }
        pack(pa, s);
        pack(da, dp);
        fence_regs(dka);
        fence_regs(dva);
        wgmma_fence();
        issue_dv();
        issue_dk();
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // dk, dv are fresh contiguous (B, Skv, KV, D) tensors: keys key0, key1,
  // columns 8d + 2t
  auto store = [&](bf16* out, const float (&acc)[ACC]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = half ? key1 : key0;
      if (key >= Skv) continue;
      const long long row =
          ((static_cast<long long>(b) * Skv + key) * KV + kvh) * D;
#pragma unroll
      for (int d = 0; d < ACC / 4; ++d)
        *reinterpret_cast<uint32_t*>(out + row + 8 * d + 2 * t) =
            pack_bf16(acc[4 * d + 2 * half], acc[4 * d + 2 * half + 1]);
    }
  };
  if constexpr (SHARED) {
    // dK = the first warpgroup's + the second's, dV the same: each hands
    // the other one half through the ring (every copy has landed), in its
    // fragment layout, which is the other's too
    __syncthreads();
    float* xk = reinterpret_cast<float*>(base_p + L::RA);
    float* xv = xk + 64 * D;
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      if (wg == 1) xk[j * 128 + tid] = dka[j];
      else xv[j * 128 + tid] = dva[j];
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < ACC; ++j) dka[j] += xk[j * 128 + tid];
      store(dk, dka);
    } else {
#pragma unroll
      for (int j = 0; j < ACC; ++j) dva[j] += xv[j * 128 + tid];
      store(dv, dva);
    }
  } else {
    store(dk, dka);
    store(dv, dva);
  }
}

// Shared memory of the dQ kernel, from a 1024-byte aligned base: a ring of
// ST stages of K (RA) and V (RB) tiles of 64 keys, as many as ~200 KB
// holds, at most 8.
template <int D>
struct DqSmem {
  static constexpr int HALVES = D / 64;
  static constexpr int TILE = HALVES * BOX;
  static constexpr int FIT = (200 * 1024) / (2 * TILE);
  static constexpr int ST = FIT < 8 ? FIT : 8;
  static constexpr int RA = 0, RB = ST * TILE, BAR = 2 * ST * TILE;
  static constexpr int BYTES = BAR + 8 * 2 * ST;  // full[ST], empty[ST]
  static constexpr int ALLOC = BYTES + 1024;      // room to align the base
};

// Q and dO, read once, stay in registers as the A fragments of S = Q K^T
// and dP = dO V^T: those are RS products, and shared memory holds only the
// ring of K and V.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dq_wgmma(const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ q,
         const bf16* __restrict__ dout, const float* __restrict__ ws,
         bf16* __restrict__ dq, int B, int Sq, int Skv, int H, int G,
         int causal, int window, float softcap, float scale) {
  using L = DqSmem<D>;
  constexpr int ACC = D / 2, ST = L::ST;  // dQ: 64 rows x D a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar0 = base + L::BAR;
  auto full = [&](int s) { return bar0 + 8u * s; };
  auto empty = [&](int s) { return bar0 + 8u * (ST + s); };
  auto k_s = [&](int s) { return base + L::RA + s * L::TILE; };
  auto v_s = [&](int s) { return base + L::RB + s * L::TILE; };

  // the last query tile first: under a causal mask it meets the most keys
  const int SqP = padded(Sq), n_qt = SqP / 128;
  const int bh = blockIdx.x % (B * H);
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / (B * H));
  const int h = bh % H, b = bh / H, kvh = h / G, q0 = qt * 128;
  // the forward's band
  int kt_end = (Skv + 63) / 64;
  if (causal) kt_end = min(kt_end, (min(q0 + 128, Sq) - 1) / 64 + 1);
  const int kt_begin = window ? max(0, q0 - window + 1) / 64 : 0;
  const int n = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread 0 is also the producer.
  auto load_kv = [&](int i) {
    const int st = i % ST, k0 = (kt_begin + i) * 64;
    mbar_expect_tx(full(st), 2 * L::TILE);
    for (int hf = 0; hf < L::HALVES; ++hf) {
      tma_load(&kmap, k_s(st) + hf * BOX, full(st), hf * 64, k0, kvh, b);
      tma_load(&vmap, v_s(st) + hf * BOX, full(st), hf * 64, k0, kvh, b);
    }
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(ST, n); ++i) load_kv(i);

  // ---- each warpgroup: 64 query rows ---------------------------------------
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int a = q0 + wg * 64;  // this warpgroup's first row
  const int r0 = a + warp * 16 + g, r1 = r0 + 8;
  const long long at = (static_cast<long long>(b) * H + h) * SqP;
  const long long plane = static_cast<long long>(B) * H * SqP;
  const float l0 = ws[at + r0], l1 = ws[at + r1];
  const float d0 = ws[plane + at + r0], d1 = ws[plane + at + r1];
  // Q and dO rows r0, r1 as A fragments: k-step kk holds columns 16kk + 2t
  // (+1) and 16kk + 8 + 2t (+1); rows past Sq are 0 (and their p, by the
  // padded lse2, is 0)
  uint32_t qa[D / 16][4], oa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? r1 : r0;
      const long long off =
          ((static_cast<long long>(b) * Sq + row) * H + h) * D + 16 * kk +
          2 * t + (i & 2) * 4;
      qa[kk][i] = row < Sq ? *reinterpret_cast<const uint32_t*>(q + off) : 0u;
      oa[kk][i] =
          row < Sq ? *reinterpret_cast<const uint32_t*>(dout + off) : 0u;
    }
  const float sl = (softcap > 0.f ? 1.f : scale) * LOG2E;
  float dqa[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) dqa[j] = 0.f;
  float s[32] = {}, dp[32] = {};
  uint32_t da[4][4];

  for (int i = 0; i < n; ++i) {
    // refill the stage of step i - 2, which both warpgroups released a step
    // ago, with step i - 2 + ST
    if (threadIdx.x == 0 && i >= 2 && i - 2 + ST < n) {
      mbar_wait(empty((i - 2) % ST), ((i - 2) / ST) & 1);
      load_kv(i - 2 + ST);
    }
    const int st = i % ST, k0 = (kt_begin + i) * 64;
    mbar_wait(full(st), (i / ST) & 1);
    const bool skip = a >= Sq || (causal && k0 > a + 63) ||
                      (window && a - (k0 + 63) >= window);
    if (!skip) {
      const uint32_t ks = k_s(st), vs = v_s(st);
      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys, K and V K-major
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs_n64_k(s, qa[kk],
                       make_desc(ks + (kk / 4) * BOX + (kk % 4) * 32, 16,
                                 1024),
                       kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs_n64_k(dp, oa[kk],
                       make_desc(vs + (kk / 4) * BOX + (kk % 4) * 32, 16,
                                 1024),
                       kk > 0);
      wgmma_commit();
      // dS.  Element j: row r0 (r1 for j & 2), key k0 + 8 (j / 4) + 2t (+1
      // for odd j)
      const bool edge = k0 + 64 > Skv || (causal && k0 + 63 > a) ||
                        (window && a + 63 - k0 >= window);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float th;
        float p = prob(s[j], sl, (j & 2) ? l1 : l0, softcap, scale, th);
        if (edge) {
          const int row = (j & 2) ? r1 : r0;
          const int key = k0 + 8 * (j / 4) + 2 * t + (j & 1);
          bool ok = key < Skv;
          if (causal) ok = ok && key <= row;
          if (window) ok = ok && key > row - window;
          p = ok ? p : 0.f;
        }
        float ds = p * (dp[j] - ((j & 2) ? d1 : d0)) * scale;
        if (softcap > 0.f) ds *= 1.f - th * th;
        dp[j] = ds;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      // dQ += dS K, K MN-major: a step 16 keys
      fence_regs(dqa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dqa, da[kk], make_desc(ks + kk * 16 * ROW_BYTES, BOX, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // dq is a fresh contiguous (B, Sq, H, D) tensor
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? r1 : r0;
    if (row >= Sq) continue;
    bf16* out = dq + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < ACC / 4; ++d)
      *reinterpret_cast<uint32_t*>(out + 8 * d + 2 * t) =
          pack_bf16(dqa[4 * d + 2 * half], dqa[4 * d + 2 * half + 1]);
  }
}

// ---- the mma.sync design: D 160 and 256 -------------------------------------
constexpr int MMA_ROWS = 64;     // query rows and keys a tile
constexpr int MMA_THREADS = 128;  // four warps of 16 rows

template <int D>
struct MmaTile {
  static constexpr int LD = D + 8;                  // smem row, bf16
  static constexpr int DC_KV = D == 160 ? 80 : 64;  // dK/dV chunk
  static constexpr int DC_Q = D == 256 ? 128 : D;   // dQ chunk
  static constexpr int ELEMS = 64 * LD;             // one tile
  static constexpr int BYTES = 4 * ELEMS * 2 + 2 * 64 * 4;
  static_assert(D % 16 == 0 && DC_KV % 16 == 0 && DC_Q % 16 == 0, "");
};

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
  for (int i = threadIdx.x; i < 64 * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i % CH, row = r0 + r;
    const bf16* g =
        src + ((static_cast<long long>(b) * S + min(row, S - 1)) * heads + head) *
                  D + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_u32(dst + r * MmaTile<D>::LD + c * 8)),
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
                                        float lse2, float delta) const {
    float x = s, t = 0.f;
    if (softcap > 0.f) {
      t = tanhf(x * scale / softcap);
      x = t * softcap;
    }
    bool ok = row < Sq && col < Skv;
    if (causal) ok = ok && col <= row;
    if (window) ok = ok && col > row - window;
    const float p = ok ? ex2(fmaf(x, sl, -lse2)) : 0.f;
    float ds = p * (dp - delta) * scale;
    if (softcap > 0.f) ds *= 1.f - t * t;
    s = p;
    dp = ds;
  }
};

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, const bf16* __restrict__ dout,
         const float* __restrict__ ws, bf16* __restrict__ dk,
         bf16* __restrict__ dv, int B, int Sq, int Skv, int H, int G,
         int causal, int window, float softcap, float scale) {
  using T = MmaTile<D>;
  constexpr int LD = T::LD, DC = T::DC_KV, BQ = MMA_ROWS, BK = MMA_ROWS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + T::ELEMS;
  bf16* q_s = v_s + T::ELEMS;
  bf16* o_s = q_s + T::ELEMS;  // dO
  float* lse_s = reinterpret_cast<float*>(o_s + T::ELEMS);
  float* dl_s = lse_s + 64;
  const uint32_t ku = smem_u32(k_s), vu = smem_u32(v_s), qu = smem_u32(q_s),
                 ou = smem_u32(o_s);

  const int KV = H / G, SqP = padded(Sq);
  const long long plane = static_cast<long long>(B) * H * SqP;
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
        for (int i = threadIdx.x; i < 64; i += MMA_THREADS) {
          const long long at = (static_cast<long long>(b) * H + h) * SqP + q0 + i;
          lse_s[i] = ws[at];
          dl_s[i] = ws[plane + at];
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
__global__ void __launch_bounds__(MMA_THREADS)
dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, const bf16* __restrict__ dout,
       const float* __restrict__ ws, bf16* __restrict__ dq, int B, int Sq,
       int Skv, int H, int G, int causal, int window, float softcap,
       float scale) {
  using T = MmaTile<D>;
  constexpr int LD = T::LD, DC = T::DC_Q, BQ = MMA_ROWS, BK = MMA_ROWS;
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
  const int SqP = padded(Sq);
  const long long at = (static_cast<long long>(b) * H + h) * SqP;
  const long long plane = static_cast<long long>(B) * H * SqP;
  const float lse0 = ws[at + r0], lse1 = ws[at + r1];
  const float dl0 = ws[plane + at + r0], dl1 = ws[plane + at + r1];

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
// ---- host side ---------------------------------------------------------------
// The dK/dV CTA's keys set by flash_attention_bwd_set_keys (0: the rule).
int forced_keys = 0;

// The dK/dV CTA's keys: 64 where 128-key CTAs would give the card's SMs
// fewer than two each (a short grid leaves SMs idle, and its heaviest CTA
// sets the time), else 128 (fewer CTAs load each Q and dO tile); 0 when
// the card's SM count cannot be read.  scripts/flash_bwd_designs.py
// times both at the same shapes.
int dkdv_keys(int B, int Skv, int KV) {
  if (forced_keys) return forced_keys;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return (Skv + 127) / 128 * B * KV < 2 * sms ? 64 : 128;
}

template <int D>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v,
                 const bf16* dout, const float* ws, bf16* dq, bf16* dk,
                 bf16* dv, int B, int Sq, int Skv, int H, int KV, int causal,
                 int window, float softcap, float scale, cudaStream_t stream) {
  const long long sq[3] = {(long long)Sq * H * D, (long long)H * D, D};
  const long long sk[3] = {(long long)Skv * KV * D, (long long)KV * D, D};
  CUtensorMap qm, km, vm, om;
  if (!encode(&qm, q, D, Sq, H, B, sq, 64) ||
      !encode(&om, dout, D, Sq, H, B, sq, 64) ||
      !encode(&km, k, D, Skv, KV, B, sk, 64) ||
      !encode(&vm, v, D, Skv, KV, B, sk, 64))
    return -2;
  static bool attr = false;
  if (!attr) {
    const cudaFuncAttribute smem = cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaError_t e =
        cudaFuncSetAttribute(dkdv_wgmma<D, 128>, smem, DkdvSmem<D, 128>::ALLOC);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dkdv_wgmma<D, 64>, smem,
                               DkdvSmem<D, 64>::ALLOC);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_wgmma<D>, smem, DqSmem<D>::ALLOC);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int G = H / KV, keys = dkdv_keys(B, Skv, KV);
  if (!keys) return -3;
  if (keys == 64)
    dkdv_wgmma<D, 64><<<(Skv + 63) / 64 * B * KV, THREADS,
                        DkdvSmem<D, 64>::ALLOC, stream>>>(
        qm, km, vm, om, ws, dk, dv, B, Sq, Skv, H, G, causal, window,
        softcap, scale);
  else
    dkdv_wgmma<D, 128><<<(Skv + 127) / 128 * B * KV, THREADS,
                         DkdvSmem<D, 128>::ALLOC, stream>>>(
        qm, km, vm, om, ws, dk, dv, B, Sq, Skv, H, G, causal, window,
        softcap, scale);
  dq_wgmma<D><<<padded(Sq) / 128 * B * H, THREADS, DqSmem<D>::ALLOC,
                stream>>>(km, vm, q, dout, ws, dq, B, Sq, Skv, H, G, causal,
                          window, softcap, scale);
  return 0;
}

template <int D>
int launch_mma(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const float* ws, bf16* dq, bf16* dk, bf16* dv, int B, int Sq,
               int Skv, int H, int KV, int causal, int window, float softcap,
               float scale, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MmaTile<D>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_mma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MmaTile<D>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int G = H / KV;
  const int n_kt = (Skv + MMA_ROWS - 1) / MMA_ROWS;
  const int n_qt = (Sq + MMA_ROWS - 1) / MMA_ROWS;
  dkdv_mma<D><<<n_kt * B * KV, MMA_THREADS, MmaTile<D>::BYTES, stream>>>(
      q, k, v, dout, ws, dk, dv, B, Sq, Skv, H, G, causal, window, softcap,
      scale);
  dq_mma<D><<<n_qt * B * H, MMA_THREADS, MmaTile<D>::BYTES, stream>>>(
      q, k, v, dout, ws, dq, B, Sq, Skv, H, G, causal, window, softcap,
      scale);
  return 0;
}

template <int D>
void launch_delta(const void* o, const void* dout, const void* lse, void* ws,
                  int rows, int Sq, int H, cudaStream_t stream) {
  constexpr int GS = D / 8 <= 8 ? 8 : D / 8 <= 16 ? 16 : 32;
  const long long threads = static_cast<long long>(rows) * GS;
  bwd_delta<D><<<(threads + 255) / 256, 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(ws), rows, Sq, H);
}

}  // namespace

// The design of a call: the dK/dV kernel's keys a CTA (128 or 64) for the
// wgmma head dims, 0 for the mma.sync ones, -1 for a head dim this file was
// not built for, -3 when the card's SM count cannot be read.
extern "C" int flash_attention_bwd_design(int B, int Skv, int KV, int D) {
  if (D == 64 || D == 128) {
    const int keys = dkdv_keys(B, Skv, KV);
    return keys ? keys : -3;
  }
  return D == 160 || D == 256 ? 0 : -1;
}

// Sets the wgmma dK/dV kernel's keys a CTA for every later call: 64 or 128,
// or 0 for the grid rule of dkdv_keys (what a caller gets unless it asks;
// a timing of the two designs at one shape sets it).  Returns 0, or -1 for
// another value.
extern "C" int flash_attention_bwd_set_keys(int keys) {
  if (keys != 0 && keys != 64 && keys != 128) return -1;
  forced_keys = keys;
  return 0;
}

// The workspace's rows a (batch, head): Sq rounded up to a whole 128-row
// tile (the caller allocates ws as (2, B, H, rows)).
extern "C" int flash_attention_bwd_workspace_rows(int Sq) {
  return padded(Sq);
}

// Every tensor contiguous: q, o, dout, dq (B, Sq, H, D); k, v, dk, dv
// (B, Skv, KV, D), bf16, 16-byte aligned; lse (B, H, Sq) fp32; the
// workspace ws (2, B, H, SqP) fp32, SqP = flash_attention_bwd_workspace_rows.
// Returns the cudaError_t of the launches (0 = cudaSuccess); -1 for a head
// dim this file was not built for, -2 when a tensor map cannot be encoded,
// -3 when the card's SM count cannot be read.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ws, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int KV, int D, int causal,
    int window, float softcap, float scale, void* stream) {
  if (D != 64 && D != 128 && D != 160 && D != 256) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * H * padded(Sq);
#define ARGS                                                                 \
  static_cast<const bf16*>(q), static_cast<const bf16*>(k),                  \
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),           \
      static_cast<const float*>(ws), static_cast<bf16*>(dq),                 \
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Skv, H, KV,     \
      causal, window, softcap, scale, s
  int err = 0;
  if (D == 64) {
    launch_delta<64>(o, dout, lse, ws, rows, Sq, H, s);
    err = launch_wgmma<64>(ARGS);
  } else if (D == 128) {
    launch_delta<128>(o, dout, lse, ws, rows, Sq, H, s);
    err = launch_wgmma<128>(ARGS);
  } else if (D == 160) {
    launch_delta<160>(o, dout, lse, ws, rows, Sq, H, s);
    err = launch_mma<160>(ARGS);
  } else {
    launch_delta<256>(o, dout, lse, ws, rows, Sq, H, s);
    err = launch_mma<256>(ARGS);
  }
#undef ARGS
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}
