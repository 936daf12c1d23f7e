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
// With a non-null `lse` the kernel also writes each row's log-sum-exp,
// m + log(l) in the scaled (and softcapped) score domain, (B, H, Sq) fp32,
// for the backward kernel (flash_attention_bwd.cu); the store is one branch
// after O's, so O is the same bits with or without it.
// P is rounded to bf16 before P V, as the reference rounds it to v.dtype;
// l sums the unrounded p.  The softmax runs in the log2 domain (ex2).
// Head dims 160 (stablelm-12b) and 256 (gemma3-4b) run the same design
// on a padded tile (Tile<D>): D = 160 is three 64-column boxes, the third
// half past the row's end, which TMA fills with zeros, so Q K^T takes
// only the ten k-steps that hold data and P V computes 32 zero columns
// that are never stored; both take 64-key tiles (S and P in half the
// registers, so O of 96 or 128 registers fits without spills), O is
// issued as one n64 product per 64-column box of V, and D = 256 keeps
// two K/V stages (Q 64 KB + 2 x 64 KB of K and V in 227 KB).
#include "hopper.cuh"

namespace {

constexpr int BQ = 128;       // query rows per CTA: two warpgroups of 64
// two warpgroups; a CTA of more warps (a producer warp beside them) is
// allocated registers for 12 warps, which caps a thread at 168 registers,
// too few for S, O and P in flight together (spills)
constexpr int THREADS = 256;
constexpr int ROW_BYTES = 128;  // one swizzled row: 64 bf16
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The tiling of each head dim.  DP: the head dim padded to whole 64-column
// boxes (TMA fills a box's columns past D with zeros, so Q K^T takes only
// the D / 16 k-steps that hold data and P V writes zero columns that are
// never stored).  D = 160 and 256 take 64-key tiles: at BK = 128 their S
// and O accumulators with P would pass 255 registers, and at D = 256 a
// third stage of 64 KB tiles would pass the 227 KB of shared memory.
template <int D>
struct Tile {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int BK = D <= 128 ? 128 : 64;   // keys per K/V tile
  static constexpr int STAGES = D <= 192 ? 3 : 2;  // K/V ring depth
};

// Shared memory, from a 1024-byte aligned base: Q (HALVES boxes of BQ rows),
// then STAGES K tiles, STAGES V tiles (HALVES boxes of BK rows each), then
// the mbarriers.  A box is rows of 64 bf16, 128-byte swizzled by TMA.
template <int D>
struct Smem {
  static constexpr int BK = Tile<D>::BK;
  static constexpr int STAGES = Tile<D>::STAGES;
  static constexpr int HALVES = Tile<D>::DP / 64;
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
          __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B,
          int Sq, int Skv, int H, int G, int causal, int window, float softcap,
          float scale) {
  using L = Smem<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES, DP = Tile<D>::DP;
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
    constexpr int ON = DP / 2;  // O accumulator: DP/8 tiles x 4
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
    // key step is 16 rows.  Past D = 128, one n64 product per 64-column
    // box of V.
    auto issue_pv = [&](int i) {
      const int st = i % STAGES;
      mbar_wait(vfull(st), (i / STAGES) & 1);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t vk = v_s(st) + kk * 16 * ROW_BYTES;
        if constexpr (DP <= 128) {
          wgmma_rs(acc, pa[kk], make_desc(vk, BK * ROW_BYTES, 1024));
        } else {
          constexpr uint32_t BOX = BK * ROW_BYTES;
          wgmma_rs_n64_at<0>(acc, pa[kk], make_desc(vk, BOX, 1024));
          wgmma_rs_n64_at<32>(acc, pa[kk], make_desc(vk + BOX, BOX, 1024));
          wgmma_rs_n64_at<64>(acc, pa[kk],
                              make_desc(vk + 2 * BOX, BOX, 1024));
          if constexpr (DP == 256)
            wgmma_rs_n64_at<96>(acc, pa[kk],
                                make_desc(vk + 3 * BOX, BOX, 1024));
        }
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
      const int r = i2 ? r1 : r0;
      if (lse != nullptr && t == 0 && r < Sq)  // m in the natural domain
        lse[(static_cast<long long>(b) * H + h) * Sq + r] =
            m[i2] == NEG_INF ? -NEG_INF
                             : m[i2] * (sl / LOG2E) + logf(fmaxf(l[i2], 1e-30f));
      l[i2] = 1.f / fmaxf(l[i2], 1e-30f);
    }
    // o is a fresh contiguous (B, Sq, H, D) tensor; columns past D (the
    // padding to DP) are not stored
#pragma unroll
    for (int d = 0; d < ON / 4; ++d) {
      const int col = d * 8 + 2 * t;
      if (DP != D && col >= D) continue;
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
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int KV, const long long* st, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!encode(&qm, q, D, Sq, H, B, st, BQ) ||
      !encode(&km, k, D, Skv, KV, B, st + 3, Tile<D>::BK) ||
      !encode(&vm, v, D, Skv, KV, B, st + 6, Tile<D>::BK))
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
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, B, Sq, Skv, H, H / KV,
      causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 9 element strides (batch, seq, head) of q, k, v in that order.
// lse: null, or a contiguous (B, H, Sq) fp32 tensor for the rows' LSE.
// Returns the cudaError_t of the launch (0 = cudaSuccess); -1 for a head
// dim this file was not built for, -2 when a tensor map cannot be encoded
// (no driver entry point, or strides TMA does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int D,
                                      const long long* strides, int causal,
                                      int window, float softcap, float scale,
                                      void* stream, void* lse) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (D == 256)
    return launch<256>(q, k, v, o, ls, B, Sq, Skv, H, KV, strides, causal,
                       window, softcap, scale, s);
  if (D == 160)
    return launch<160>(q, k, v, o, ls, B, Sq, Skv, H, KV, strides, causal,
                       window, softcap, scale, s);
  if (D == 128)
    return launch<128>(q, k, v, o, ls, B, Sq, Skv, H, KV, strides, causal,
                       window, softcap, scale, s);
  if (D == 64)
    return launch<64>(q, k, v, o, ls, B, Sq, Skv, H, KV, strides, causal,
                      window, softcap, scale, s);
  return -1;
}
