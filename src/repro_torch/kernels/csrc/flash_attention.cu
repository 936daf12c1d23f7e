// Flash attention forward for Hopper (sm_90a): causal / sliding window /
// full, GQA, tanh softcap, bf16 in and out, fp32 softmax statistics.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel `_kernel`).  Same function, not the same blocking: the
// TPU kernel carries m/l/acc in VMEM scratch across a sequential kv grid
// axis; here one CTA owns a 64-row query tile of one (batch, head) and
// loops over the 64-key tiles itself, keeping m/l/acc in registers.
//
// What bounds it on this card: causal prefill at S=2048, H=16, D=128 does
// ~17 GFLOP of bf16 products against ~25 MB of q/k/v/o traffic, far above
// the H100's ~295 FLOP/byte ridge, so the bound is tensor-core throughput.
// The design answers that with mma.sync m16n8k16 bf16 tensor-core products
// for both S = Q K^T and O += P V (fp32 accumulation), key tiles outside the
// causal/window band skipped entirely, and q/k/v read in place in their
// (B, S, H, D) layout through strides (the TPU wrapper's transposes would
// cost a full copy of each tensor).  It is the simple version: one K/V
// buffer, no cp.async/TMA pipeline and no wgmma, so it runs well below the
// tensor-core peak; PERF.md records its time beside the bound.
//
// Layout of the mma.sync fragments (lane = 4 * g + t):
//   A 16x16: {a0,a1} (g, 2t..2t+1)  {a2,a3} (g+8, 2t..)  {a4,a5} (g, 2t+8..)
//            {a6,a7} (g+8, 2t+8..)
//   B 16x8 : {b0,b1} (k=2t..2t+1, n=g)  {b2,b3} (k=2t+8.., n=g)
//   C 16x8 : {c0,c1} (g, 2t..2t+1)  {c2,c3} (g+8, 2t..2t+1)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA (16 per warp)
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H, int G,
          long long qsb, long long qss, long long qsh, long long ksb,
          long long kss, long long ksh, long long vsb, long long vss,
          long long vsh, int causal, int window, float softcap,
          float scale) {
  constexpr int KS = D / 16;    // k-steps over the head dim for S = Q K^T
  constexpr int NT = BK / 8;    // 8-key column tiles of S
  constexpr int DT = D / 8;     // 8-wide column tiles of O
  constexpr int KSTR = D + 8;   // padded smem row strides (bank spread)
  constexpr int VSTR = BK + 8;
  constexpr int CH = D / 8;     // 16-byte chunks per K/V row
  __shared__ __align__(16) __nv_bfloat16 ks[BK * KSTR];   // K[key][d]
  __shared__ __align__(16) __nv_bfloat16 vt[D * VSTR];    // V^T[d][key]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's rows

  // Q fragments come straight from global memory, once per CTA.
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  uint32_t qf[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c0 = 16 * s + 2 * t, c1 = c0 + 8;
    qf[s][0] = r0 < Sq ? ld32(qb + r0 * qss + c0) : 0u;
    qf[s][1] = r1 < Sq ? ld32(qb + r1 * qss + c0) : 0u;
    qf[s][2] = r0 < Sq ? ld32(qb + r0 * qss + c1) : 0u;
    qf[s][3] = r1 < Sq ? ld32(qb + r1 * qss + c1) : 0u;
  }

  // key tiles that can interact with this query tile (the band test)
  int kt_end = (Skv + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ, Sq) - 1;
    kt_end = min(kt_end, last_row / BK + 1);
  }
  const int kt_begin = window ? max(0, q0 - window + 1) / BK : 0;

  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done reading the previous tile
    // K tile, row-major; keys past Skv are zero so no NaN reaches P V
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Skv)
        x = *reinterpret_cast<const uint4*>(kb + (k0 + r) * kss + c);
      *reinterpret_cast<uint4*>(ks + r * KSTR + c) = x;
    }
    // V tile, transposed into V^T so P V's B fragments are 32-bit loads;
    // keys vary fastest across threads so the 2-byte stores spread banks
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i % BK, c = (i / BK) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Skv)
        x = *reinterpret_cast<const uint4*>(vb + (k0 + r) * vss + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * VSTR + r] = e[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kp = ks + (n * 8 + g) * KSTR + kk * 16 + 2 * t;
        const uint32_t bf[2] = {ld32(kp), ld32(kp + 8)};
        mma_bf16(s[n], qf[kk], bf);
      }
    }
    // scale, softcap, then the causal / window / ragged-edge mask
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = col < Skv;
        if (causal) ok = ok && col <= row;
        if (window) ok = ok && col > row - window;
        s[n][e] = ok ? x : NEG_INF;
      }
    }
    // online softmax, per row half (i = 0: row r0, i = 1: row r1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = __expf(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0 = __expf(s[n][2 * i] - mx);
        const float p1 = __expf(s[n][2 * i + 1] - mx);
        s[n][2 * i] = p0;
        s[n][2 * i + 1] = p1;
        sum += p0 + p1;
      }
      l[i] = l[i] * corr + sum;  // this lane's share; reduced at the end
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * i] *= corr;
        acc[d][2 * i + 1] *= corr;
      }
    }
    // O += P V, P rounded to bf16 as the reference rounds it to v.dtype
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const __nv_bfloat16* vp = vt + (d * 8 + g) * VSTR + kk * 16 + 2 * t;
        const uint32_t bf[2] = {ld32(vp), ld32(vp + 8)};
        mma_bf16(acc[d], pa, bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  // o is a fresh contiguous (B, Sq, H, D) tensor
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(o + ((long long)(b * Sq + r0) * H + h) * D +
                                   col) =
          pack_bf16(acc[d][0] / l[0], acc[d][1] / l[0]);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(o + ((long long)(b * Sq + r1) * H + h) * D +
                                   col) =
          pack_bf16(acc[d][2] / l[1], acc[d][3] / l[1]);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int Sq, int Skv, int H, int KV, const long long* st, int causal,
            int window, float softcap, float scale, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Skv, H, H / KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, window, softcap, scale);
}

}  // namespace

// strides: 9 element strides (batch, seq, head) of q, k, v in that order.
// Returns the cudaError_t of the launch (0 = cudaSuccess); -1 for a head
// dim this file was not built for.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int D,
                                      const long long* strides, int causal,
                                      int window, float softcap, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    launch<128>(q, k, v, o, B, Sq, Skv, H, KV, strides, causal, window,
                softcap, scale, s);
  else if (D == 64)
    launch<64>(q, k, v, o, B, Sq, Skv, H, KV, strides, causal, window,
               softcap, scale, s);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
