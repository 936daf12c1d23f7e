// Chunked RWKV6 linear attention for Hopper (sm_90a): a (D, D) fp32 matrix
// state carried across chunks, data-dependent per-channel decay, fp32 in
// and out.
//
// Replaces: src/repro/kernels/rwkv6_scan.py::rwkv6_scan (the Pallas TPU
// kernel `_kernel`).  Same function and the same formulas, per chunk of C
// rows (C <= 64):
//   cum    = cumsum_t log w                  (per column, in row order)
//   A_excl = exp(cum - log w),  A_incl = exp(cum),  A_end = A_incl[C-1]
//   rA     = r * A_excl,        kA = k / max(A_incl, 1e-24)
//   y      = rA S + tril_{-1}(rA kA^T) v + (r . (u * k)) v
//   S'     = A_end * S + (kA * A_end)^T v
// The TPU grid walks (batch, head, chunk) with the chunk axis sequential
// and the state in VMEM scratch.  Here one CTA owns one (batch, head) and
// walks the chunks itself in order, with the state in shared memory
// (nothing may carry between CTAs, which run in no order).  r, k, v and w
// are read in place in their (B, T, H, D) layout through strides, without
// the Pallas wrapper's (B, H, T, D) transposes.
//
// What bounds it on this card: at T = 1536, H = 64, D = 64 a call does
// ~3.3 GFLOP of fp32 products (4 C D^2 + 2 D C (C - 1) per chunk and head)
// against ~126 MB of r, k, v, w and y: ~50 us on the fp32 CUDA cores (67
// TFLOP/s) and ~38 us of HBM traffic, so the bound is the fp32 operations.
// The design is the simple one: the products run on the CUDA cores out of
// padded shared-memory tiles (row stride D + 1, so a warp reading one
// column of a tile hits 32 banks), one output element per thread and
// iteration; no register blocking, no tensor cores (fp32 state math, as on
// the TPU), and B * H CTAs, so a B = 1 prefill fills 64 of the 132 SMs.
// expf / logf and IEEE division: built without --use_fast_math.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 64;
constexpr int AP = MAX_C + 1;  // row stride of the (C, C) score tile

struct Strides {  // element strides (batch, time, head) of r, k, v, w
  long long rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh;
};

template <int D>
constexpr int smem_floats() {
  // S [D][D+1]; r/rA, k/kA, v [MAX_C][D+1]; log w, then scores
  // [MAX_C][MAX_C+1]; bonus [MAX_C]; A_end [D]; u [D]
  return D * (D + 1) + 3 * MAX_C * (D + 1) + MAX_C * AP + MAX_C + 2 * D;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ out, float* __restrict__ sT, int T,
                  int H, int C, Strides st) {
  constexpr int P = D + 1;  // padded row stride of the D-wide tiles
  extern __shared__ float smem[];
  float* S = smem;                   // [D][P] the carried state
  float* ra = S + D * P;             // [C][P] r, then r * A_excl
  float* ka = ra + MAX_C * P;        // [C][P] k, then k / max(A_incl, 1e-24)
  float* vs = ka + MAX_C * P;        // [C][P] v
  float* att = vs + MAX_C * P;       // [C][P] log w, then [C][AP] scores
  float* bonus = att + MAX_C * AP;   // [C]
  float* aend = bonus + MAX_C;       // [D]
  float* us = aend + D;              // [D]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float* rp = r + b * st.rb + h * st.rh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  const float* wp = w + b * st.wb + h * st.wh;
  const long long sbase = ((long long)b * H + h) * D * D;

  for (int i = tid; i < D * D; i += THREADS) S[(i / D) * P + i % D] = s0[sbase + i];
  for (int i = tid; i < D; i += THREADS) us[i] = u[h * D + i];
  __syncthreads();

  for (int c0 = 0; c0 < T; c0 += C) {
    // 1. the chunk's tiles; w goes in as log w
    for (int i = tid; i < C * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const long long tt = c0 + t;
      ra[t * P + d] = rp[tt * st.rt + d];
      ka[t * P + d] = kp[tt * st.kt + d];
      vs[t * P + d] = vp[tt * st.vt + d];
      att[t * P + d] = logf(wp[tt * st.wt + d]);
    }
    __syncthreads();

    // 2. bonus_t = r_t . (u * k_t), from r and k before they are scaled
    for (int t = tid; t < C; t += THREADS) {
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc += ra[t * P + d] * (us[d] * ka[t * P + d]);
      bonus[t] = acc;
    }
    __syncthreads();

    // 3. cumulative decay down each column, in row order
    if (tid < D) {
      const int d = tid;
      float cum = 0.f, a_incl = 1.f;
      for (int t = 0; t < C; ++t) {
        const float lw = att[t * P + d];
        cum += lw;
        const float a_excl = expf(cum - lw);
        a_incl = expf(cum);
        ra[t * P + d] *= a_excl;
        ka[t * P + d] = ka[t * P + d] / fmaxf(a_incl, 1e-24f);
      }
      aend[d] = a_incl;
    }
    __syncthreads();

    // 4. strictly lower scores: att[t][s] = rA_t . kA_s for s < t, else 0
    for (int i = tid; i < C * C; i += THREADS) {
      const int t = i / C, s = i % C;
      float acc = 0.f;
      if (s < t) {
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc += ra[t * P + d] * ka[s * P + d];
      }
      att[t * AP + s] = acc;
    }
    __syncthreads();

    // 5. y = rA S + att v + bonus v, written straight to (B, T, H, D)
    for (int i = tid; i < C * D; i += THREADS) {
      const int t = i / D, j = i % D;
      float inter = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) inter += ra[t * P + d] * S[d * P + j];
      float intra = 0.f;
      for (int s = 0; s < t; ++s) intra += att[t * AP + s] * vs[s * P + j];
      out[(((long long)b * T + c0 + t) * H + h) * D + j] =
          (inter + intra) + bonus[t] * vs[t * P + j];
    }
    __syncthreads();  // step 5 reads S; step 6 rewrites it

    // 6. S'[d][j] = A_end[d] S[d][j] + sum_s (kA[s][d] A_end[d]) v[s][j];
    //    each element is read and written by its own thread only
    for (int i = tid; i < D * D; i += THREADS) {
      const int d = i / D, j = i % D;
      const float ae = aend[d];
      float acc = 0.f;
      for (int s = 0; s < C; ++s) acc += (ka[s * P + d] * ae) * vs[s * P + j];
      S[d * P + j] = ae * S[d * P + j] + acc;
    }
    __syncthreads();  // the next chunk's loads overwrite the tiles
  }

  for (int i = tid; i < D * D; i += THREADS) sT[sbase + i] = S[(i / D) * P + i % D];
}

template <int D>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* sT, int B, int T,
           int H, int C, const Strides& st, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  // above 48 KB only as opted-in dynamic shared memory
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_scan_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  rwkv6_scan_kernel<D><<<dim3(H, B), THREADS, bytes, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(sT), T, H, C, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides (batch, time, head) of r, k, v, w in that
// order; u (H, D), state0 / stateT (B, H, D, D) and out (B, T, H, D) are
// contiguous.  Returns the cudaError_t of the launch (0 = cudaSuccess); -1
// for a shape this file does not take (the Python wrapper checks first).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u,
                                 const void* s0, void* out, void* sT, int B,
                                 int T, int H, int D, int C,
                                 const long long* strides, void* stream) {
  if (B < 1 || T < 1 || H < 1 || C < 1 || C > MAX_C || T % C) return -1;
  const long long* s = strides;
  const Strides st{s[0], s[1], s[2], s[3], s[4],  s[5],
                   s[6], s[7], s[8], s[9], s[10], s[11]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(r, k, v, w, u, s0, out, sT, B, T, H, C, st, cs);
    case 32: return launch<32>(r, k, v, w, u, s0, out, sT, B, T, H, C, st, cs);
    case 64: return launch<64>(r, k, v, w, u, s0, out, sT, B, T, H, C, st, cs);
    default: return -1;
  }
}
