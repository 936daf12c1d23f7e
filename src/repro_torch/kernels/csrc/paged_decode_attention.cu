// Paged flash-decode for Hopper (sm_90a): one query token per batch row
// against shared K/V page pools addressed through a page table.
//
// Replaces: src/repro/kernels/decode_attention.py::paged_decode_attention
// (the Pallas TPU kernel `_paged_kernel`).  Same function: fp32 online
// softmax over the row's pages in page order; a page that is unmapped (-1),
// lies wholly beyond the decode position, or falls outside the window is
// skipped; a row with no live page outputs exactly 0; window and tanh
// softcap are supported.  GQA: one CTA per (kv head, batch row) handles the
// G query heads of that group together, so each K/V page is read once per
// group, not once per query head.
//
// What bounds it on this card: bytes.  A decode step reads every live K/V
// page once (B=4 rows at position ~1000 is ~16 MB per layer for llama-1.5b)
// and does ~2 FLOP per byte, far below the H100's ~295 FLOP/byte ridge.
// The design reads the pools in place in the reference's (P, ps, KV, D)
// layout (the TPU wrapper transposes each whole pool on every call, ~33 MB
// per layer at this slice's pool size), loads its own page ids (no scalar
// prefetch), and keeps several pages in flight per CTA: warp w walks pages
// w, w + NW, ... with its own m/l/acc, and the NW partial states are
// combined at the end in warp order.  That combine is fixed, with no
// atomics, so the kernel is deterministic (one geometry, one program).
// With only B * KV CTAs (32 here) on 132 SMs it is latency-bound, not yet
// at the memory bound; a split over pages across CTAs is a later PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;        // warps per CTA, each walking its own pages
constexpr int MAXG = 8;      // query heads per kv group this file takes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Lane `lane` owns head-dim elements d = e * 32 + lane, e < D / 32, so
// every load of a K/V row is one coalesced run across the warp.
template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
paged_decode(const T* __restrict__ q, const T* __restrict__ kpool,
             const T* __restrict__ vpool, const int* __restrict__ page_table,
             const int* __restrict__ positions, T* __restrict__ o, int NP,
             int ps, int KV, int G, int window, float softcap, float scale) {
  constexpr int E = D / 32;
  extern __shared__ float smem[];
  float* sc = smem;                    // [NW][G][ps] scores / probabilities
  float* ms = sc + NW * G * ps;        // [NW][G]
  float* ls = ms + NW * G;             // [NW][G]
  float* as = ls + NW * G;             // [NW][G][D]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = KV * G;
  const int pos = positions[b];
  const int* pt = page_table + (long long)b * NP;

  float qv[MAXG][E], acc[MAXG][E], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[g][e] = 0.f;
      qv[g][e] = g < G ? to_f(q[((long long)b * H + kvh * G + g) * D +
                                e * 32 + lane])
                       : 0.f;
    }
  }
  float* wsc = sc + warp * G * ps;
  const long long row_stride = (long long)KV * D;   // one slot of a page

  const int j_last = min(NP - 1, pos / ps);   // pages wholly beyond pos skip
  for (int j = warp; j <= j_last; j += NW) {
    const int page = pt[j];
    bool live = page >= 0;
    if (window) live = live && (j * ps + ps - 1 > pos - window);
    if (!live) continue;
    const T* kp = kpool + ((long long)page * ps * KV + kvh) * D;
    const T* vp = vpool + ((long long)page * ps * KV + kvh) * D;
    // scores of every slot of the page, for every head of the group
#pragma unroll 4
    for (int s = 0; s < ps; ++s) {
      float kf[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        kf[e] = to_f(kp[s * row_stride + e * 32 + lane]);
      const int ap = j * ps + s;
      bool ok = ap <= pos;
      if (window) ok = ok && ap > pos - window;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x += qv[g][e] * kf[e];
        x = warp_sum(x) * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (lane == 0) wsc[g * ps + s] = ok ? x : NEG_INF;
      }
    }
    __syncwarp();
    // online softmax over the page; p is rounded to T before P V, as the
    // reference rounds it to v.dtype, while l sums the unrounded p
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float x = lane < ps ? wsc[g * ps + lane] : NEG_INF;
      const float mx = fmaxf(m[g], warp_max(x));
      const float p = lane < ps ? __expf(x - mx) : 0.f;
      const float corr = __expf(m[g] - mx);
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
      if (lane < ps) wsc[g * ps + lane] = to_f(from_f<T>(p));
    }
    __syncwarp();
#pragma unroll 4
    for (int s = 0; s < ps; ++s) {
      float vf[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        vf[e] = to_f(vp[s * row_stride + e * 32 + lane]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        const float p = wsc[g * ps + s];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += p * vf[e];
      }
    }
    __syncwarp();
  }

  // combine the NW partial states in warp order (fixed: deterministic)
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      ms[warp * G + g] = m[g];
      ls[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      as[(warp * G + g) * D + e * 32 + lane] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, ms[w * G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float c = expf(ms[w * G + g] - M);
      L += ls[w * G + g] * c;
      A += as[(w * G + g) * D + d] * c;
    }
    // a row with no live page has L = A = 0 and writes exactly 0
    o[((long long)b * H + kvh * G + g) * D + d] =
        from_f<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* pt, const void* pos, void* o, int B, int NP, int ps,
           int KV, int G, int window, float softcap, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)NW * G * (ps + 2 + D);
  paged_decode<T, D><<<dim3(KV, B), NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(pt),
      static_cast<const int*>(pos), static_cast<T*>(o), NP, ps, KV, G,
      window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 = cudaSuccess); -1 for a dtype / head dim / group this file does not
// take (the Python wrapper checks these first).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* kpool, const void* vpool, const void* pt,
    const void* pos, void* o, int B, int NP, int ps, int KV, int G, int D,
    int dtype, int window, float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAXG || ps < 1 || ps > 32) return -1;
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, kpool, vpool, pt, pos, o, B, NP, ps,
                                      KV, G, window, softcap, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, kpool, vpool, pt, pos, o, B, NP, ps,
                                     KV, G, window, softcap, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, kpool, vpool, pt, pos, o, B, NP, ps, KV, G,
                              window, softcap, scale, s);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, kpool, vpool, pt, pos, o, B, NP, ps, KV, G,
                             window, softcap, scale, s);
  return -1;
}
