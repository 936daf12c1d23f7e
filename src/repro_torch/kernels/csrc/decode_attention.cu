// Dense flash-decode for Hopper (sm_90a): one query token per batch row
// against the row's own K/V cache, GQA-aware.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (the
// Pallas TPU kernel `_kernel`).  Same function: fp32 online softmax over the
// row's cache slots; a slot is valid iff 0 <= abs_pos <= pos, and also
// abs_pos > pos - window when there is a window (ring-buffered local
// caches); tanh softcap.  With no window a global cache holds position p in
// slot min(p, Sc - 1), so no slot past pos can be valid and the walk stops
// at pos, as the Pallas kernel skips blocks beyond pos; with a window every
// slot is walked.  A row with no valid slot writes exactly 0 (the Pallas
// kernel returns an average of its first block there, the oracle an average
// of every slot; see ROADMAP, reference behaviours).
//
// What bounds it on this card: bytes.  A decode step reads every valid K/V
// slot once (B=4 rows at positions ~1000 is ~16 MB per layer for
// llama-1.5b) at ~2 FLOP per byte, far below the H100's ~295 FLOP/byte
// ridge.  The design reads the caches in place in the reference's
// (B, Sc, KV, D) layout (the TPU wrapper transposes both whole caches on
// every call), and one CTA per (kv head, row) handles the G query heads of
// the group together, so each K/V slot is read once per group.  Warp w
// walks blocks of 32 slots w, w + NW, ... with its own m/l/acc in
// registers; a block whose 32 slots are all invalid is skipped, and inside a
// block the loads of invalid slots are skipped.  The NW partial states are
// combined at the end in warp order, with no atomics, so the kernel is
// deterministic (one geometry, one program).  With only B * KV CTAs (32 at
// the slice's shape) on 132 SMs it is latency-bound, not yet at the memory
// bound; a split over slots across CTAs is a later PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;        // warps per CTA, each walking its own blocks
constexpr int MAXG = 8;      // query heads per kv group this file takes
constexpr int BS = 32;       // slots per block: one per lane for the softmax
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
dense_decode(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ abs_pos,
             const int* __restrict__ positions, T* __restrict__ o, int Sc,
             int KV, int G, int window, float softcap, float scale) {
  constexpr int E = D / 32;
  extern __shared__ float smem[];
  float* sc = smem;                    // [NW][G][BS] scores / probabilities
  float* ms = sc + NW * G * BS;        // [NW][G]
  float* ls = ms + NW * G;             // [NW][G]
  float* as = ls + NW * G;             // [NW][G][D]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = KV * G;
  const int pos = positions[b];
  const int* ap_row = abs_pos + (long long)b * Sc;

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
  float* wsc = sc + warp * G * BS;
  const long long row_stride = (long long)KV * D;   // one slot of the cache
  const T* kb = k + (long long)b * Sc * row_stride + (long long)kvh * D;
  const T* vb = v + (long long)b * Sc * row_stride + (long long)kvh * D;

  const int s_end = window ? Sc : min(Sc, pos + 1);
  for (int s0 = warp * BS; s0 < s_end; s0 += NW * BS) {
    const int sl = s0 + lane;
    const int ap = sl < s_end ? ap_row[sl] : -1;
    bool ok = ap >= 0 && ap <= pos;
    if (window) ok = ok && ap > pos - window;
    const unsigned okmask = __ballot_sync(0xffffffffu, ok);
    if (okmask == 0u) continue;        // nothing valid: contributes nothing
    const int n = min(BS, s_end - s0);
    // scores of every valid slot of the block, for every head of the group
    for (int s = 0; s < n; ++s) {
      if (!((okmask >> s) & 1u)) continue;           // warp-uniform
      const T* kp = kb + (long long)(s0 + s) * row_stride;
      float kf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kf[e] = to_f(kp[e * 32 + lane]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x += qv[g][e] * kf[e];
        x = warp_sum(x) * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (lane == 0) wsc[g * BS + s] = x;
      }
    }
    __syncwarp();
    // online softmax over the block; an invalid slot has p = 0.  p is
    // rounded to T before P V, as the reference rounds it to v.dtype,
    // while l sums the unrounded p
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float x = ok ? wsc[g * BS + lane] : NEG_INF;
      const float mx = fmaxf(m[g], warp_max(x));
      const float p = ok ? __expf(x - mx) : 0.f;
      const float corr = __expf(m[g] - mx);
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
      wsc[g * BS + lane] = to_f(from_f<T>(p));
    }
    __syncwarp();
    for (int s = 0; s < n; ++s) {
      if (!((okmask >> s) & 1u)) continue;
      const T* vp = vb + (long long)(s0 + s) * row_stride;
      float vf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vf[e] = to_f(vp[e * 32 + lane]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        const float p = wsc[g * BS + s];
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
    // a row with no valid slot has L = A = 0 and writes exactly 0
    o[((long long)b * H + kvh * G + g) * D + d] =
        from_f<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* ap,
           const void* pos, void* o, int B, int Sc, int KV, int G,
           int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)NW * G * (BS + 2 + D);
  dense_decode<T, D><<<dim3(KV, B), NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(ap),
      static_cast<const int*>(pos), static_cast<T*>(o), Sc, KV, G, window,
      softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 = cudaSuccess); -1 for a dtype / head dim / group this file does not
// take (the Python wrapper checks these first).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* ap,
                                       const void* pos, void* o, int B,
                                       int Sc, int KV, int G, int D,
                                       int dtype, int window, float softcap,
                                       float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAXG || Sc < 1) return -1;
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, ap, pos, o, B, Sc, KV, G,
                                      window, softcap, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, ap, pos, o, B, Sc, KV, G,
                                     window, softcap, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, ap, pos, o, B, Sc, KV, G, window,
                              softcap, scale, s);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, ap, pos, o, B, Sc, KV, G, window,
                             softcap, scale, s);
  return -1;
}
