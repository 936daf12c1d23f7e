// Speculative-decoding acceptance (Leviathan et al.) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spec_verify.py::spec_accept (the Pallas TPU
// kernel `_kernel`).  Same function: given g draft tokens, the draft
// distributions q (g, V), the target distributions p (g + 1, V) and g
// uniforms u, n is the length of the accepted prefix under
// u_i < min(1, p_i(d_i) / max(q_i(d_i), 1e-30)), and dist is
// max(p_n - q_n * [n < g], 0) normalised, or p_n when its sum is <= 1e-9.
// The next token is sampled from dist outside the kernel, as on the TPU.
//
// What bounds it on this card: neither.  The function reads 2g token
// probabilities and two rows of V floats and writes one (~0.4 MB at
// V = 32768, ~0.1 us at 3.35 TB/s); one launch costs more than that.  The
// design is one CTA that loops over V: thread 0 reads the g token
// probabilities (no (g, V) one-hot, which the TPU kernel builds because a
// gather is costly there), the residual's sum is a fixed-order block
// reduction (warp shuffles, then the warps' partials in warp order), so the
// result is deterministic.  Compiled without --use_fast_math: p / q is IEEE
// division, so n matches the plain version's exactly.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(THREADS)
spec_accept_kernel(const int* __restrict__ tokens,
                   const float* __restrict__ dp, const float* __restrict__ tp,
                   const float* __restrict__ u, int* __restrict__ n_out,
                   float* __restrict__ dist, int g, int V) {
  __shared__ int sn;
  __shared__ float partial[WARPS];
  __shared__ float total;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    int n = 0;
    for (int i = 0; i < g; ++i) {
      // tokens come from the drafter's own sampling and lie in [0, V);
      // the clamp only keeps a bad id from reading out of bounds
      const int tok = min(max(tokens[i], 0), V - 1);
      const float p = tp[(long long)i * V + tok];
      const float q = dp[(long long)i * V + tok];
      const float ratio = p / fmaxf(q, 1e-30f);
      if (!(u[i] < fminf(ratio, 1.f))) break;        // first rejection
      ++n;
    }
    sn = n;
    *n_out = n;
  }
  __syncthreads();
  const int n = sn;
  const float* pn = tp + (long long)n * V;
  const float* qn = dp + (long long)min(n, g - 1) * V;
  const bool sub = n < g;
  float s = 0.f;
  for (int i = t; i < V; i += THREADS) {
    const float r = fmaxf(pn[i] - (sub ? qn[i] : 0.f), 0.f);
    dist[i] = r;
    s += r;
  }
  s = warp_sum(s);
  if (lane == 0) partial[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const float x = warp_sum(partial[lane]);
    if (lane == 0) total = x;
  }
  __syncthreads();
  const float rs = total;
  // each thread rereads the residual entries it wrote itself
  for (int i = t; i < V; i += THREADS)
    dist[i] = rs > 1e-9f ? dist[i] / fmaxf(rs, 1e-30f) : pn[i];
}

}  // namespace

// Returns the cudaError_t of the launch (0 = cudaSuccess); -1 for a shape
// this file does not take (the Python wrapper checks these first).
extern "C" int spec_accept_launch(const void* tokens, const void* dp,
                                  const void* tp, const void* u, void* n_out,
                                  void* dist, int g, int V, void* stream) {
  if (g < 1 || V < 1) return -1;
  spec_accept_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tokens), static_cast<const float*>(dp),
      static_cast<const float*>(tp), static_cast<const float*>(u),
      static_cast<int*>(n_out), static_cast<float*>(dist), g, V);
  return static_cast<int>(cudaGetLastError());
}
