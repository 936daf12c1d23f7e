// Speculative-decoding acceptance (Leviathan et al.) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spec_verify.py::spec_accept (the Pallas TPU
// kernel `_kernel`).  Same function: given g draft tokens, the draft
// distributions q (g, V), the target distributions p (g + 1, V) and g
// uniforms u, n is the length of the accepted prefix under
// u_i < min(1, p_i(d_i) / max(q_i(d_i), 1e-30)), and dist is
// max(p_n - q_n * [n < g], 0) normalised, or p_n when its sum is <= 1e-9.
// A draft id outside [0, V) reads no memory and counts as p_i(d_i) =
// q_i(d_i) = 0, a rejection at it, as the Pallas kernel's one-hot
// reduction finds no column there.  The next token is sampled from dist
// outside the kernel, as on the TPU.
//
// What bounds it on this card: neither bytes nor operations, but latency.
// It reads two rows of V floats and writes one (~0.4 MB at V = 32768, ~0.1
// us at 3.35 TB/s); one launch and three dependent trips to memory cost
// more.  The design is one launch of a thread-block cluster of C CTAs, the
// pure rule `split` (the wrapper's `spec_verify.split`): V is cut into
// quads of 4 floats, C = min(8, ceil(quads / 1024)) CTAs each own a
// contiguous run of quads, and a CTA has 32-1024 threads, so V = 32768 is 8
// CTAs of 1024 threads with one 16-byte load of each row a thread.
//   * n in two round trips: in every CTA, warp 0 loads tokens[i] and u[i]
//     of lanes i < g together, then p_i(d_i) and q_i(d_i) together, and one
//     __ballot_sync of !(u < min(ratio, 1)) finds the first rejection
//     (chunks of 32 in order for g > 32, stopping at the first chunk that
//     holds one).  The min and max propagate NaN, as jnp's and torch's do,
//     so a NaN ratio is a rejection.  Every CTA decides n itself, so none
//     waits on another; rank 0 writes it.
//   * each row read once: a thread issues all its 16-byte loads of p_n and
//     q_n (at most REG_QUADS of each a pass) before it uses any, keeps its
//     residuals in registers and sums them in a fixed order: its own order,
//     then warp shuffles, then a shuffle tree over the warps' partials.
//     Above REG_QUADS quads a thread (V > 131072 at C = 8) it takes its
//     run in passes, writes the earlier passes' residuals to dist and later
//     rereads only what it wrote itself.
//   * a deterministic merge across the cluster: warp 0 of each CTA writes
//     its partial into slot `rank` of every CTA's shared memory through
//     distributed shared memory, one cluster barrier (release, acquire)
//     makes all C slots visible, and each CTA sums them in rank order, so
//     every CTA holds the same sum, bit for bit, and takes the same side of
//     the 1e-9 branch.  Pushing the partials, where pulling them would take
//     a remote round trip after the barrier and a second barrier before
//     exit, leaves one barrier wait (an arrive at the start says a CTA
//     runs, so its slots may be written).  No atomics: a second call gives
//     the same bits.  Each CTA then normalises from registers, dividing as
//     IEEE division does but by a reciprocal and an FMA correction
//     (`div_by`), and writes its part of dist once with 16-byte stores.
// Row n starts n * V floats in, so 16-byte loads need V % 4 == 0 and
// 16-byte aligned base pointers (the launcher checks both); any other case
// takes the scalar path of the same source, four 4-byte loads a quad, over
// the same split.  Compiled without --use_fast_math: p / q is IEEE
// division, so n matches the plain version's exactly.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int QUAD = 4;            // floats per 16-byte load
constexpr int MAX_CLUSTER = 8;     // CTAs of a cluster: the portable limit
constexpr int MAX_THREADS = 1024;  // threads of a CTA
constexpr int REG_QUADS = 4;       // quads of each row a thread holds a pass

struct Split {
  int C, threads;
};

// The rule of the wrapper's `spec_verify.split`: C CTAs of `threads`.
Split split(int V) {
  const int quads = (V + QUAD - 1) / QUAD;
  int C = (quads + MAX_THREADS - 1) / MAX_THREADS;
  C = C < MAX_CLUSTER ? C : MAX_CLUSTER;
  const int per = (quads + C - 1) / C;
  int threads = (per + 31) / 32 * 32;
  threads = threads < MAX_THREADS ? threads : MAX_THREADS;
  return {C, threads};
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// max(x, 0) that keeps a NaN, as torch.clamp and jnp.maximum do
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

// x / d rounded as IEEE division rounds it, given r = 1 / d (IEEE): q = x r
// is within an ulp, and one FMA step from the exact remainder x - q d
// rounds it correctly (Markstein) for a quotient in the normal range.  A
// multiply and two FMAs, where a division is a subroutine: the row's
// divisions are the kernel's largest cost on its few SMs.
__device__ __forceinline__ float div_by(float x, float d, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, d, x), r, q);
}

template <bool VEC>
__device__ __forceinline__ float4 load_quad(const float* row, int qd, int V) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(row) + qd);
  const int e = qd * QUAD;
  return make_float4(e < V ? __ldg(row + e) : 0.f,
                     e + 1 < V ? __ldg(row + e + 1) : 0.f,
                     e + 2 < V ? __ldg(row + e + 2) : 0.f,
                     e + 3 < V ? __ldg(row + e + 3) : 0.f);
}

// dist's own entries, written earlier by this thread: a plain load
template <bool VEC>
__device__ __forceinline__ float4 reload_quad(const float* row, int qd,
                                              int V) {
  if (VEC) return reinterpret_cast<const float4*>(row)[qd];
  const int e = qd * QUAD;
  return make_float4(e < V ? row[e] : 0.f, e + 1 < V ? row[e + 1] : 0.f,
                     e + 2 < V ? row[e + 2] : 0.f,
                     e + 3 < V ? row[e + 3] : 0.f);
}

template <bool VEC>
__device__ __forceinline__ void store_quad(float* row, int qd, int V,
                                           float4 x) {
  if (VEC) {
    reinterpret_cast<float4*>(row)[qd] = x;
    return;
  }
  const int e = qd * QUAD;
  if (e < V) row[e] = x.x;
  if (e + 1 < V) row[e + 1] = x.y;
  if (e + 2 < V) row[e + 2] = x.z;
  if (e + 3 < V) row[e + 3] = x.w;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

template <bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
spec_accept_kernel(const int* __restrict__ tokens,
                   const float* __restrict__ dp, const float* __restrict__ tp,
                   const float* __restrict__ u, int* __restrict__ n_out,
                   float* __restrict__ dist, int g, int V) {
  __shared__ int sn;
  __shared__ float warp_part[MAX_THREADS / 32];
  __shared__ float parts[MAX_CLUSTER];   // written by every CTA, by rank
  __shared__ float total, inv;
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int T = blockDim.x, W = T >> 5;
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();      // this CTA runs: peers may write `parts`

  // n: the first rejection, 32 drafts a ballot
  if (warp == 0) {
    int n = g;
    for (int c0 = 0; c0 < g; c0 += 32) {
      const int i = c0 + lane;
      bool rej = false;
      if (i < g) {
        const int tok = tokens[i];
        const float ui = u[i];
        float p = 0.f, q = 0.f;
        if (tok >= 0 && tok < V) {
          p = tp[(long long)i * V + tok];
          q = dp[(long long)i * V + tok];
        }
        const float ratio = p / (q < 1e-30f ? 1e-30f : q);
        rej = !(ui < (ratio > 1.f ? 1.f : ratio));
      }
      const unsigned m = __ballot_sync(0xffffffffu, rej);
      if (m) {
        n = c0 + __ffs(m) - 1;
        break;
      }
    }
    if (lane == 0) {
      sn = n;
      if (rank == 0) *n_out = n;
    }
  }
  __syncthreads();
  const int n = sn;
  const bool sub = n < g;
  const float* pn = tp + (long long)n * V;
  const float* qn = dp + (long long)(sub ? n : g - 1) * V;

  // this CTA's run of quads [lo, hi); thread t takes lo + t, lo + t + T, ...
  const int quads = (V + QUAD - 1) / QUAD;
  const int per = (quads + C - 1) / C;
  const int lo = min(quads, rank * per), hi = min(quads, lo + per);
  const int step = REG_QUADS * T;
  const int last = hi > lo ? lo + (hi - lo - 1) / step * step : lo;
  float4 r[REG_QUADS];
  float s = 0.f;
  for (int b = lo; b < hi; b += step) {
    float4 pv[REG_QUADS], qv[REG_QUADS];
#pragma unroll
    for (int k = 0; k < REG_QUADS; ++k) {
      const int qd = b + k * T + t;
      pv[k] = qv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qd < hi) {
        pv[k] = load_quad<VEC>(pn, qd, V);
        if (sub) qv[k] = load_quad<VEC>(qn, qd, V);
      }
    }
#pragma unroll
    for (int k = 0; k < REG_QUADS; ++k) {
      const int qd = b + k * T + t;
      r[k] = make_float4(relu(pv[k].x - qv[k].x), relu(pv[k].y - qv[k].y),
                         relu(pv[k].z - qv[k].z), relu(pv[k].w - qv[k].w));
      if (qd < hi) {
        s += r[k].x;
        s += r[k].y;
        s += r[k].z;
        s += r[k].w;
        if (b != last) store_quad<VEC>(dist, qd, V, r[k]);
      }
    }
  }

  // the CTA's sum, then the cluster's in rank order
  s = warp_sum(s);
  if (lane == 0) warp_part[warp] = s;
  __syncthreads();
  cluster_wait();                // every CTA of the cluster runs
  if (warp == 0) {
    const float x = warp_sum(lane < W ? warp_part[lane] : 0.f);
    if (lane < C) *cluster.map_shared_rank(&parts[rank], lane) = x;
  }
  cluster_arrive();              // release: this CTA's partial is out
  cluster_wait();                // acquire: every partial is in `parts`
  if (t == 0) {
    float rs = 0.f;
    for (int k = 0; k < C; ++k) rs += parts[k];
    total = rs;
    inv = 1.f / rs;
  }
  __syncthreads();
  const float rs = total, r_rs = inv;

  for (int b = lo; b < hi; b += step) {
#pragma unroll
    for (int k = 0; k < REG_QUADS; ++k) {
      const int qd = b + k * T + t;
      if (qd >= hi) continue;
      float4 x;
      if (rs > 1e-9f) {
        x = b == last ? r[k] : reload_quad<VEC>(dist, qd, V);
        x = make_float4(div_by(x.x, rs, r_rs), div_by(x.y, rs, r_rs),
                        div_by(x.z, rs, r_rs), div_by(x.w, rs, r_rs));
      } else {
        x = load_quad<VEC>(pn, qd, V);
      }
      store_quad<VEC>(dist, qd, V, x);
    }
  }
}

template <bool VEC>
int launch(const int* tokens, const float* dp, const float* tp,
           const float* u, int* n_out, float* dist, int g, int V,
           cudaStream_t stream) {
  const Split sp = split(V);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sp.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sp.C);
  cfg.blockDim = dim3(sp.threads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // whether the card can place a cluster of this shape, asked once a shape:
  // 0 not asked yet, 1 yes, -1 no
  static int placed[2][MAX_CLUSTER + 1][MAX_THREADS / 32 + 1];
  int& ok = placed[VEC][sp.C][sp.threads / 32];
  if (ok == 0) {
    int clusters = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&clusters, spec_accept_kernel<VEC>,
                                       &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    ok = clusters > 0 ? 1 : -1;
  }
  if (ok < 0) return -2;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, spec_accept_kernel<VEC>,
                                           tokens, dp, tp, u, n_out, dist, g,
                                           V);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The split this file launches for V: C CTAs of `threads` threads.
// Returns -1 for V < 1.
extern "C" int spec_accept_split(int V, int* C, int* threads) {
  if (V < 1) return -1;
  const Split sp = split(V);
  *C = sp.C;
  *threads = sp.threads;
  return 0;
}

// Returns the cudaError_t of the launch (0 = cudaSuccess); -1 for a shape
// this file does not take (the Python wrapper checks these first); -2 when
// the card cannot place a cluster of the split's shape.
extern "C" int spec_accept_launch(const void* tokens, const void* dp,
                                  const void* tp, const void* u, void* n_out,
                                  void* dist, int g, int V, void* stream) {
  if (g < 1 || V < 1) return -1;
  const int* tk = static_cast<const int*>(tokens);
  const float* q = static_cast<const float*>(dp);
  const float* p = static_cast<const float*>(tp);
  const float* uu = static_cast<const float*>(u);
  int* n = static_cast<int*>(n_out);
  float* d = static_cast<float*>(dist);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(dp) |
                          reinterpret_cast<uintptr_t>(tp) |
                          reinterpret_cast<uintptr_t>(dist);
  if (V % QUAD == 0 && bases % 16 == 0)
    return launch<true>(tk, q, p, uu, n, d, g, V, s);
  return launch<false>(tk, q, p, uu, n, d, g, V, s);
}
