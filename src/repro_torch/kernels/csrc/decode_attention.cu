// Dense flash-decode for Hopper (sm_90a): one query token per batch row
// against the row's own K/V cache, GQA-aware.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (the
// Pallas TPU kernel `_kernel`).  Same function: fp32 softmax over the row's
// valid cache slots; a slot is valid iff 0 <= abs_pos <= pos, and also
// abs_pos > pos - window when there is a window (ring-buffered local
// caches); tanh softcap.  With no window a global cache holds position p in
// slot min(p, Sc - 1), so no slot past pos can be valid and the walk stops
// at pos, as the Pallas kernel skips blocks beyond pos; with a window every
// slot is walked.  A row with no valid slot writes exactly 0 (the Pallas
// kernel returns an average of its first block there, the oracle an average
// of every slot; see ROADMAP, reference behaviours).
//
// What bounds it on this card: bytes.  A decode step reads every valid K/V
// slot once (4 rows at positions 60-1560 of llama-1.5b is 13.1 MB per
// layer) at ~2 FLOP per byte, far below the H100's ~295 FLOP/byte ridge.
// The Pallas kernel walks the slots as a sequential grid axis carrying
// m/l/acc in VMEM; here the slots are split across CTAs, CHUNK = 128 slots
// each, and three launches share the work:
//   * split_scores, grid (KV, B, Sc / CHUNK), reads K: the chunk's scores
//     for the G query heads of the group (each K slot read once per group),
//     its max m and l = sum of exp(s - m) over its valid slots.  The split
//     depends on Sc only, never on the positions, which stay on the device:
//     a chunk past pos, or holding no valid slot, exits at once with l = 0.
//   * split_pv, the same grid, reads V: every CTA of a (row, kv head)
//     merges the chunks' (m, l) in one fixed order into the row's M and
//     L = sum l e^(m - M), and takes p = exp(s - M) / L rounded to T, as
//     the reference rounds its normalised probabilities to v.dtype, so the
//     kernel's P V differs from the reference's only in the order of fp32
//     sums; acc = sum of p V over the chunk.
//   * combine, grid (KV, B): o = the sum of the chunks' acc in chunk order
//     (chunks with l = 0 skipped), so exactly 0 for a row with no valid slot.
// split_pv and combine are launched as programmatic dependents: split_pv's
// CTAs start with split_scores' and read V while K is read, and wait only
// before they read the scores; the launch gaps between the three go too.
// At the timed shape (B=4, Sc=2048, KV=8, positions 60/530/1050/1560) the
// split grids are 512 CTAs, of which 224 hold valid slots: 1.7 per SM.
// Loads are 16 bytes a lane: a bf16 slot row of D=128 is 256 contiguous
// bytes, taken by 16 lanes, so a warp reads two slots per instruction, and
// each thread issues its loads of all its slots (8 at bf16 D=128) before
// it uses the first.  A score reduces over the lanes of its slot (4
// shuffles at bf16 D=128).  Every sum runs in a fixed order and there are
// no atomics: the kernel is deterministic, and row b's output depends only
// on row b's inputs and Sc.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;   // slots per CTA of the split
constexpr int NW = 8;        // warps per CTA
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

// Programmatic dependent launch: a kernel launched with the attribute may
// start while the kernel before it runs, up to its griddepcontrol.wait,
// which returns once that kernel has finished and its writes are visible.
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void start_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// The VEC = 16 / sizeof(T) elements of one 16-byte vector, as floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) f[i] = to_f(e[i]);
}

// GP: the group size rounded up to a power of two (the register arrays'
// extent); G <= GP is the real one.  Scratch, per (row, kv head, chunk):
// GP pairs (m, l), GP x CHUNK scores, GP x D of acc.
template <typename T, int D>
struct Lanes {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int LPS = D / VEC;         // lanes per slot row
  static constexpr int SPW = 32 / LPS;        // slots per warp load
  static constexpr int SPR = NW * SPW;        // slots per CTA round
  static constexpr int NR = CHUNK / SPR;      // rounds per chunk
};

// Validity of this thread's slots c0 + r * SPR + in_round of the chunk
// starting at c0 (with no window the walk stops at pos); true if any slot
// of the CTA is valid.  The abs_pos loads do not wait for pos.
template <int NR, int SPR>
__device__ __forceinline__ bool validity(bool (&ok)[NR], const int* ap_row,
                                         const int* pos_b, int c0, int Sc,
                                         int in_round, int window) {
  const int c_end = min(Sc, c0 + CHUNK);
  int ap[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int sl = c0 + r * SPR + in_round;
    ap[r] = sl < c_end ? ap_row[sl] : -1;
  }
  const int pos = *pos_b;
  bool any = false;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int sl = c0 + r * SPR + in_round;
    ok[r] = ap[r] >= 0 && ap[r] <= pos &&
            (window ? ap[r] > pos - window : sl <= pos);
    any |= ok[r];
  }
  return __syncthreads_or(any);
}

template <typename T, int D, int GP>
__global__ void __launch_bounds__(NW * 32)
split_scores(const T* __restrict__ q, const T* __restrict__ k,
             const int* __restrict__ abs_pos,
             const int* __restrict__ positions, float* __restrict__ part_ml,
             float* __restrict__ part_sc, int Sc, int KV, int G, int window,
             float softcap, float scale) {
  using L = Lanes<T, D>;
  __shared__ float sc[GP][CHUNK];
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / L::LPS, e0 = (lane % L::LPS) * L::VEC;
  const int in_round = warp * L::SPW + sub;
  const int c0 = split * CHUNK;
  const long long pidx = ((long long)b * KV + kvh) * gridDim.z + split;
  float* ml = part_ml + pidx * GP * 2;
  start_next();   // split_pv may start reading V now

  bool ok[L::NR];
  if (!validity<L::NR, L::SPR>(ok, abs_pos + (long long)b * Sc,
                               positions + b, c0, Sc, in_round, window)) {
    if (threadIdx.x < GP) {   // nothing valid: an empty partial
      ml[threadIdx.x * 2] = NEG_INF;
      ml[threadIdx.x * 2 + 1] = 0.f;
    }
    return;
  }
  const long long row_stride = (long long)KV * D;   // one slot of the cache
  const T* kb = k + (long long)b * Sc * row_stride + (long long)kvh * D + e0;
  uint4 kv[L::NR];
#pragma unroll
  for (int r = 0; r < L::NR; ++r) {
    const int sl = c0 + r * L::SPR + in_round;
    kv[r] = ok[r] ? *reinterpret_cast<const uint4*>(kb + sl * row_stride)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  float qv[GP][L::VEC];
  const T* qb = q + ((long long)b * KV * G + (long long)kvh * G) * D + e0;
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G) {
      unpack<T>(*reinterpret_cast<const uint4*>(qb + g * D), qv[g]);
    } else {
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) qv[g][e] = 0.f;
    }
  }
  // a dot over this lane's VEC elements, reduced over the slot's lanes
#pragma unroll
  for (int r = 0; r < L::NR; ++r) {
    float kf[L::VEC];
    unpack<T>(kv[r], kf);
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) x += qv[g][e] * kf[e];
#pragma unroll
      for (int o = L::LPS / 2; o > 0; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      x *= scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      if (lane % L::LPS == 0 && g < G)
        sc[g][r * L::SPR + in_round] = ok[r] ? x : NEG_INF;
    }
  }
  __syncthreads();

  // the chunk's max and sum, one warp per query head of the group; the
  // scores go out for split_pv
  if (warp < G) {
    constexpr int PL = CHUNK / 32;
    float* out = part_sc + (pidx * GP + warp) * CHUNK;
    float x[PL];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      x[i] = sc[warp][i * 32 + lane];
      out[i * 32 + lane] = x[i];
      mx = fmaxf(mx, x[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i)
      sum += x[i] > NEG_INF ? expf(x[i] - mx) : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      ml[warp * 2] = mx;
      ml[warp * 2 + 1] = sum;
    }
  }
}

template <typename T, int D, int GP>
__global__ void __launch_bounds__(NW * 32)
split_pv(const T* __restrict__ v, const int* __restrict__ abs_pos,
         const int* __restrict__ positions,
         const float* __restrict__ part_ml, const float* __restrict__ part_sc,
         float* __restrict__ part_acc, int Sc, int KV, int G, int window) {
  // pr: the chunk's scores, then p normalised and rounded to T
  using L = Lanes<T, D>;
  __shared__ float pr[GP][CHUNK];
  __shared__ float red[NW][GP][D];    // per-warp partial acc
  __shared__ float ML[GP][2];         // the row's M and L
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / L::LPS, e0 = (lane % L::LPS) * L::VEC;
  const int in_round = warp * L::SPW + sub;
  const int c0 = split * CHUNK;
  const long long p0 = ((long long)b * KV + kvh) * nsplit;
  const long long pidx = p0 + split;

  start_next();   // combine may start too
  bool ok[L::NR];
  if (!validity<L::NR, L::SPR>(ok, abs_pos + (long long)b * Sc,
                               positions + b, c0, Sc, in_round, window)) {
    wait_for_previous();  // combine's wait covers split_scores through this
    return;               // combine skips the chunk (l = 0)
  }
  const long long row_stride = (long long)KV * D;
  const T* vb = v + (long long)b * Sc * row_stride + (long long)kvh * D + e0;
  uint4 vv[L::NR];
#pragma unroll
  for (int r = 0; r < L::NR; ++r) {
    const int sl = c0 + r * L::SPR + in_round;
    vv[r] = ok[r] ? *reinterpret_cast<const uint4*>(vb + sl * row_stride)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  // V is in flight; now split_scores' results are needed
  wait_for_previous();
  for (int i = threadIdx.x; i < G * CHUNK; i += NW * 32)
    pr[i / CHUNK][i % CHUNK] = part_sc[pidx * GP * CHUNK + i];
  // the row's M and L, one warp per query head, the same in every CTA of
  // the row: lane j takes chunks j, j + 32, ... in order, then a shuffle
  // tree (a fixed order)
  if (warp < G) {
    const float* ml = part_ml + (p0 * GP + warp) * 2;
    float M = NEG_INF;
    for (int ci = lane; ci < nsplit; ci += 32)
      if (ml[ci * GP * 2 + 1] > 0.f) M = fmaxf(M, ml[ci * GP * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float Ls = 0.f;
    for (int ci = lane; ci < nsplit; ci += 32)
      if (ml[ci * GP * 2 + 1] > 0.f)
        Ls += ml[ci * GP * 2 + 1] * expf(ml[ci * GP * 2] - M);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      Ls += __shfl_xor_sync(0xffffffffu, Ls, o);
    if (lane == 0) {
      ML[warp][0] = M;
      ML[warp][1] = Ls;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * CHUNK; i += NW * 32) {
    const int g = i / CHUNK;
    const float x = pr[g][i % CHUNK];
    const float p = x > NEG_INF ? expf(x - ML[g][0]) / ML[g][1] : 0.f;
    pr[g][i % CHUNK] = to_f(from_f<T>(p));
  }
  __syncthreads();

  // acc over this thread's slots, then over the warp's slot lanes, then
  // over the warps in warp order
  float acc[GP][L::VEC];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < L::VEC; ++e) acc[g][e] = 0.f;
#pragma unroll
  for (int r = 0; r < L::NR; ++r) {
    float vf[L::VEC];
    unpack<T>(vv[r], vf);
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float p = g < G ? pr[g][r * L::SPR + in_round] : 0.f;
#pragma unroll
      for (int e = 0; e < L::VEC; ++e) acc[g][e] += p * vf[e];
    }
  }
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < L::VEC; ++e) {
#pragma unroll
      for (int o = L::LPS; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      if (sub == 0 && g < G) red[warp][g][e0 + e] = acc[g][e];
    }
  __syncthreads();
  float* out = part_acc + pidx * GP * D;
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += red[w][g][d];
    out[g * D + d] = a;
  }
}

// One thread per (query head of the group, element): the chunks' acc
// summed in chunk order.
template <typename T, int GP>
__global__ void combine(const float* __restrict__ part_ml,
                        const float* __restrict__ part_acc, T* __restrict__ o,
                        int KV, int G, int D, int nsplit) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int g = threadIdx.x / D, d = threadIdx.x % D;
  wait_for_previous();
  if (g >= G) return;
  const long long p0 = ((long long)b * KV + kvh) * nsplit;
  float A = 0.f;
  // both loads unconditional (an empty chunk's acc is never written, and
  // is selected away), so the loads of several chunks are in flight
#pragma unroll 8
  for (int ci = 0; ci < nsplit; ++ci) {
    const float l = part_ml[((p0 + ci) * GP + g) * 2 + 1];
    const float a = part_acc[((p0 + ci) * GP + g) * D + d];
    A += l > 0.f ? a : 0.f;
  }
  // a row with no valid slot sums nothing: exactly 0
  o[((long long)b * KV * G + (long long)kvh * G + g) * D + d] = from_f<T>(A);
}

template <typename T, int D, int GP>
int launch(const void* q, const void* k, const void* v, const void* ap,
           const void* pos, void* o, float* part, int B, int Sc, int KV,
           int G, int window, float softcap, float scale,
           cudaStream_t stream) {
  const int nsplit = (Sc + CHUNK - 1) / CHUNK;
  const size_t n = (size_t)B * KV * nsplit * GP;
  float* part_ml = part;
  float* part_sc = part_ml + n * 2;
  float* part_acc = part_sc + n * CHUNK;
  const dim3 grid(KV, B, nsplit);
  split_scores<T, D, GP><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const int*>(ap), static_cast<const int*>(pos), part_ml,
      part_sc, Sc, KV, G, window, softcap, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // split_pv and combine with programmatic dependent launch
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NW * 32);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, split_pv<T, D, GP>, static_cast<const T*>(v),
                         static_cast<const int*>(ap),
                         static_cast<const int*>(pos),
                         static_cast<const float*>(part_ml),
                         static_cast<const float*>(part_sc), part_acc, Sc, KV,
                         G, window);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3(KV, B);
  cfg.blockDim = dim3(GP * D);
  e = cudaLaunchKernelEx(&cfg, combine<T, GP>,
                         static_cast<const float*>(part_ml),
                         static_cast<const float*>(part_acc),
                         static_cast<T*>(o), KV, G, D, nsplit);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(const void* q, const void* k, const void* v, const void* ap,
             const void* pos, void* o, float* part, int B, int Sc, int KV,
             int G, int window, float softcap, float scale,
             cudaStream_t stream) {
  if (G == 1)
    return launch<T, D, 1>(q, k, v, ap, pos, o, part, B, Sc, KV, G, window,
                           softcap, scale, stream);
  if (G == 2)
    return launch<T, D, 2>(q, k, v, ap, pos, o, part, B, Sc, KV, G, window,
                           softcap, scale, stream);
  if (G <= 4)
    return launch<T, D, 4>(q, k, v, ap, pos, o, part, B, Sc, KV, G, window,
                           softcap, scale, stream);
  return launch<T, D, 8>(q, k, v, ap, pos, o, part, B, Sc, KV, G, window,
                         softcap, scale, stream);
}

}  // namespace

// The floats of fp32 scratch the launch needs (the wrapper allocates it):
// for each (row, kv head, chunk) GP pairs (m, l), GP x CHUNK scores and
// GP x D of acc.
extern "C" long long decode_attention_scratch(int B, int Sc, int KV, int G,
                                              int D) {
  const int gp = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  return (long long)B * KV * ((Sc + CHUNK - 1) / CHUNK) * gp *
         (2 + CHUNK + D);
}

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launches (0 = cudaSuccess); -1 for a dtype / head dim / group this file
// does not take (the Python wrapper checks these first).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* ap,
                                       const void* pos, void* o, void* part,
                                       int B, int Sc, int KV, int G, int D,
                                       int dtype, int window, float softcap,
                                       float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (G < 1 || G > MAXG || Sc < 1) return -1;
  if (dtype == 1 && D == 128)
    return launch_g<__nv_bfloat16, 128>(q, k, v, ap, pos, o, p, B, Sc, KV, G,
                                        window, softcap, scale, s);
  if (dtype == 1 && D == 64)
    return launch_g<__nv_bfloat16, 64>(q, k, v, ap, pos, o, p, B, Sc, KV, G,
                                       window, softcap, scale, s);
  if (dtype == 0 && D == 128)
    return launch_g<float, 128>(q, k, v, ap, pos, o, p, B, Sc, KV, G, window,
                                softcap, scale, s);
  if (dtype == 0 && D == 64)
    return launch_g<float, 64>(q, k, v, ap, pos, o, p, B, Sc, KV, G, window,
                               softcap, scale, s);
  return -1;
}
