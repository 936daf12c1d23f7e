// Paged flash-decode for Hopper (sm_90a): one query token per batch row
// against shared K/V page pools addressed through a page table.
//
// Replaces: src/repro/kernels/decode_attention.py::paged_decode_attention
// (the Pallas TPU kernel `_paged_kernel`).  Same function: fp32 softmax
// over the row's pages in logical page order; a page that is unmapped (-1),
// lies wholly beyond the decode position, or falls outside the window is
// skipped; a slot is valid iff its position ap <= pos, and ap > pos - window
// when there is a window; tanh softcap; p is rounded to T before the P V
// product, as the Pallas body rounds exp(s - m) to v.dtype.  GQA: a CTA
// takes the G query heads of one kv head together, so each K/V page is read
// once per group.  A row with no live page (every page dead, or a window
// that holds no mapped page) writes exactly 0, as the Pallas kernel does.
//
// What bounds it on this card: bytes.  A decode step reads every live K/V
// page once (4 rows at position ~1000 of llama-1.5b is 16.5 MB per layer)
// at ~2 FLOP per byte, far below the H100's ~295 FLOP/byte ridge.  The
// Pallas kernel walks a row's pages as a sequential grid axis carrying
// m/l/acc in VMEM; here the pages are split across CTAs and two launches
// share the work:
//   * paged_partials, grid (KV, B, splits), reads K and V: the CTA takes a
//     fixed run of `pages` logical pages, max(1, SLOTS / ps) of them, so at
//     most SLOTS = 128 slots (8 pages at ps = 16).  The run depends on NP
//     and ps only (the wrapper's pure rule `paged_split`), never on the
//     positions, which stay on the device: nothing syncs with the host.  The
//     CTA loads its own page ids (there is no scalar prefetch); a CTA whose
//     slots are all dead or beyond pos writes l = 0 and exits at once.  A
//     live CTA holds every slot of its run in registers at once, takes its
//     max m over the valid scores, p = exp(s - m) (l sums p unrounded; P V
//     takes p rounded to T), and writes the partial (m, l, acc[G][D]) to
//     fp32 scratch that the wrapper allocates.
//   * paged_combine, grid (KV, B), a programmatic dependent launch: the
//     row's M = the max m over the splits with l > 0, then in split order
//     L = sum l e^(m - M) and A = sum acc e^(m - M), skipping splits with
//     l = 0, and o = A / L; a row with no live split sums nothing and
//     writes exactly 0.
// At the timed shape (B=4, KV=8, NP=128, ps=16, positions ~1000) the split
// grid is 512 CTAs, about 256 of them live: ~2 per SM, where one CTA per
// (kv head, row) gave 32 CTAs on 132 SMs.  Loads are 16 bytes a lane: a
// bf16 slot row of one kv head at D=128 is 256 contiguous bytes inside its
// page (consecutive slots sit KV * D elements apart), taken by 16 lanes, so
// a warp reads two slots per instruction, and each thread issues the loads
// of all its K and V slots (8 each at bf16 D=128) before it uses the first.
// A score reduces over the lanes of its slot (4 shuffles at bf16 D=128).
// Every sum runs in a fixed order and there are no atomics: the kernel is
// deterministic, and row b's output depends only on row b's inputs and NP.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLOTS = 128;   // slots per CTA at most (paged_split's)
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

template <typename T, int D>
struct Lanes {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int LPS = D / VEC;         // lanes per slot row
  static constexpr int SPW = 32 / LPS;        // slots per warp load
  static constexpr int SPR = NW * SPW;        // slots per CTA round
  static constexpr int NR = SLOTS / SPR;      // rounds per CTA
};

// GP: the group size rounded up to a power of two (the register arrays'
// extent); G <= GP is the real one.  Scratch, per (row, kv head, split):
// G pairs (m, l) in part_ml, G x D of acc in part_acc.
template <typename T, int D, int GP>
__global__ void __launch_bounds__(NW * 32)
paged_partials(const T* __restrict__ q, const T* __restrict__ kpool,
               const T* __restrict__ vpool,
               const int* __restrict__ page_table,
               const int* __restrict__ positions, float* __restrict__ part_ml,
               float* __restrict__ part_acc, int NP, int ps, int pages,
               int KV, int G, int window, float softcap, float scale) {
  using L = Lanes<T, D>;
  __shared__ int rows[SLOTS];         // pool row (page * ps + s), -1: none
  __shared__ float pr[GP][SLOTS];     // scores, then p rounded to T
  __shared__ float red[NW][GP][D];    // per-warp partial acc
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / L::LPS, e0 = (lane % L::LPS) * L::VEC;
  const int in_round = warp * L::SPW + sub;
  const long long pidx = ((long long)b * KV + kvh) * gridDim.z + split;
  float* ml = part_ml + pidx * G * 2;
  start_next();   // paged_combine's CTAs may be scheduled now

  // thread i < SLOTS: slot i of the run, page i / ps of it.  The page id
  // load does not wait for pos.
  bool any = false;
  if (threadIdx.x < SLOTS) {
    const int lp = threadIdx.x / ps, s = threadIdx.x - lp * ps;
    const int j = split * pages + lp;
    const bool in_run = lp < pages && j < NP;
    const int page = in_run ? page_table[(long long)b * NP + j] : -1;
    const int pos = positions[b];
    const int ap = j * ps + s;
    const bool ok = page >= 0 && ap <= pos && (!window || ap > pos - window);
    rows[threadIdx.x] = ok ? page * ps + s : -1;
    any = ok;
  }
  if (!__syncthreads_or(any)) {
    if (threadIdx.x < G) {   // nothing valid: an empty partial
      ml[threadIdx.x * 2] = NEG_INF;
      ml[threadIdx.x * 2 + 1] = 0.f;
    }
    return;
  }

  // every K and V load of this thread in flight before the first is used
  const long long row_stride = (long long)KV * D;   // one slot of a page
  const T* kb = kpool + (long long)kvh * D + e0;
  const T* vb = vpool + (long long)kvh * D + e0;
  int rr[L::NR];
  uint4 kv[L::NR], vv[L::NR];
#pragma unroll
  for (int r = 0; r < L::NR; ++r) rr[r] = rows[r * L::SPR + in_round];
#pragma unroll
  for (int r = 0; r < L::NR; ++r)
    kv[r] = rr[r] >= 0
                ? *reinterpret_cast<const uint4*>(kb + rr[r] * row_stride)
                : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int r = 0; r < L::NR; ++r)
    vv[r] = rr[r] >= 0
                ? *reinterpret_cast<const uint4*>(vb + rr[r] * row_stride)
                : make_uint4(0u, 0u, 0u, 0u);
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
        pr[g][r * L::SPR + in_round] = rr[r] >= 0 ? x : NEG_INF;
    }
  }
  __syncthreads();

  // the run's max m, p = exp(s - m) and l = sum p, one warp per query head
  // of the group; p goes back rounded to T for P V
  if (warp < G) {
    constexpr int PL = SLOTS / 32;
    float x[PL];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      x[i] = pr[warp][i * 32 + lane];
      mx = fmaxf(mx, x[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const float p = x[i] > NEG_INF ? expf(x[i] - mx) : 0.f;
      sum += p;
      pr[warp][i * 32 + lane] = to_f(from_f<T>(p));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      ml[warp * 2] = mx;
      ml[warp * 2 + 1] = sum;
    }
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
  float* out = part_acc + pidx * G * D;
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += red[w][g][d];
    out[i] = a;
  }
}

// One thread per (query head of the group, element): the splits merged in
// split order.
template <typename T>
__global__ void paged_combine(const float* __restrict__ part_ml,
                              const float* __restrict__ part_acc,
                              T* __restrict__ o, int KV, int G, int D,
                              int splits) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int g = threadIdx.x / D, d = threadIdx.x % D;
  wait_for_previous();
  const long long p0 = ((long long)b * KV + kvh) * splits;
  const float* ml = part_ml + (p0 * G + g) * 2;
  const float* acc = part_acc + p0 * G * D + g * D + d;
  float M = NEG_INF;
  for (int ci = 0; ci < splits; ++ci)
    if (ml[ci * G * 2 + 1] > 0.f) M = fmaxf(M, ml[ci * G * 2]);
  // the loads unconditional (an empty split's acc is never written, and is
  // selected away), so the loads of several splits are in flight
  float Ls = 0.f, A = 0.f;
#pragma unroll 8
  for (int ci = 0; ci < splits; ++ci) {
    const float m = ml[ci * G * 2], l = ml[ci * G * 2 + 1];
    const float a = acc[(long long)ci * G * D];
    const float c = l > 0.f ? expf(m - M) : 0.f;
    Ls += l > 0.f ? l * c : 0.f;
    A += l > 0.f ? a * c : 0.f;
  }
  // a row with no live split sums nothing: 0 / 1e-30, exactly 0
  o[((long long)b * KV * G + (long long)kvh * G + g) * D + d] =
      from_f<T>(A / fmaxf(Ls, 1e-30f));
}

template <typename T, int D, int GP>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* pt, const void* pos, void* o, float* part, int B,
           int NP, int ps, int pages, int KV, int G, int window,
           float softcap, float scale, cudaStream_t stream) {
  const int splits = (NP + pages - 1) / pages;
  float* part_ml = part;
  float* part_acc = part_ml + (size_t)B * KV * splits * G * 2;
  cudaError_t e;
  if (splits > 0) {   // an empty table (NP = 0) leaves the combine alone: 0
    paged_partials<T, D, GP><<<dim3(KV, B, splits), NW * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kpool),
        static_cast<const T*>(vpool), static_cast<const int*>(pt),
        static_cast<const int*>(pos), part_ml, part_acc, NP, ps, pages, KV,
        G, window, softcap, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KV, B);
  cfg.blockDim = dim3(G * D);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_combine<T>,
                         static_cast<const float*>(part_ml),
                         static_cast<const float*>(part_acc),
                         static_cast<T*>(o), KV, G, D, splits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(const void* q, const void* k, const void* v, const void* pt,
             const void* pos, void* o, float* part, int B, int NP, int ps,
             int pages, int KV, int G, int window, float softcap,
             float scale, cudaStream_t stream) {
  if (G == 1)
    return launch<T, D, 1>(q, k, v, pt, pos, o, part, B, NP, ps, pages, KV,
                           G, window, softcap, scale, stream);
  if (G == 2)
    return launch<T, D, 2>(q, k, v, pt, pos, o, part, B, NP, ps, pages, KV,
                           G, window, softcap, scale, stream);
  if (G <= 4)
    return launch<T, D, 4>(q, k, v, pt, pos, o, part, B, NP, ps, pages, KV,
                           G, window, softcap, scale, stream);
  return launch<T, D, 8>(q, k, v, pt, pos, o, part, B, NP, ps, pages, KV, G,
                         window, softcap, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `pages` is the run of pages per CTA
// (the wrapper's paged_split); `part` is fp32 scratch of
// B * KV * ceil(NP / pages) * G * (2 + D) floats.  Returns the cudaError_t
// of the launches (0 = cudaSuccess); -1 for a dtype / head dim / group /
// page size / run this file does not take (the wrapper checks these first).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* kpool, const void* vpool, const void* pt,
    const void* pos, void* o, void* part, int B, int NP, int ps, int pages,
    int KV, int G, int D, int dtype, int window, float softcap, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (G < 1 || G > MAXG || ps < 1 || ps > 32 || NP < 0 || pages < 1 ||
      pages * ps > SLOTS)
    return -1;
  if (dtype == 1 && D == 128)
    return launch_g<__nv_bfloat16, 128>(q, kpool, vpool, pt, pos, o, p, B, NP,
                                        ps, pages, KV, G, window, softcap,
                                        scale, s);
  if (dtype == 1 && D == 64)
    return launch_g<__nv_bfloat16, 64>(q, kpool, vpool, pt, pos, o, p, B, NP,
                                       ps, pages, KV, G, window, softcap,
                                       scale, s);
  if (dtype == 0 && D == 128)
    return launch_g<float, 128>(q, kpool, vpool, pt, pos, o, p, B, NP, ps,
                                pages, KV, G, window, softcap, scale, s);
  if (dtype == 0 && D == 64)
    return launch_g<float, 64>(q, kpool, vpool, pt, pos, o, p, B, NP, ps,
                               pages, KV, G, window, softcap, scale, s);
  return -1;
}
