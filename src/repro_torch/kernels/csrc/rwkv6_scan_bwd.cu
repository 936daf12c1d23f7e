// The backward of the chunked RWKV6 scan for Hopper (sm_90a): every
// input's gradient of `rwkv6_scan` (csrc/rwkv6_scan.cu) at the same chunk,
// fp32 in and out.
//
// Replaces: no TPU kernel.  The JAX package differentiates the jnp chunk
// body (src/repro/models/rwkv6.py::timemix_parallel) with autograd and has
// no Pallas backward; this kernel is the port's own, so that a train step
// on the card runs a hand-written kernel both ways.  Its plain version is
// `rwkv6_scan.plain_backward`, whose docstring states the formulas.  Per
// chunk of C rows, walked in reverse with dS (the gradient of the chunk's
// end state) carried, S the chunk's start state, E = A_end:
//   P    = tril_{-1}(rA kA^T),     dP = tril_{-1}(dy v^T)
//   dv   = P^T dy + bonus * dy + (kA * E) dS
//   drA  = dy S^T + dP kA,         dkA = dP^T rA + E * (v dS^T)
//   dE   = rowsum(S * dS) + sum_s kA_s * (v dS^T)_s
//   dr   = drA * A_excl + (dy . v) u * k
//   dk   = (dy . v) r * u + dkA / max(A_incl, 1e-24)
//   dcum = drA r A_excl + [A_incl >= 1e-24] (-dkA kA / A_incl) A_incl
//          + [last row] dE * E
//   dw   = (revcumsum(dcum) - drA r A_excl) / w
//   dS  <- rA^T dy + E * dS
// The start states come from the forward kernel, which writes them when
// asked (its `states` output, (B, H, T / C, D, D)): no recompute here.
//
// What bounds it on this card: at the rwkv6-7b train shape (B = 4, T =
// 1536, H = 64, D = 64, chunk 8) a call reads r, k, v, w, dy (~503 MB)
// and writes dr, dk, dv, dw (~403 MB): ~0.27 ms at 3.35 TB/s; its products
// are ~15 GFLOP (~0.22 ms at the fp32 CUDA-core peak), so bytes bound it,
// with the chunk-start states (~805 MB more) read besides.  The design is
// the simple one: one CTA a (batch, head), 256 threads, walking its chunks
// in reverse; per chunk every tile of the chunk and the (D, D) states S
// and dS in shared memory (rows padded to D + 1 floats, so a column read
// across a warp hits 32 banks), and each product an fp32 loop on the CUDA
// cores, one output element a thread, in seven phases between barriers:
//   (1) load r, k, v, dy, S;  (2) per column the cumsum of log w, A_excl,
//   A_incl, kA and E; per row the bonus and dy . v;  (3) P, dP, v dS^T;
//   (4) dv (to global), drA, dE;  (5) dkA, dS (in place);  (6) dr, dk (to
//   global), dcum and drA r A_excl;  (7) per column the reverse cumsum, dw
//   (to global) and du (a chunk's sum, added over the chunks by Kahan
//   summation).
// A CTA owns a whole head, so the sums over value columns (dr, dk, dw) and
// du's sum over the chunks stay inside it, in a fixed order; du's partials
// over the batch go out as (B, H, D) and the wrapper sums them in order.
// Sums over the value columns of products with dy (dy . v_t, dy_t . v_s,
// dy_t . S_x) are accumulated in fp64, each product rounded to fp32 first:
// the per-head groupnorm's backward makes each dy row orthogonal to its
// output row, so these sums cancel, and a sequential fp32 sum of 64 such
// terms lost up to 4x more than the plain version's blocked one (rwkv6-7b's
// train step on an H100 80GB HBM3: dk and du at 1.3x the limit of
// chip_smoke's rule).  Deterministic: no atomics, no split.  expf / logf
// and IEEE division: built without --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 64;
constexpr int THREADS = 256;
constexpr float EPS = 1e-24f;  // the clamp of kA's divisor

// shared-memory layout, in floats, for chunk C at head dim D
template <int D>
struct Layout {
  static constexpr int PD = D + 1;  // row stride of (C, D) and (D, D) tiles
  int PC, R, K, V, DY, AE, AI, KA, VDS, DRA, P, DP, S, DS, E, DE, BON, DBON,
      U, TOT;
  __host__ __device__ explicit Layout(int C) : PC(C + 1) {
    const int tile = C * PD;
    int o = 0;
    R = o;   o += tile;    // r
    K = o;   o += tile;    // k
    V = o;   o += tile;    // v
    DY = o;  o += tile;    // dy
    AE = o;  o += tile;    // A_excl
    AI = o;  o += tile;    // A_incl
    KA = o;  o += tile;    // kA
    VDS = o; o += tile;    // v dS^T, then dkA, then drA r A_excl
    DRA = o; o += tile;    // drA, then dcum
    P = o;   o += C * PC;  // P (row t, column s)
    DP = o;  o += C * PC;  // dP
    S = o;   o += D * PD;  // the chunk's start state
    DS = o;  o += D * PD;  // the gradient of its end state, then start's
    E = o;   o += D;
    DE = o;  o += D;
    BON = o; o += MAX_C;   // bonus_t = r_t . (u * k_t)
    DBON = o; o += MAX_C;  // dy_t . v_t
    U = o;   o += D;
    TOT = o;
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS)
rwkv6_scan_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ states,
                      const float* __restrict__ dy,
                      const float* __restrict__ dsT, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du_part,
                      float* __restrict__ ds0, int T, int H, int C) {
  extern __shared__ float sm[];
  const Layout<D> L(C);
  constexpr int PD = Layout<D>::PD;
  const int PC = L.PC;
  float* R = sm + L.R;
  float* K = sm + L.K;
  float* V = sm + L.V;
  float* DY = sm + L.DY;
  float* AE = sm + L.AE;
  float* AI = sm + L.AI;
  float* KA = sm + L.KA;
  float* VDS = sm + L.VDS;
  float* DRA = sm + L.DRA;
  float* P = sm + L.P;
  float* DP = sm + L.DP;
  float* S = sm + L.S;
  float* DS = sm + L.DS;
  float* E = sm + L.E;
  float* DE = sm + L.DE;
  float* BON = sm + L.BON;
  float* DBON = sm + L.DBON;
  float* U = sm + L.U;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int NC = T / C;
  const long long ts = (long long)H * D;                 // time stride
  const long long head = (long long)b * T * ts + (long long)h * D;
  const long long bh = (long long)b * H + h;

  for (int i = tid; i < D * D; i += THREADS)
    DS[i / D * PD + i % D] = dsT[bh * D * D + i];
  for (int i = tid; i < D; i += THREADS) U[i] = u[h * D + i];
  // du[tid] for tid < D: each chunk's sum, added over the chunks in order
  // with a compensation term (Kahan), so 1536 rows sum as accurately as
  // the plain version's two-level sum
  float du = 0.f, du_c = 0.f;

  for (int c = NC - 1; c >= 0; --c) {
    const long long row0 = head + (long long)c * C * ts;
    // (1) the chunk's rows and its start state
    for (int i = tid; i < C * D; i += THREADS) {
      const int t = i / D, x = i % D;
      const long long g = row0 + t * ts + x;
      R[t * PD + x] = r[g];
      K[t * PD + x] = k[g];
      V[t * PD + x] = v[g];
      DY[t * PD + x] = dy[g];
    }
    const float* Sg = states + (bh * NC + c) * D * D;
    for (int i = tid; i < D * D; i += THREADS) S[i / D * PD + i % D] = Sg[i];
    __syncthreads();

    // (2) per column x: cum = cumsum log w, A_excl, A_incl, kA, E (as
    //     `plain` forms them); per row t: bonus_t and dy_t . v_t
    if (tid < D) {
      const int x = tid;
      float cum = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = logf(w[row0 + t * ts + x]);
        cum += lw;
        const float ai = expf(cum);
        AE[t * PD + x] = expf(cum - lw);
        AI[t * PD + x] = ai;
        KA[t * PD + x] = K[t * PD + x] / fmaxf(ai, EPS);
      }
      E[x] = AI[(C - 1) * PD + x];
    } else if (tid < D + C) {
      const int t = tid - D;
      double s = 0.0;
      for (int x = 0; x < D; ++x)
        s += (double)(R[t * PD + x] * (U[x] * K[t * PD + x]));
      BON[t] = (float)s;
    } else if (tid < D + 2 * C) {
      const int t = tid - D - C;
      double s = 0.0;
      for (int j = 0; j < D; ++j)
        s += (double)(DY[t * PD + j] * V[t * PD + j]);
      DBON[t] = (float)s;
    }
    __syncthreads();

    // (3) P[t][s] = rA_t . kA_s and dP[t][s] = dy_t . v_s for s < t;
    //     VDS[s][x] = v_s . dS[x]
    for (int i = tid; i < 2 * C * C + C * D; i += THREADS) {
      if (i < 2 * C * C) {
        const bool grad = i >= C * C;
        const int q = grad ? i - C * C : i, t = q / C, s = q % C;
        float acc = 0.f;
        if (s < t) {
          if (grad) {
            double a = 0.0;
            for (int j = 0; j < D; ++j)
              a += (double)(DY[t * PD + j] * V[s * PD + j]);
            acc = (float)a;
          } else {
            for (int x = 0; x < D; ++x)
              acc += (R[t * PD + x] * AE[t * PD + x]) * KA[s * PD + x];
          }
        }
        (grad ? DP : P)[t * PC + s] = acc;
      } else {
        const int q = i - 2 * C * C, s = q / D, x = q % D;
        float acc = 0.f;
        for (int j = 0; j < D; ++j) acc += V[s * PD + j] * DS[x * PD + j];
        VDS[s * PD + x] = acc;
      }
    }
    __syncthreads();

    // (4) dv (to global), drA, dE
    for (int i = tid; i < 2 * C * D + D; i += THREADS) {
      if (i < C * D) {
        const int s = i / D, j = i % D;
        float a = 0.f, st = 0.f;
        for (int t = s + 1; t < C; ++t) a += P[t * PC + s] * DY[t * PD + j];
        for (int x = 0; x < D; ++x)
          st += (KA[s * PD + x] * E[x]) * DS[x * PD + j];
        dv[row0 + s * ts + j] = (a + BON[s] * DY[s * PD + j]) + st;
      } else if (i < 2 * C * D) {
        const int q = i - C * D, t = q / D, x = q % D;
        double a = 0.0;
        float b2 = 0.f;
        for (int j = 0; j < D; ++j)
          a += (double)(DY[t * PD + j] * S[x * PD + j]);
        for (int s = 0; s < t; ++s) b2 += DP[t * PC + s] * KA[s * PD + x];
        DRA[t * PD + x] = (float)a + b2;
      } else {
        const int x = i - 2 * C * D;
        float a = 0.f, b2 = 0.f;
        for (int j = 0; j < D; ++j) a += S[x * PD + j] * DS[x * PD + j];
        for (int s = 0; s < C; ++s) b2 += KA[s * PD + x] * VDS[s * PD + x];
        DE[x] = a + b2;
      }
    }
    __syncthreads();

    // (5) dkA over VDS, element by element; dS <- rA^T dy + E * dS in place
    for (int i = tid; i < C * D + D * D; i += THREADS) {
      if (i < C * D) {
        const int s = i / D, x = i % D;
        float a = 0.f;
        for (int t = s + 1; t < C; ++t)
          a += DP[t * PC + s] * (R[t * PD + x] * AE[t * PD + x]);
        VDS[s * PD + x] = a + E[x] * VDS[s * PD + x];
      } else {
        const int q = i - C * D, x = q / D, j = q % D;
        float a = 0.f;
        for (int t = 0; t < C; ++t)
          a += (R[t * PD + x] * AE[t * PD + x]) * DY[t * PD + j];
        DS[x * PD + j] = a + E[x] * DS[x * PD + j];
      }
    }
    __syncthreads();

    // (6) dr, dk (to global); dcum into DRA, drA r A_excl into VDS
    for (int i = tid; i < C * D; i += THREADS) {
      const int t = i / D, x = i % D, o = t * PD + x;
      const float ra = DRA[o], ka = VDS[o], rr = R[o], kk = K[o];
      const float ae = AE[o], ai = AI[o], m = fmaxf(ai, EPS);
      const long long g = row0 + t * ts + x;
      dr[g] = ra * ae + DBON[t] * (U[x] * kk);
      dk[g] = DBON[t] * rr * U[x] + ka / m;
      const float dae = ra * rr * ae;
      float dcum = dae + (ai >= EPS ? -ka * (KA[o] / m) : 0.f) * ai;
      if (t == C - 1) dcum += DE[x] * E[x];
      DRA[o] = dcum;
      VDS[o] = dae;
    }
    __syncthreads();

    // (7) per column: dlog w = revcumsum(dcum) - drA r A_excl, dw =
    //     dlog w / w; du += sum_t (dy_t . v_t) r_t k_t
    if (tid < D) {
      const int x = tid;
      float run = 0.f;
      for (int t = C - 1; t >= 0; --t) {
        run += DRA[t * PD + x];
        const long long g = row0 + t * ts + x;
        dw[g] = (run - VDS[t * PD + x]) / w[g];
      }
      float part = 0.f;
      for (int t = 0; t < C; ++t)
        part += DBON[t] * R[t * PD + x] * K[t * PD + x];
      const float y = part - du_c, sum = du + y;
      du_c = (sum - du) - y;
      du = sum;
    }
    __syncthreads();
  }
  for (int i = tid; i < D * D; i += THREADS)
    ds0[bh * D * D + i] = DS[i / D * PD + i % D];
  if (tid < D) du_part[bh * D + tid] = du;
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* states, const float* dy,
           const float* dsT, float* dr, float* dk, float* dv, float* dw,
           float* du_part, float* ds0, int B, int T, int H, int C,
           cudaStream_t stream) {
  // above 48 KB only as opted-in dynamic shared memory: opt in once for
  // the largest chunk
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_scan_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        4 * Layout<D>(MAX_C).TOT);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  rwkv6_scan_bwd_kernel<D><<<dim3(H, B), THREADS, 4 * Layout<D>(C).TOT,
                             stream>>>(r, k, v, w, u, states, dy, dsT, dr, dk,
                                       dv, dw, du_part, ds0, T, H, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every tensor contiguous fp32: r, k, v, w, dy, dr, dk, dv, dw (B, T, H,
// D); u (H, D); states (B, H, T / C, D, D), the forward's chunk-start
// states; dsT and ds0 (B, H, D, D); du_part (B, H, D), one partial of du a
// batch row.  Returns the cudaError_t of the launch (0 = cudaSuccess), -1
// for a shape this file does not take (the Python wrapper checks first).
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* states, const void* dy, const void* dsT,
    void* dr, void* dk, void* dv, void* dw, void* du_part, void* ds0, int B,
    int T, int H, int D, int C, void* stream) {
  if (B < 1 || T < 1 || H < 1 || C < 1 || C > MAX_C || T % C) return -1;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define RWKV6_BWD_CASE(d)                                                    \
  if (D == d)                                                                \
    return launch<d>(                                                        \
        static_cast<const float*>(r), static_cast<const float*>(k),          \
        static_cast<const float*>(v), static_cast<const float*>(w),          \
        static_cast<const float*>(u), static_cast<const float*>(states),     \
        static_cast<const float*>(dy), static_cast<const float*>(dsT),       \
        static_cast<float*>(dr), static_cast<float*>(dk),                    \
        static_cast<float*>(dv), static_cast<float*>(dw),                    \
        static_cast<float*>(du_part), static_cast<float*>(ds0), B, T, H, C,  \
        cs);
  RWKV6_BWD_CASE(16)
  RWKV6_BWD_CASE(32)
  RWKV6_BWD_CASE(64)
#undef RWKV6_BWD_CASE
  return -1;
}
