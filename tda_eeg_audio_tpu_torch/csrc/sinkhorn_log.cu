// Un-tiered log-domain H1 Sinkhorn of the staged path and the control's exact
// redo for sm_90a: the epsilon-annealed entropic OT cost <P, D> on persim's
// cost matrix, one block per diagram pair at the pair's own width, the cost
// matrix never stored.
//
// Replaces no Pallas kernel.  The JAX package computes the same function as
// XLA code: `tda_eeg_audio_tpu/ops/wasserstein.py::sinkhorn_cost` (:93, one
// jitted `lax.fori_loop` a rung, :128) over `build_cost_matrix` (:31), 512
// pairs a call at the staged pad width K = 128 (S = 256).  The port's plain
// version (`ops/wasserstein.py::sinkhorn_cost_pairs` on a CPU tensor) runs it
// as a Python loop of 480 logsumexp half-steps, each over a materialised
// (512, 256, 256) float32 tensor.
//
// Per pair (one block of 128 threads):
//   1. warps 0 and 1 move the valid bars of side 1 and side 2 to the front of
//      shared memory, in order, as float64 (b, d and h = (d - b) / 2); an
//      empty side becomes the single [[0, 0]] bar (persim's sentinel,
//      reference scripts/utils.py:186-187).  S = n1 + n2.  At the pad width
//      the pad rows and columns are forced zero-cost pad<->pad matches whose
//      entries against a real slot are exp(-1e3 * scale / eps) = 0 exactly in
//      float32, so the pair's own width changes nothing but rounding;
//   2. blocker = max over the bars of the L-inf distance, blocker2 = max(
//      blocker, side 1's largest h, and 0 if side 1 has pad slots), both
//      propagating NaN as torch.amax / torch.maximum do; scale = the largest
//      real entry (< 1e8, compared in float64), at least 1e-9, rounded to
//      float32 as the plain version's;
//   3. each entry of the cost matrix is computed when it is used:
//        rows [side-1 bars | side-2 helpers] x columns [side-2 bars | side-1 slots]
//        bar i, bar c:       max(|b1_i - b2_c|, |d1_i - d2_c|)
//        bar i, slot k:      k == i ? h1_i : blocker
//        helper j, bar c:    c == j ? h2_c : blocker2
//        helper j, slot k:   0
//      and Dm = D where real, 1e3 * scale elsewhere;
//   4. the ladder: eps = rel[s] * scale (float32, as the plain version's), s
//      < steps, `iters` iterations a rung of
//        f_i = -eps logsumexp_c((g_c - Dm_ic) / eps)   (a thread a row)
//        g_c = -eps logsumexp_i((f_i - Dm_ic) / eps)   (a thread a column)
//      each logsumexp one pass over its row or column, online in chunks of
//      8 entries: the chunk's largest exponent rescales the running sum when
//      it exceeds the running max, then the chunk's 8 expf terms are summed
//      in float32 and added to the float64 sum;
//   5. out[p] = sum over real entries of exp((f_i + g_c - D_ic) / (eps_lo *
//      scale)) * D_ic, each thread's rows in float64, then the block's
//      threads in a fixed order.
//
// Arithmetic: the bars, the costs, the duals f and g (shared memory), every
// exponent and the running sums are float64; each exp is expf of the
// exponent rounded to float32.  A float32 dual's last bit over eps_lo = 1e-4
// * scale moves <P, D> by up to ~3e-4 of its value (measured on the tiered
// kernel, PERF.md), so the duals are float64, and the kernel sits near a
// float64 run of the ladder; what separates it from the plain float32
// version is the plain version's own rounding.  No --use_fast_math and no
// -ftz=true (ops/cuda_build.NVCC_FLAGS).
//
// What bounds it: 480 half-steps of S^2 expf a pair (6 rungs x 40
// iterations x 2) and S^2 more for the result, at the SM's 16 expf a clock.
// The bars in and 4 bytes out a pair are far below.  The design spends
// ~7 float64 operations an entry around each expf (the cost, the exponent,
// the chunk max), at 64 an SM and clock, so its floor is about twice the expf
// bound.  One thread a row (a column) walks the row serially, so a pair's
// time is ceil(S / 128) rows x S entries x 481 passes of one thread's chain;
// small pairs leave threads of their block idle.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsinkhorn_log.so sinkhorn_log.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 128;          // slots a side
constexpr int MAX_S = 2 * MAX_K;    // n1 + n2
constexpr int CHUNK = 8;            // entries a step of the online logsumexp
constexpr int MAX_STEPS = 16;
constexpr double REAL_BELOW = 1e8;  // real = D < 1e8; build_cost_matrix's 1e9 is not

struct Ladder {
  float rel[MAX_STEPS];  // eps_hi * (eps_lo / eps_hi) ** (s / (steps - 1)), rounded to float32
  float lo;              // eps_lo
  int steps, iters;
};

struct Args {
  const float *b1, *d1, *b2, *d2;
  const uint8_t *m1, *m2;
  int K1, K2, n_pairs;
  float* out;
};

struct Smem {
  double f[MAX_S], g[MAX_S];
  double b1[MAX_K], d1[MAX_K], h1[MAX_K], b2[MAX_K], d2[MAX_K], h2[MAX_K];
  double red[WARPS];
  int n1, n2;
};

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ double nanmax(double a, double b) { return (a > b || a != a) ? a : b; }

// every thread gets the block's reduction of x (NANMAX: nanmax, else the sum)
// in a fixed order: a butterfly in each warp, then the warps in order
template <bool NANMAX>
__device__ __forceinline__ double block_reduce(double x, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double y = __shfl_xor_sync(FULL, x, o);
    x = NANMAX ? nanmax(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = NANMAX ? nanmax(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// one warp: the valid bars of one side to the front, in order, as float64;
// [[0, 0]] if none.  *n = the bars kept (at least 1)
__device__ __forceinline__ void compact(const float* b, const float* d, const uint8_t* m, int K,
                                        int lane, double* sb, double* sd, double* sh, int* n) {
  int base = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const bool valid = k < K && m[k];
    const unsigned bal = __ballot_sync(FULL, valid);
    if (valid) {
      const int pos = base + __popc(bal & ((1u << lane) - 1u));
      const double bb = b[k], dd = d[k];
      sb[pos] = bb;
      sd[pos] = dd;
      sh[pos] = 0.5 * (dd - bb);
    }
    base += __popc(bal);
  }
  if (lane == 0) {
    if (base == 0) sb[0] = sd[0] = sh[0] = 0.0;
    *n = base > 0 ? base : 1;
  }
}

// One chunk of a logsumexp pass: x[0, CHUNK) exponents (-inf past the end).
// The running max m and float64 sum s of exp(x - m).
__device__ __forceinline__ void lse_chunk(const double (&x)[CHUNK], double& m, double& s) {
  double cm = x[0];
#pragma unroll
  for (int q = 1; q < CHUNK; ++q) cm = fmax(cm, x[q]);
  if (cm > m) {
    s *= (double)expf((float)(m - cm));
    m = cm;
  }
  float cs = 0.0f;
#pragma unroll
  for (int q = 0; q < CHUNK; ++q) cs += expf((float)(x[q] - m));
  s += (double)cs;
}

// The entries e < n of one segment of a row (column): exponents (dual[e] -
// Dm(cost(e))) * inv_eps, online into (m, s).
template <class Cost>
__device__ __forceinline__ void lse_run(int n, const double* dual, double inv_eps, double big_m,
                                        Cost cost, double& m, double& s) {
  for (int e0 = 0; e0 < n; e0 += CHUNK) {
    double x[CHUNK];
#pragma unroll
    for (int q = 0; q < CHUNK; ++q) {
      const int e = e0 + q;
      if (e < n) {
        const double D = cost(e);
        x[q] = (dual[e] - (D < REAL_BELOW ? D : big_m)) * inv_eps;
      } else {
        x[q] = -INFINITY;
      }
    }
    lse_chunk(x, m, s);
  }
}

// The entries e < n of one segment of row i for the result: sum of
// exp((f_i + dual[e] - D) * inv_lo) * D over real entries
template <class Cost>
__device__ __forceinline__ double cost_run(int n, double fi, const double* dual, double inv_lo,
                                           Cost cost) {
  double acc = 0.0;
  for (int e = 0; e < n; ++e) {
    const double D = cost(e);
    if (D < REAL_BELOW) acc += (double)expf((float)((fi + dual[e] - D) * inv_lo)) * D;
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS) sinkhorn_log_kernel(Args a, Ladder lad) {
  __shared__ Smem sm;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int p = blockIdx.x;

  // 1. compacted bars, the sentinel for an empty side
  if (w == 0)
    compact(a.b1 + (size_t)p * a.K1, a.d1 + (size_t)p * a.K1, a.m1 + (size_t)p * a.K1, a.K1, lane,
            sm.b1, sm.d1, sm.h1, &sm.n1);
  else if (w == 1)
    compact(a.b2 + (size_t)p * a.K2, a.d2 + (size_t)p * a.K2, a.m2 + (size_t)p * a.K2, a.K2, lane,
            sm.b2, sm.d2, sm.h2, &sm.n2);
  __syncthreads();
  const int n1 = sm.n1, n2 = sm.n2, S = n1 + n2;

  // 2. blocker, blocker2, scale
  double blk = 0.0, h1max = -INFINITY, top = 0.0;
  for (int e = t; e < n1 * n2; e += THREADS) {
    const int i = e / n2, c = e - i * n2;
    const double D = nanmax(fabs(sm.b1[i] - sm.b2[c]), fabs(sm.d1[i] - sm.d2[c]));
    blk = nanmax(blk, D);
    if (D < REAL_BELOW) top = fmax(top, D);
  }
  for (int i = t; i < n1; i += THREADS) {
    h1max = nanmax(h1max, sm.h1[i]);
    if (sm.h1[i] < REAL_BELOW) top = fmax(top, sm.h1[i]);
  }
  for (int c = t; c < n2; c += THREADS)
    if (sm.h2[c] < REAL_BELOW) top = fmax(top, sm.h2[c]);
  const double blocker = block_reduce<true>(blk, sm.red);
  h1max = block_reduce<true>(h1max, sm.red);
  if (n1 < a.K1) h1max = nanmax(h1max, 0.0);  // side 1's pad slots count 0
  const double blocker2 = nanmax(blocker, h1max);
  // every real entry beyond these is blocker, blocker2 (each one of them or
  // NaN) or 0
  const float scale = fmaxf((float)block_reduce<true>(top, sm.red), 1e-9f);
  const double big_m = (double)(1e3f * scale);
  for (int i = t; i < S; i += THREADS) sm.f[i] = sm.g[i] = 0.0;
  __syncthreads();

  // 4. the ladder
  for (int s = 0; s < lad.steps; ++s) {
    const double eps = (double)(lad.rel[s] * scale);
    const double inv = 1.0 / eps;
    for (int it = 0; it < lad.iters; ++it) {
      for (int i = t; i < S; i += THREADS) {  // rows: f
        double m = -INFINITY, acc = 0.0;
        if (i < n1) {
          const double rb = sm.b1[i], rd = sm.d1[i], rh = sm.h1[i];
          lse_run(n2, sm.g, inv, big_m, [&](int c) {
            return nanmax(fabs(rb - sm.b2[c]), fabs(rd - sm.d2[c])); }, m, acc);
          lse_run(n1, sm.g + n2, inv, big_m, [&](int k) { return k == i ? rh : blocker; }, m, acc);
        } else {
          const int j = i - n1;
          lse_run(n2, sm.g, inv, big_m, [&](int c) { return c == j ? sm.h2[c] : blocker2; }, m, acc);
          lse_run(n1, sm.g + n2, inv, big_m, [](int) { return 0.0; }, m, acc);
        }
        sm.f[i] = -eps * (m + log(acc));
      }
      __syncthreads();
      for (int c = t; c < S; c += THREADS) {  // columns: g
        double m = -INFINITY, acc = 0.0;
        if (c < n2) {
          const double cb = sm.b2[c], cd = sm.d2[c], ch = sm.h2[c];
          lse_run(n1, sm.f, inv, big_m, [&](int r) {
            return nanmax(fabs(sm.b1[r] - cb), fabs(sm.d1[r] - cd)); }, m, acc);
          lse_run(n2, sm.f + n1, inv, big_m, [&](int j) { return j == c ? ch : blocker2; }, m, acc);
        } else {
          const int k = c - n2;
          const double ch = sm.h1[k];
          lse_run(n1, sm.f, inv, big_m, [&](int r) { return r == k ? ch : blocker; }, m, acc);
          lse_run(n2, sm.f + n1, inv, big_m, [](int) { return 0.0; }, m, acc);
        }
        sm.g[c] = -eps * (m + log(acc));
      }
      __syncthreads();
    }
  }

  // 5. <P, D> over the real entries
  const double inv_lo = 1.0 / (double)(lad.lo * scale);
  double part = 0.0;
  for (int i = t; i < S; i += THREADS) {
    const double fi = sm.f[i];
    if (i < n1) {
      const double rb = sm.b1[i], rd = sm.d1[i], rh = sm.h1[i];
      part += cost_run(n2, fi, sm.g, inv_lo, [&](int c) {
        return nanmax(fabs(rb - sm.b2[c]), fabs(rd - sm.d2[c])); });
      part += cost_run(n1, fi, sm.g + n2, inv_lo, [&](int k) { return k == i ? rh : blocker; });
    } else {
      const int j = i - n1;
      part += cost_run(n2, fi, sm.g, inv_lo, [&](int c) { return c == j ? sm.h2[c] : blocker2; });
    }  // helper x slot entries cost 0
  }
  const double total = block_reduce<false>(part, sm.red);
  if (t == 0) a.out[p] = (float)total;
}

}  // namespace

// The kernel as this library builds it: threads a block, static shared
// bytes, registers and local (spill) bytes a thread, blocks an SM by the
// card's occupancy calculator.  Returns a cudaError_t.
extern "C" int sinkhorn_log_layout(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, sinkhorn_log_kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sinkhorn_log_kernel, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = THREADS;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = blocks;
  return 0;
}

// One call over n_pairs pairs, each side (n_pairs, K) float32 births and
// deaths and uint8 masks, contiguous, 1 <= K <= 128; eps_rel holds `steps`
// float32 rungs; out (n_pairs,) float32.  One launch on `stream`, a block a
// pair; returns the cudaError_t of the launch.
extern "C" int sinkhorn_log_launch(const float* b1, const float* d1, const uint8_t* m1, int K1,
                                   const float* b2, const float* d2, const uint8_t* m2, int K2,
                                   int n_pairs, const float* eps_rel, int steps, float eps_lo,
                                   int iters, float* out, void* stream) {
  if (n_pairs < 1 || K1 < 1 || K2 < 1 || K1 > MAX_K || K2 > MAX_K || steps < 1 ||
      steps > MAX_STEPS || iters < 0)
    return (int)cudaErrorInvalidValue;
  Ladder lad{};
  for (int s = 0; s < steps; ++s) lad.rel[s] = eps_rel[s];
  lad.lo = eps_lo;
  lad.steps = steps;
  lad.iters = iters;
  const Args a{b1, d1, b2, d2, m1, m2, K1, K2, n_pairs, out};
  sinkhorn_log_kernel<<<n_pairs, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, lad);
  return (int)cudaGetLastError();
}
