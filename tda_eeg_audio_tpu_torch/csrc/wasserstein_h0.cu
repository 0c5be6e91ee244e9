// Exact H0 Wasserstein of the comparison stage for sm_90a: persim's distance
// between two H0 diagrams (every birth 0), one warp per pair, the sorts, the
// column sums and the alignment DP in one launch.
//
// Replaces no Pallas kernel.  The JAX package computes the same function as
// XLA code: `tda_eeg_audio_tpu/ops/wasserstein.py::wasserstein_h0_exact`
// (:190), two sorts and one `lax.scan` over the rows (:234) whose step is an
// `associative_scan` min (:231).  The port's plain version
// (`ops/wasserstein.py::wasserstein_h0_exact_plain`) runs it as a Python loop
// over the K1 rows, ten small ops a row: ~460 launches a comparison batch.
//
// Per pair (one warp):
//   1. a = sort(where(m1, d1, 0)), b = sort(where(m2, d2, 0)), ascending, in
//      registers: lane l holds slots 4 l + [0, 4) of a side as sort keys (the
//      value's bits made monotone, -0.0 taken as +0.0 and every NaN as the
//      one +NaN, last: torch's and JAX's order of values; slots past K hold
//      the largest key), a bitonic network over the next power of two >= K
//      slots sorts them (distances 1 and 2 within a lane's registers, the
//      others by __shfl_xor_sync), and each sorted key goes back to its value
//      in shared memory.  A sort of values alone: the order of equal keys
//      cannot change the result, and the sign of a zero never reaches it (no
//      sum or min of the DP meets -0.0 + -0.0);
//   2. bcol = [0, b], cumw = cumsum(bcol / 2), rounded to float32 a prefix:
//      torch's CPU cumsum accumulates the float32 halves in float64 and
//      rounds each prefix once, and the kernel must give its bits.  Lane l
//      sums its columns j = 5 l + [0, 5) in float64, a warp scan (shuffles)
//      adds the lanes before it.  The halves are float32, so every partial
//      sum, in any order, is a multiple of the smallest half's ulp and below
//      K2 times the largest half's binade: when their exponents span at most
//      29 - ceil(log2 K2) (22 at K2 = 128), each partial sum is exact in
//      float64 and the scan's prefixes are the sequential ones bit for bit
//      (infinities and NaN give the same result in any order).  A pair
//      whose halves span more (a 1e-9 death beside deaths of ~1) takes lane
//      0's sequential sum in column order, the plain loop's;
//   3. K1 rows: lane l holds columns j = 5 l + [0, 5) of the row in registers
//      (K2 + 1 <= 160);
//        c_j = min(row_{j-1} + |a_i - bcol_j|, row_j + a_i / 2),  c_0 = row_0 + a_i / 2
//        row_j = cumw_j + cummin_{k <= j}(c_k - cumw_k)
//      row_{j-1} of lane l's first column comes from lane l - 1 by a
//      shuffle; the prefix min is each lane's in order, then a warp scan of
//      the lanes' minima by shuffles.  A min has no rounding, so the order of
//      the scan changes nothing: every float32 operation is the plain
//      version's.  min propagates NaN, as torch.minimum and torch.cummin do;
//   4. out[p] = row_{K2}.
//
// What bounds it: the bytes, each death and mask read once and one float
// written a pair — 4 MB, ~1.2 us at 3.35 TB/s, for a comparison batch of 64
// recordings (4,800 pairs of 46 and 123 slots) — and the operations, K1 (K2
// + 1) cells of ~8 float32 operations and the sorts' K log2 K compares,
// ~3.3 us at 67 TFLOP/s.  A warp's instructions a pair are the two sorts' 21 + 28
// network steps (4 compares a lane each), the scan and K1 rows of ~40
// instructions; a call is one launch with nothing in front of it (no
// torch.sort, no cumsum, no copy: the kernel reads rows through their
// strides).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwasserstein_h0.so wasserstein_h0.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;          // pairs a block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_K = 128;        // slots a side
constexpr int PER = MAX_K / 32;   // sort keys a lane
constexpr int COLS = 5;           // row columns a lane: 32 * 5 >= MAX_K + 1
constexpr uint32_t PAD_KEY = 0xffffffffu;  // above every value's key, NaN's included

struct Args {
  const float *d1, *d2;
  const uint8_t *m1, *m2;
  long long s_d1, s_m1, s_d2, s_m2;  // row strides, in elements
  int K1, K2, n_pairs;
  float* out;
};

// torch.minimum / cummin: NaN if either is NaN
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }

// the sort key of a value: monotone in the value, -0.0 = +0.0, every NaN the
// one +NaN above +inf
__device__ __forceinline__ uint32_t sort_key(float x) {
  uint32_t u = x != x ? 0x7fc00000u : (x == 0.0f ? 0u : __float_as_uint(x));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the value of a key (sort_key's inverse on the values it yields)
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// keys x < y in ascending (up) or descending order
__device__ __forceinline__ void order(uint32_t& x, uint32_t& y, bool up) {
  const uint32_t lo = min(x, y), hi = max(x, y);
  x = up ? lo : hi;
  y = up ? hi : lo;
}

// one side of a pair into `sorted` (K values, ascending): where(m, d, 0).
// Slot s = 4 lane + q is key v[q]; a bitonic network over n = the next power
// of two >= K slots
__device__ __forceinline__ void sort_side(const float* d, const uint8_t* m, int K, int lane,
                                          float* sorted) {
  uint32_t v[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int s = PER * lane + q;
    v[q] = s < K ? sort_key(m[s] ? d[s] : 0.0f) : PAD_KEY;
  }
  int n = 1;
  while (n < K) n <<= 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= PER) {  // the partner is lane ^ (j / PER), same register
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          const int s = PER * lane + q;
          const uint32_t o = __shfl_xor_sync(FULL, v[q], j / PER);
          const bool keep_min = ((s & k) == 0) == ((s & j) == 0);
          v[q] = keep_min ? min(v[q], o) : max(v[q], o);
        }
      } else if (j == 2) {  // registers q, q + 2
        const bool up = ((PER * lane) & k) == 0;
        order(v[0], v[2], up);
        order(v[1], v[3], up);
      } else {  // registers q, q + 1
        order(v[0], v[1], ((PER * lane) & k) == 0);
        order(v[2], v[3], ((PER * lane + 2) & k) == 0);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q)
    if (PER * lane + q < K) sorted[PER * lane + q] = key_value(v[q]);
}

// the biased exponent a half's ulp and binade are counted in: max(E, 1)
__device__ __forceinline__ int half_exp(float h) {
  const int e = (__float_as_uint(h) >> 23) & 0xff;
  return e > 1 ? e : 1;
}

__global__ void __launch_bounds__(THREADS) wasserstein_h0_kernel(Args a) {
  __shared__ float s_a[WARPS][MAX_K];
  __shared__ float s_b[WARPS][MAX_K];
  __shared__ float s_cw[WARPS][MAX_K + 1];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p = blockIdx.x * WARPS + w;
  if (p >= a.n_pairs) return;  // a whole warp: no shuffle or barrier left behind
  const int K1 = a.K1, K2 = a.K2;

  // 1. both sides sorted into shared memory
  sort_side(a.d1 + p * a.s_d1, a.m1 + p * a.s_m1, K1, lane, s_a[w]);
  sort_side(a.d2 + p * a.s_d2, a.m2 + p * a.s_m2, K2, lane, s_b[w]);
  __syncwarp();

  // 2. this lane's columns: bcol and cumw (column sums, float64, one
  // rounding a prefix); columns past K2 hold zeros and never reach column
  // K2's prefix
  float bc[COLS], cw[COLS];
  int e_hi = 0, e_lo = 255;
#pragma unroll
  for (int q = 0; q < COLS; ++q) {
    const int j = COLS * lane + q;
    bc[q] = j > 0 && j <= K2 ? s_b[w][j - 1] : 0.0f;
    const float h = bc[q] / 2.0f;
    if (h != 0.0f && isfinite(h)) {
      e_hi = max(e_hi, half_exp(h));
      e_lo = min(e_lo, half_exp(h));
    }
  }
  e_hi = __reduce_max_sync(FULL, e_hi);
  e_lo = __reduce_min_sync(FULL, e_lo);
  const int log2_terms = K2 > 1 ? 32 - __clz(K2 - 1) : 0;
  if (e_hi - e_lo <= 29 - log2_terms) {  // every partial sum exact: a warp scan
    double part[COLS];
    double acc = 0.0;
#pragma unroll
    for (int q = 0; q < COLS; ++q) {
      acc += (double)(bc[q] / 2.0f);
      part[q] = acc;
    }
    double before = acc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(FULL, before, o);
      if (lane >= o) before += y;
    }
    before = __shfl_up_sync(FULL, before, 1);
    if (lane == 0) before = 0.0;
#pragma unroll
    for (int q = 0; q < COLS; ++q) cw[q] = (float)(before + part[q]);
  } else {  // lane 0 in column order
    if (lane == 0) {
      double acc = 0.0;
      s_cw[w][0] = 0.0f;
      for (int j = 1; j <= K2; ++j) {
        acc += (double)(s_b[w][j - 1] / 2.0f);
        s_cw[w][j] = (float)acc;
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < COLS; ++q) {
      const int j = COLS * lane + q;
      cw[q] = j <= K2 ? s_cw[w][j] : 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < COLS; ++q)
    if (COLS * lane + q > K2) cw[q] = 0.0f;

  // 3. the rows
  float row[COLS];
#pragma unroll
  for (int q = 0; q < COLS; ++q) row[q] = cw[q];
  for (int i = 0; i < K1; ++i) {
    const float ai = s_a[w][i];
    const float half = ai / 2.0f;
    // row_{j-1} for this lane's first column: the previous lane's last
    const float left = __shfl_up_sync(FULL, row[COLS - 1], 1);
    float x[COLS];
#pragma unroll
    for (int q = 0; q < COLS; ++q) {
      const float prev = q == 0 ? left : row[q - 1];
      const float term2 = row[q] + half;
      const float term1 = prev + fabsf(ai - bc[q]);
      const float c = (q == 0 && lane == 0) ? term2 : min_nan(term1, term2);
      x[q] = c - cw[q];
    }
#pragma unroll
    for (int q = 1; q < COLS; ++q) x[q] = min_nan(x[q - 1], x[q]);
    // inclusive min over the lanes' last prefixes, then each lane's
    // exclusive part from the lane before
    float t = x[COLS - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t = min_nan(y, t);
    }
    const float before = __shfl_up_sync(FULL, t, 1);
#pragma unroll
    for (int q = 0; q < COLS; ++q) row[q] = cw[q] + (lane == 0 ? x[q] : min_nan(before, x[q]));
  }

  // 4. row_{K2}
#pragma unroll
  for (int q = 0; q < COLS; ++q)
    if (COLS * lane + q == K2) a.out[p] = row[q];
}

}  // namespace

// The launch plan's layout as this library builds it: threads a block, pairs
// a block, static shared bytes, registers and local (spill) bytes a thread,
// blocks an SM by the card's occupancy calculator.  Returns a cudaError_t.
extern "C" int wasserstein_h0_layout(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, wasserstein_h0_kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wasserstein_h0_kernel, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = THREADS;
  out[1] = WARPS;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = blocks;
  return 0;
}

// One call over n_pairs pairs: d (n_pairs rows of K float32, row stride s_d
// elements, unit column stride), m likewise (uint8 0 / 1), 1 <= K <= 128 a
// side; out (n_pairs,) float32.  One launch on `stream`; returns the
// cudaError_t of the launch.
extern "C" int wasserstein_h0_launch(const float* d1, const uint8_t* m1, long long s_d1,
                                     long long s_m1, int K1, const float* d2,
                                     const uint8_t* m2, long long s_d2, long long s_m2, int K2,
                                     int n_pairs, float* out, void* stream) {
  if (n_pairs < 1 || K1 < 1 || K2 < 1 || K1 > MAX_K || K2 > MAX_K)
    return (int)cudaErrorInvalidValue;
  const Args a{d1, d2, m1, m2, s_d1, s_m1, s_d2, s_m2, K1, K2, n_pairs, out};
  const int grid = (n_pairs + WARPS - 1) / WARPS;
  wasserstein_h0_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
