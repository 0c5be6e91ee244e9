// Exact H0 Wasserstein of the comparison stage for sm_90a: persim's distance
// between two H0 diagrams (every birth 0), one warp per pair, the sort and the
// alignment DP in one launch.
//
// Replaces no Pallas kernel.  The JAX package computes the same function as
// XLA code: `tda_eeg_audio_tpu/ops/wasserstein.py::wasserstein_h0_exact`
// (:190), two sorts and one `lax.scan` over the rows (:234) whose step is an
// `associative_scan` min (:231).  The port's plain version
// (`ops/wasserstein.py::wasserstein_h0_exact_plain`) runs it as a Python loop
// over the K1 rows, ten small ops a row: ~460 launches a comparison batch.
//
// Per pair (one warp):
//   1. a = sort(where(m1, d1, 0)), b = sort(where(m2, d2, 0)), ascending, by
//      rank: every lane ranks its slots against all slots of the side (the
//      number of smaller keys, plus the equal keys at lower slots) and writes
//      each value at its rank in shared memory.  The key is the value's
//      bits made monotone, -0.0 taken as +0.0 and every NaN as the one +NaN,
//      last (torch's and JAX's order of values; a sort of values alone, so
//      the order of equal keys cannot change the result);
//   2. bcol = [0, b], cumw = cumsum(bcol / 2): lane 0 sums in column order
//      in float64 and rounds each prefix to float32, as torch's CPU cumsum
//      does, so the kernel equals the plain version on the CPU bit for bit;
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
// recordings (4,800 pairs of 46 and 123 slots).  The work is ~K1 (K1 + K2)
// + K2^2 compares for the sorts and K1 (K2 + 1) cells of ~8 operations; at
// one warp a pair, 4,800 pairs are ~25 us of issue on 132 SMs.  So a call is
// bound by its launch, and the design makes it one launch with nothing in
// front of it (no torch.sort, no cumsum, no copy: the kernel reads rows
// through their strides).
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
constexpr int COLS = 5;           // row columns a lane: 32 * 5 >= MAX_K + 1

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

// one side of a pair into `sorted` (K values, ascending): where(m, d, 0)
__device__ __forceinline__ void rank_sort(const float* d, const uint8_t* m, int K, int lane,
                                          uint32_t* keys, float* sorted) {
  constexpr int PER = MAX_K / 32;
  float v[PER];
  uint32_t k[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int s = lane + 32 * q;
    v[q] = s < K ? (m[s] ? d[s] : 0.0f) : 0.0f;
    k[q] = sort_key(v[q]);
    if (s < K) keys[s] = k[q];
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int s = lane + 32 * q;
    int rank = 0;
    for (int j = 0; j < K; ++j) {
      const uint32_t kj = keys[j];
      rank += (kj < k[q]) | ((kj == k[q]) & (j < s));
    }
    if (s < K) sorted[rank] = v[q];
  }
}

__global__ void __launch_bounds__(THREADS) wasserstein_h0_kernel(Args a) {
  __shared__ uint32_t s_keys[WARPS][MAX_K];
  __shared__ float s_a[WARPS][MAX_K];
  __shared__ float s_b[WARPS][MAX_K];
  __shared__ float s_cw[WARPS][MAX_K + 1];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p = blockIdx.x * WARPS + w;
  if (p >= a.n_pairs) return;  // a whole warp: no shuffle or barrier left behind
  const int K1 = a.K1, K2 = a.K2;

  // 1. both sides sorted into shared memory
  rank_sort(a.d1 + p * a.s_d1, a.m1 + p * a.s_m1, K1, lane, s_keys[w], s_a[w]);
  __syncwarp();
  rank_sort(a.d2 + p * a.s_d2, a.m2 + p * a.s_m2, K2, lane, s_keys[w], s_b[w]);
  __syncwarp();

  // 2. cumw in column order, float64 sums rounded once each (torch's CPU cumsum)
  if (lane == 0) {
    double acc = 0.0;
    s_cw[w][0] = 0.0f;
    for (int j = 1; j <= K2; ++j) {
      acc += (double)(s_b[w][j - 1] / 2.0f);
      s_cw[w][j] = (float)acc;
    }
  }
  __syncwarp();

  // 3. the rows; columns past K2 hold zeros and never reach column K2's prefix
  float row[COLS], cw[COLS], bc[COLS];
#pragma unroll
  for (int q = 0; q < COLS; ++q) {
    const int j = COLS * lane + q;
    const bool in = j <= K2;
    cw[q] = in ? s_cw[w][j] : 0.0f;
    bc[q] = in && j > 0 ? s_b[w][j - 1] : 0.0f;
    row[q] = cw[q];
  }
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
