// Exact zero-phase Butterworth band bank (scipy.signal.sosfiltfilt on
// length-padded batches) for sm_90a: one block per (series, band) chain,
// the time axis cut into one chunk of C samples a thread.
//
// Replaces no Pallas kernel.  The JAX package computes the same function,
// `tda_eeg_audio_tpu/ops/signal.py::bandpass_bank_iir_scan` over
// `sosfiltfilt_scan_masked` and `_biquad_scan` (:401), as XLA associative
// scans over one 2x2 affine pair a sample, section after section: log-depth
// because a sequential recurrence is hostile to a TPU, at the price of a
// 2x2 matrix product a sample and level.  Here the same algebra is taken at
// the grain of a thread's chunk.  A biquad's state s = (z1, z2) moves as
// s' = A s + B u with A = [[-a1, 1], [-a2, 0]], so a chunk of `len`
// samples maps its start state s to A^len s + e, e its end state from zero.
//
// Per chain (block), with n = the series' valid length clamped to [0, T],
// edge = scipy's padlen (3 * ntaps), L = n + 2 * edge:
//   ext:      buf[j] = the odd extension of x, j < L (source index clipped
//             to [0, T - 1], as the JAX package does), float64, in dynamic
//             shared memory;
//   forward:  for each section s in turn, over buf[0 .. L):
//             (a) thread k runs the biquad over its chunk [k C, k C + C)
//                 from zero state (thread 0 from the true start
//                 zi[s] * ext[0], the CASCADE input's first sample, not the
//                 section's) and keeps its end state;
//             (b) the block carries the true states across the chunks: a
//                 Kogge-Stone scan in each warp with A^(C d) at distance d,
//                 then each warp's incoming state from the warps before it
//                 through A^(32 C), then A^(C (lane + 1)) times that state;
//             (c) thread k reruns its chunk from its true start, writes the
//                 section's output over its input and feeds each output to
//                 (a) of section s + 1 at once, so a sample is loaded and
//                 stored once a section;
//   backward: the same over buf read backwards from L - 1, for n + edge
//             samples, each section from zi[s] * y1[L - 1];
//   out:      out[t] = buf[edge + t] (float32) for t < n, 0 for t in [n, T),
//             in the layout (series, band, T) of `bandpass_bank`.
// The powers A^(C m), m = 1 ... 32, per band and section, come from the
// host (`ops/iir_cuda.chunk_operators`, extended precision rounded once).
// Each section is scipy's direct form II transposed, with z1's sum taken
// as (b1 u + z2) - a1 y, the order of the plain recurrence; all state is
// float64, so the carry's reassociated sums stay within ~1e-12 of the
// sequential recurrence.
//
// What bounds it.  The function needs 9 FP64 operations per section and
// sample; the zero-state run and the rerun issue 10 FP64 instructions, 5
// SM cycles a warp-sample at the H100's 64 FP64 lanes an SM, and the
// in-place rerun one 8-byte shared-memory load and store, 4 cycles of the
// SM's 128 B a cycle: this design's floor is the FP64 rate at twice the
// function's work, plus the carry (a warp scan, one barrier and ~40 FP64
// instructions a chunk and section).  The earlier design (d702a88) ran
// one thread per chain over the whole time axis, a loop-carried chain of
// two dependent FP64 FMAs a sample, so a batch took about one chain's
// latency, with a float64 scratch of (T + 2 edge) x chains in device
// memory.  Here a chain has a block, 4 blocks of 46,832 B share an SM at
// T_pad 5800, and the extension never leaves shared memory: x is read once
// and the bands written once.  A chain too long for a block's shared memory
// (T + 2 edge > 28,928 samples) keeps its buffer in device memory
// (STAGED), the same kernel otherwise.  C is odd, so a warp's 8-byte
// accesses at stride C hit distinct bank pairs.  Lost when measured
// (PERF.md): the chunk in registers across sections (fewer blocks an SM,
// spills), two interleaved chunks a thread (stride 2 C: bank conflicts),
// 128 or 512 threads.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAX_WARPS = 32;       // 1024 threads a block at most
constexpr int POW_M = 32;           // A^(C m), m = 1 ... POW_M, a section
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clip(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// v += M p for a row-major 2x2 M
__device__ __forceinline__ void add_mv(const double* __restrict__ M, double p1, double p2,
                                       double& v1, double& v2) {
  v1 += __ldg(M + 0) * p1 + __ldg(M + 1) * p2;
  v2 += __ldg(M + 2) * p1 + __ldg(M + 3) * p2;
}

// One section of the biquad on sample u, state (z1, z2): its output.
__device__ __forceinline__ double biquad(const double* c, double u, double& z1, double& z2) {
  const double y = c[0] * u + z1;
  z1 = (c[1] * u + z2) - c[3] * y;
  z2 = c[2] * u - c[4] * y;
  return y;
}

__device__ __forceinline__ void load_section(const double* __restrict__ sos, int s, double* c) {
  c[0] = __ldg(sos + s * 6 + 0);
  c[1] = __ldg(sos + s * 6 + 1);
  c[2] = __ldg(sos + s * 6 + 2);
  c[3] = __ldg(sos + s * 6 + 4);
  c[4] = __ldg(sos + s * 6 + 5);
}

// (b) for one section: the chunks' end states (z1, z2), from zero state
// but thread 0's from the true start (s1, s2), become each chunk's true
// start state.
__device__ __forceinline__ void carry(const double* __restrict__ P, double s1, double s2,
                                      double& z1, double& z2, double (*t)[2]) {
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  // inclusive scan of the chunks' end states in the warp ...
  double v1 = z1, v2 = z2;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double q1 = __shfl_up_sync(FULL, v1, d);
    const double q2 = __shfl_up_sync(FULL, v2, d);
    if (lane >= d) add_mv(P + 4 * (d - 1), q1, q2, v1, v2);
  }
  if (lane == 31) {
    t[warp][0] = v1;
    t[warp][1] = v2;
  }
  __syncthreads();
  // ... the state entering this warp, from the warps before it ...
  double in1 = 0.0, in2 = 0.0;
  for (int w = 0; w < warp; ++w) {
    double n1 = t[w][0], n2 = t[w][1];
    add_mv(P + 4 * (POW_M - 1), in1, in2, n1, n2);
    in1 = n1;
    in2 = n2;
  }
  // ... and each chunk's true end state, then its true start
  add_mv(P + 4 * lane, in1, in2, v1, v2);
  const double e1 = __shfl_up_sync(FULL, v1, 1);
  const double e2 = __shfl_up_sync(FULL, v2, 1);
  z1 = k == 0 ? s1 : (lane == 0 ? in1 : e1);
  z2 = k == 0 ? s2 : (lane == 0 ? in2 : e2);
}

// One pass of the cascade over `len_pass` samples of buf, sample j at
// buf[first + DIR * j]; every section starts from zi[s] * u0.  Section s's
// rerun (c) feeds section s + 1's zero-state run (a) sample by sample, so a
// sample is loaded and stored once a section.
template <int S, int DIR>
__device__ __forceinline__ void cascade_pass(double* buf, int first, int len_pass, double u0,
                                             const double* __restrict__ sos,
                                             const double* __restrict__ zi,
                                             const double* __restrict__ pw, int C,
                                             double (*tot)[MAX_WARPS][2]) {
  const int k = threadIdx.x;
  const int lo = k * C;
  const int len = max(0, min(lo + C, len_pass) - lo);
  double* p = buf + first + DIR * lo;
  double c[5], cn[5];
  load_section(sos, 0, c);
  // (a) of section 0 (thread 0 from the true start)
  double s1 = k == 0 ? __ldg(zi + 0) * u0 : 0.0;
  double s2 = k == 0 ? __ldg(zi + 1) * u0 : 0.0;
  double z1 = s1, z2 = s2;
#pragma unroll 4
  for (int j = 0; j < len; ++j) biquad(c, p[DIR * j], z1, z2);
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    // (b) section s's true start
    carry(pw + (size_t)s * POW_M * 4, s1, s2, z1, z2, tot[s & 1]);
    if (s + 1 < S) {
      // (c) of section s, its outputs over its inputs, into (a) of s + 1
      load_section(sos, s + 1, cn);
      s1 = k == 0 ? __ldg(zi + (s + 1) * 2 + 0) * u0 : 0.0;
      s2 = k == 0 ? __ldg(zi + (s + 1) * 2 + 1) * u0 : 0.0;
      double n1 = s1, n2 = s2;
#pragma unroll 4
      for (int j = 0; j < len; ++j) {
        const double y = biquad(c, p[DIR * j], z1, z2);
        p[DIR * j] = y;
        biquad(cn, y, n1, n2);
      }
      z1 = n1;
      z2 = n2;
#pragma unroll
      for (int i = 0; i < 5; ++i) c[i] = cn[i];
    } else {
#pragma unroll 4
      for (int j = 0; j < len; ++j) p[DIR * j] = biquad(c, p[DIR * j], z1, z2);
    }
  }
}

template <int S, bool STAGED>
__global__ void __launch_bounds__(1024)
sosfiltfilt_kernel(const float* __restrict__ x, const int* __restrict__ nlen,
                   const double* __restrict__ sos, const double* __restrict__ zi,
                   const double* __restrict__ pw, double* __restrict__ scratch,
                   float* __restrict__ out, int n_bands, int T, int edge, int C) {
  extern __shared__ double smem[];
  __shared__ double tot[2][MAX_WARPS][2];
  const int chain = blockIdx.x;
  const int series = chain / n_bands;
  const int band = chain - series * n_bands;
  const float* xs = x + (size_t)series * T;
  float* o = out + (size_t)chain * T;
  const int n = clip(nlen[series], T);
  if (n == 0) {
    for (int t = threadIdx.x; t < T; t += blockDim.x) o[t] = 0.0f;
    return;
  }
  const int L = n + 2 * edge;
  double* buf = STAGED ? scratch + (size_t)chain * (size_t)(T + 2 * edge) : smem;
  sos += (size_t)band * S * 6;
  zi += (size_t)band * S * 2;
  pw += (size_t)band * S * POW_M * 4;

  // the odd extension, float64
  const double xf = xs[0];
  const double xl = xs[n - 1];
  for (int j = threadIdx.x; j < edge; j += blockDim.x) {
    buf[j] = 2.0 * xf - (double)xs[clip(edge - j, T - 1)];
    buf[edge + n + j] = 2.0 * xl - (double)xs[clip(n - 2 - j, T - 1)];
  }
#pragma unroll 4
  for (int t = threadIdx.x; t < n; t += blockDim.x) buf[edge + t] = (double)xs[t];
  __syncthreads();
  const double u0 = buf[0];
  cascade_pass<S, 1>(buf, 0, L, u0, sos, zi, pw, C, tot);
  __syncthreads();
  const double r0 = buf[L - 1];
  __syncthreads();
  cascade_pass<S, -1>(buf, L - 1, n + edge, r0, sos, zi, pw, C, tot);
  __syncthreads();
  // y2[n + edge - 1 - t] sits at buf[edge + t]
#pragma unroll 4
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    o[t] = t < n ? (float)buf[edge + t] : 0.0f;
}

template <int S, bool STAGED>
cudaError_t launch(const float* x, const int* nlen, const double* sos, const double* zi,
                   const double* pw, double* scratch, float* out, int chains, int n_bands,
                   int T, int edge, int C, int threads, int shared, cudaStream_t stream) {
  auto* fn = sosfiltfilt_kernel<S, STAGED>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         shared);
  if (err != cudaSuccess) return err;
  fn<<<chains, threads, shared, stream>>>(x, nlen, sos, zi, pw, scratch, out, n_bands, T,
                                          edge, C);
  return cudaGetLastError();
}

template <int S>
cudaError_t layout(int threads, int shared, int staged, int* rep) {
  auto* fn = staged ? sosfiltfilt_kernel<S, true> : sosfiltfilt_kernel<S, false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         shared);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, shared);
  if (err != cudaSuccess) return err;
  rep[0] = blocks;
  rep[1] = a.numRegs;
  rep[2] = (int)a.localSizeBytes;
  rep[3] = (int)a.sharedSizeBytes;
  rep[4] = a.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace

// One launch: one block of `threads` threads per (series, band) chain,
// chunks of C samples, `shared` bytes of dynamic shared memory for the
// chain's buffer (0 when staged: the buffer is the chain's row of scratch,
// (T + 2 edge) doubles a chain).  pw: (n_bands, n_sections, 32, 2, 2),
// A^(C m) per band and section.
extern "C" int sosfiltfilt_launch(const float* x, const int* nlen, const double* sos,
                                  const double* zi, const double* pw, double* scratch,
                                  float* out, int n_series, int n_bands, int n_sections,
                                  int T, int edge, int chunk, int threads, int shared,
                                  int staged, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chains = n_series * n_bands;
  if (threads < 32 || threads > 32 * MAX_WARPS || threads % 32 != 0 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  switch (n_sections) {
#define CASE(S_)                                                                          \
  case S_:                                                                                \
    return (int)(staged ? launch<S_, true>(x, nlen, sos, zi, pw, scratch, out, chains,    \
                                           n_bands, T, edge, chunk, threads, 0, st)      \
                        : launch<S_, false>(x, nlen, sos, zi, pw, scratch, out, chains,   \
                                            n_bands, T, edge, chunk, threads, shared, st));
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// What the library makes of a plan: rep[0] blocks an SM (the occupancy
// calculator), rep[1] registers a thread, rep[2] local (spill) bytes a
// thread, rep[3] static shared bytes, rep[4] the kernel's thread limit.
extern "C" int sosfiltfilt_layout(int n_sections, int threads, int shared, int staged,
                                  int* rep) {
  switch (n_sections) {
#define LAYOUT(S_) \
  case S_:         \
    return (int)layout<S_>(threads, staged ? 0 : shared, staged, rep);
    LAYOUT(1) LAYOUT(2) LAYOUT(3) LAYOUT(4) LAYOUT(5) LAYOUT(6) LAYOUT(7) LAYOUT(8)
#undef LAYOUT
    default:
      return (int)cudaErrorInvalidValue;
  }
}
