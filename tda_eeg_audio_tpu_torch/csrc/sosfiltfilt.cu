// Exact zero-phase Butterworth band bank (scipy.signal.sosfiltfilt on
// length-padded batches) for sm_90a: one thread per (series, band).
//
// Replaces no Pallas kernel.  The JAX package computes the same function,
// `tda_eeg_audio_tpu/ops/signal.py::bandpass_bank_iir_scan`, as XLA
// associative scans over 2x2 affine pairs (`_biquad_scan`, :401), a
// log-depth form chosen because a sequential recurrence is hostile to a TPU.
// On an H100 the natural form is the recurrence itself: one thread keeps a
// series' cascade state in registers, in float64 (closer to scipy's float64
// than the JAX package's float32 scan, see `ops/iir_cuda.py`).
//
// Per thread (series i / nb, band i % nb), with n = the series' valid length
// clamped to [0, T], edge = scipy's padlen (3 * ntaps) and L = n + 2 * edge:
//   forward:  ext[j], j < L, the odd extension built on the fly from x and n
//             (source index clipped to [0, T - 1], as the JAX package does),
//             through all S sections, each section's state starting at
//             zi[s] * ext[0]; outputs into scratch row j (column-major:
//             scratch[j * chains + i], so a warp's stores coalesce);
//   backward: scratch[L - 1 - j], j < n + edge, through the sections again,
//             state zi[s] * scratch[L - 1]; out[n + edge - 1 - j] for
//             j >= edge, float32, in the layout (series, band, T) of
//             `bandpass_bank`; out[t] = 0 for t in [n, T).
// Each section is scipy's direct form II transposed, with z1's sum taken
// as (b1 u + z2) - a1 y so that only one FMA follows y:
//   y = b0 u + z1;  z1 = (b1 u + z2) - a1 y;  z2 = b2 u - a2 y.
//
// What bounds it: the loop-carried chain y -> z1 -> y is two dependent FP64
// FMAs per sample and pass, so a thread takes about 2 (L + n + edge) FMA
// latencies whatever the card's rates; x read once and the bands written
// once (~105 MB for a 16-recording batch) and the FP64 operations are
// below that at the study's ~3,760 chains.  The design does no more than
// keep the chain in registers, unroll LOAD_AHEAD samples so the compiler
// can overlap one sample's later sections with the next sample's first,
// and load the next LOAD_AHEAD inputs while the current ones are filtered,
// so a cache miss is hidden behind a chunk's arithmetic.  Splitting the
// time axis (a chunked scan) is the redesign left for later.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int LOAD_AHEAD = 16;

template <int S>
struct Cascade {
  double b0[S], b1[S], b2[S], a1[S], a2[S], zi1[S], zi2[S], z1[S], z2[S];

  __device__ __forceinline__ void load(const double* sos, const double* zi) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      b0[s] = sos[s * 6 + 0];
      b1[s] = sos[s * 6 + 1];
      b2[s] = sos[s * 6 + 2];
      a1[s] = sos[s * 6 + 4];
      a2[s] = sos[s * 6 + 5];
      zi1[s] = zi[s * 2 + 0];
      zi2[s] = zi[s * 2 + 1];
    }
  }

  // every section starts from zi scaled by the cascade input's first sample
  __device__ __forceinline__ void start(double u0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      z1[s] = zi1[s] * u0;
      z2[s] = zi2[s] * u0;
    }
  }

  __device__ __forceinline__ double step(double u) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const double y = b0[s] * u + z1[s];
      z1[s] = (b1[s] * u + z2[s]) - a1[s] * y;
      z2[s] = b2[s] * u - a2[s] * y;
      u = y;
    }
    return u;
  }
};

__device__ __forceinline__ int clip(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

template <int S>
__global__ void sosfiltfilt_kernel(const float* __restrict__ x, const int* __restrict__ nlen,
                                   const double* __restrict__ sos,
                                   const double* __restrict__ zi,
                                   double* __restrict__ scratch, float* __restrict__ out,
                                   int n_series, int n_bands, int T, int edge) {
  const int chains = n_series * n_bands;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chains) return;
  const int series = i / n_bands;
  const int band = i - series * n_bands;
  const float* xs = x + (size_t)series * T;
  float* o = out + (size_t)i * T;
  double* sc = scratch + i;
  const size_t stride = (size_t)chains;
  const int n = clip(nlen[series], T);
  const int L = n + 2 * edge;

  Cascade<S> c;
  c.load(sos + (size_t)band * S * 6, zi + (size_t)band * S * 2);

  // ── forward pass over the odd extension ──
  const double xf = xs[0];
  const double xl = xs[n > 0 ? n - 1 : 0];
  // left part: ext[j] = 2 x[0] - x[clip(edge - j)], j < edge
  c.start(2.0 * xf - (double)xs[clip(edge, T - 1)]);
  for (int j = 0; j < edge; ++j) {
    const double u = 2.0 * xf - (double)xs[clip(edge - j, T - 1)];
    sc[(size_t)j * stride] = c.step(u);
  }
  // middle: ext[edge + t] = x[t], t < n, in chunks of LOAD_AHEAD samples,
  // the next chunk's loads in flight while this one is filtered
  const int n_full = n / LOAD_AHEAD * LOAD_AHEAD;
  float v[LOAD_AHEAD];
  if (n_full > 0) {
#pragma unroll
    for (int k = 0; k < LOAD_AHEAD; ++k) v[k] = xs[k];
  }
  for (int t = 0; t < n_full; t += LOAD_AHEAD) {
    float w[LOAD_AHEAD];
    if (t + LOAD_AHEAD < n_full) {
#pragma unroll
      for (int k = 0; k < LOAD_AHEAD; ++k) w[k] = xs[t + LOAD_AHEAD + k];
    }
#pragma unroll
    for (int k = 0; k < LOAD_AHEAD; ++k)
      sc[(size_t)(edge + t + k) * stride] = c.step((double)v[k]);
#pragma unroll
    for (int k = 0; k < LOAD_AHEAD; ++k) v[k] = w[k];
  }
  for (int t = n_full; t < n; ++t) sc[(size_t)(edge + t) * stride] = c.step((double)xs[t]);
  // right part: ext[edge + n + k] = 2 x[n-1] - x[clip(n - 2 - k)], k < edge
  for (int k = 0; k < edge; ++k) {
    const double u = 2.0 * xl - (double)xs[clip(n - 2 - k, T - 1)];
    sc[(size_t)(edge + n + k) * stride] = c.step(u);
  }

  // ── backward pass over the forward output, reversed ──
  const double* last = sc + (size_t)(L - 1) * stride;
  c.start(*last);
  for (int j = 0; j < edge; ++j) c.step(last[-(ptrdiff_t)((size_t)j * stride)]);
  // rev[edge + m] → out[n - 1 - m], m < n, chunked as the forward pass
  const double* rev = last - (size_t)edge * stride;       // rev[edge]
  double r[LOAD_AHEAD];
  if (n_full > 0) {
#pragma unroll
    for (int k = 0; k < LOAD_AHEAD; ++k) r[k] = rev[-(ptrdiff_t)((size_t)k * stride)];
  }
  for (int m = 0; m < n_full; m += LOAD_AHEAD) {
    double q[LOAD_AHEAD];
    if (m + LOAD_AHEAD < n_full) {
#pragma unroll
      for (int k = 0; k < LOAD_AHEAD; ++k)
        q[k] = rev[-(ptrdiff_t)((size_t)(m + LOAD_AHEAD + k) * stride)];
    }
#pragma unroll
    for (int k = 0; k < LOAD_AHEAD; ++k) o[n - 1 - m - k] = (float)c.step(r[k]);
#pragma unroll
    for (int k = 0; k < LOAD_AHEAD; ++k) r[k] = q[k];
  }
  for (int m = n_full; m < n; ++m)
    o[n - 1 - m] = (float)c.step(rev[-(ptrdiff_t)((size_t)m * stride)]);
  for (int k = n; k < T; ++k) o[k] = 0.0f;
}

template <int S>
cudaError_t launch(const float* x, const int* nlen, const double* sos, const double* zi,
                   double* scratch, float* out, int n_series, int n_bands, int T, int edge,
                   int threads, cudaStream_t stream) {
  const int chains = n_series * n_bands;
  const int grid = (chains + threads - 1) / threads;
  sosfiltfilt_kernel<S><<<grid, threads, 0, stream>>>(x, nlen, sos, zi, scratch, out,
                                                      n_series, n_bands, T, edge);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sosfiltfilt_launch(const float* x, const int* nlen, const double* sos,
                                  const double* zi, double* scratch, float* out,
                                  int n_series, int n_bands, int n_sections, int T,
                                  int edge, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_sections) {
#define CASE(S_) \
  case S_:       \
    return (int)launch<S_>(x, nlen, sos, zi, scratch, out, n_series, n_bands, T, edge, threads, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
