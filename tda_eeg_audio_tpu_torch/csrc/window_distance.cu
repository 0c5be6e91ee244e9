// The EEG window -> correlation-distance step for sm_90a: for each selected
// window of a (recording, band), the Pearson correlation of its C channels
// and the configuration's distance, read in place from the banded signal.
//
// Replaces no Pallas kernel.  The JAX package and the port's CPU path run the
// step as a chain of generic operations (`ops/signal.sliding_windows`, a
// gather of the selected windows, `ops/geometry.correlation_matrix`,
// `correlation_to_distance`): every window of every band written out, the
// used ones gathered into a second tensor, about ten passes over it to
// centre, normalise and test for zero variance, a batched GEMM, the
// distance's clamps -- ~11-12 GB of device memory a features batch of 64
// recordings.  Here a block takes one window:
//   1. stage: each warp a group of 4 channels; lane l reads samples
//      t = l + 32 m of them (all 8 m of a 250-sample window issued before
//      the first is used) straight from the banded signal through its
//      strides (NaN at or past T, as `sliding_windows` fills) and keeps each
//      channel's sum (float64), max, min and NaN flag; warp reductions give
//      the mean, and the lane stores its centred samples (x = v - mean,
//      float32, as the plain version does) as one float4 a t at
//      zs[t][4g .. 4g + 3]: a t-major row of CP = 52 floats (13 float4s,
//      13 odd), so 8 consecutive t's of a warp's store hit 8 distinct bank
//      groups.  A window of more than 8 x 32 samples is stored first and
//      centred in place;
//   2. Gram: a thread a 4 x 4 tile of the upper triangle of channel pairs
//      (78 tiles at C = 47) over a slice of t (3 slices at C = 47), float32
//      FMAs in t order, each CHUNK of steps then added into float64; each
//      step reads one float4 of row t for each side, a row every lane of a
//      warp shares, so the loads are broadcasts;
//   3. the slices' float64 partials meet (element-major in the staging
//      buffer, conflict-free stores); the diagonal gives each channel's
//      sum of squares, a zero sum or max == min (no NaN) marks the channel
//      flat, as `correlation_matrix`'s zero_var does;
//   4. r = G_ij / (|x_i| |x_j|) in float64, rounded once to float32, 0 where
//      a channel is flat; clamp(r, -1, 1) with NaN kept; the method's
//      distance in float32 as `correlation_to_distance` computes it (no
//      contraction into FMAs), clamp(d, min=0): each entry of the upper
//      triangle once, into both halves of a C x C matrix in shared memory
//      with a zero diagonal, then written out once, coalesced.
// The plain version divides each centred channel by its norm before the
// GEMM and sums 250 products in float32; here the norms divide float64 sums
// of float32 sums of <= CHUNK products.  On the card the plain chain's
// correlations lie up to ~1.1e-6 from float64's at the study's shapes, this
// kernel's ~3e-7 (tools/window_distance_ab.py).
//
// What bounds it: FP32 FMAs and shared-memory bandwidth in the Gram, and the
// latency of the staging loads.  A window at C = 47, win = 250 is 1,128
// pairs x 250 FMAs; the 78 tiles x 16 pairs do 1,248 x 250 (pad channel and
// mirrored diagonal-tile pairs).  Each step of a warp is 16 FMAs a lane
// against two 16-byte broadcast loads of <= 2 wavefronts each, so the FMA
// pipe and the shared-memory pipe are about level.  Bytes: the banded signal
// once from device memory (overlapping windows of a (recording, band) are
// neighbours in the grid and meet in L2) and the distances written once.
// On an H100 a features batch (17,280 windows) takes ~0.9 ms against a bound
// of 0.15 ms; the staging, the Gram and the output cost about a third each
// (a phase run twice, tools/window_distance_ab.py), so the next step is to
// overlap one window's staging with another's Gram in a persistent block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwindow_distance.so window_distance.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_C = 48;             // channels a window holds
constexpr int MAX_TILES = MAX_C / 4 * (MAX_C / 4 + 1) / 2;
constexpr int CP = 52;                // floats a staged row t: MAX_C + 4
constexpr int MIN_BLOCKS = 3;         // blocks an SM the build is held to
constexpr int LOADS = 8;              // samples a lane loads at once: 8 x 32 >= 250
constexpr int CHUNK = 32;             // t steps a float32 sum runs before it joins float64

struct Args {
  const float* x;                     // banded (B, C, NB, T), strides in elements
  long long sb, sc, sn, st;
  const long long* idx;               // window indices (B, NB, K), strides in elements
  long long ib, in, ik;
  int C, NB, T, K, win, step, method;
  int nt, tiles, slices;              // ceil(C / 4), nt (nt + 1) / 2, threads' t slices
  float* out;                         // (B, NB, K, C, C), contiguous
};

// tile -> (ti, tj), ti <= tj, row-major over the upper triangle of nt x nt
__device__ __forceinline__ void tile_of(int tile, int nt, int& ti, int& tj) {
  ti = 0;
  for (int row = nt; tile >= row; --row) {
    tile -= row;
    ++ti;
  }
  tj = ti + tile;
}

__device__ __forceinline__ int tile_index(int ti, int tj, int nt) {
  return ti * nt - ti * (ti - 1) / 2 + (tj - ti);
}

// correlation_to_distance of one off-diagonal entry, float32 as torch
// computes it: clamp(r, -1, 1) keeping NaN, the method, clamp(d, min=0)
__device__ __forceinline__ float distance(float r, int method) {
  if (r > 1.f) r = 1.f;
  if (r < -1.f) r = -1.f;
  float d;
  if (method == 0) {                  // euclidean: sqrt(clamp(2 (1 - r), min=0))
    float u = 2.f * (1.f - r);
    d = sqrtf(u < 0.f ? 0.f : u);
  } else if (method == 1) {           // abs
    d = 1.f - fabsf(r);
  } else if (method == 2) {           // standard
    d = 1.f - r;
  } else {                            // sqrt: sqrt(clamp(1 - r r, min=0))
    float u = 1.f - __fmul_rn(r, r);
    d = sqrtf(u < 0.f ? 0.f : u);
  }
  return d < 0.f ? 0.f : d;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) window_distance_kernel(const Args a) {
  extern __shared__ __align__(16) float zs[];  // win x CP samples, then the Gram partials
                                               // and the C x C distances
  __shared__ double inv_norm[MAX_C];
  __shared__ int flat[MAX_C];
  __shared__ uint8_t tile_i[MAX_TILES], tile_j[MAX_TILES];

  const int w = blockIdx.x;
  const int k = w % a.K;
  const int band = (w / a.K) % a.NB;
  const int b = w / a.K / a.NB;
  const long long start = a.idx[b * a.ib + band * a.in + k * a.ik] * (long long)a.step;
  const float* src = a.x + b * a.sb + band * a.sn;
  const int lane = threadIdx.x & 31;
  const float qnan = __int_as_float(0x7fc00000);
  if (threadIdx.x < a.tiles) {
    int ti, tj;
    tile_of(threadIdx.x, a.nt, ti, tj);
    tile_i[threadIdx.x] = (uint8_t)ti;
    tile_j[threadIdx.x] = (uint8_t)tj;
  }

  // 1. stage each group of 4 channels, its moments, centre it
  const bool one_pass = a.win <= 32 * LOADS;   // a lane's samples stay in registers
  for (int g = threadIdx.x >> 5; g < a.nt; g += WARPS) {
    double sum[4] = {0.0, 0.0, 0.0, 0.0};
    float hi[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    float lo[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
    bool nan[4] = {false, false, false, false};
    float v[LOADS][4];                // a pass's loads, all in flight at once
    for (int t0 = lane; t0 < a.win; t0 += 32 * LOADS) {
#pragma unroll
      for (int m = 0; m < LOADS; ++m) {
        const int t = t0 + 32 * m;
        const long long s = start + t;
        const bool inside = s >= 0 && s < a.T;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 4 * g + q;
          v[m][q] = t >= a.win || c >= a.C ? 0.f : inside ? src[c * a.sc + s * a.st] : qnan;
        }
      }
#pragma unroll
      for (int m = 0; m < LOADS; ++m) {
        const int t = t0 + 32 * m;
        if (t >= a.win) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sum[q] += (double)v[m][q];
          hi[q] = fmaxf(hi[q], v[m][q]);
          lo[q] = fminf(lo[q], v[m][q]);
          nan[q] |= isnan(v[m][q]);
        }
        if (!one_pass)
          *reinterpret_cast<float4*>(&zs[t * CP + 4 * g]) =
              make_float4(v[m][0], v[m][1], v[m][2], v[m][3]);
      }
    }
    float mean[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      for (int o = 16; o > 0; o >>= 1) {
        sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], o);
        hi[q] = fmaxf(hi[q], __shfl_xor_sync(0xffffffffu, hi[q], o));
        lo[q] = fminf(lo[q], __shfl_xor_sync(0xffffffffu, lo[q], o));
      }
      nan[q] = __any_sync(0xffffffffu, nan[q]);
      mean[q] = (float)(sum[q] / (double)a.win);
      if (lane == q && 4 * g + q < a.C) flat[4 * g + q] = !nan[q] && hi[q] == lo[q];
    }
    if (one_pass) {
#pragma unroll
      for (int m = 0; m < LOADS; ++m) {
        const int t = lane + 32 * m;
        if (t >= a.win) break;
        *reinterpret_cast<float4*>(&zs[t * CP + 4 * g]) =
            make_float4(v[m][0] - mean[0], v[m][1] - mean[1], v[m][2] - mean[2],
                        v[m][3] - mean[3]);
      }
    } else {
      for (int t = lane; t < a.win; t += 32) {
        float4* p = reinterpret_cast<float4*>(&zs[t * CP + 4 * g]);
        float4 x = *p;
        *p = make_float4(x.x - mean[0], x.y - mean[1], x.z - mean[2], x.w - mean[3]);
      }
    }
  }
  __syncthreads();

  // 2. the Gram matrix: a 4 x 4 tile over a slice of t a thread
  const int gt = a.tiles * a.slices;
  double dacc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) dacc[e] = 0.0;
  if (threadIdx.x < gt) {
    const int sl = threadIdx.x / a.tiles, tile = threadIdx.x - sl * a.tiles;
    const int t0 = sl * a.win / a.slices, t1 = (sl + 1) * a.win / a.slices;
    const float* pa = zs + 4 * tile_i[tile];
    const float* pb = zs + 4 * tile_j[tile];
    for (int c0 = t0; c0 < t1; c0 += CHUNK) {
      const int c1 = min(c0 + CHUNK, t1);
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll 2
      for (int t = c0; t < c1; ++t) {
        const float4 u = *reinterpret_cast<const float4*>(pa + t * CP);
        const float4 v = *reinterpret_cast<const float4*>(pb + t * CP);
        const float us[4] = {u.x, u.y, u.z, u.w};
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[4 * i + j] = fmaf(us[i], vs[j], acc[4 * i + j]);
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) dacc[e] += (double)acc[e];
    }
  }
  __syncthreads();
  // 3. the partials, element-major: zd[e * gt + slice * tiles + tile]
  double* zd = reinterpret_cast<double*>(zs);
  if (threadIdx.x < gt) {
#pragma unroll
    for (int e = 0; e < 16; ++e) zd[e * gt + threadIdx.x] = dacc[e];
  }
  __syncthreads();
  if (threadIdx.x < a.C) {
    const int c = threadIdx.x;
    const double* p = zd + (c & 3) * 5 * gt + tile_index(c >> 2, c >> 2, a.nt);
    double ss = 0.0;
    for (int sl = 0; sl < a.slices; ++sl) ss += p[sl * a.tiles];
    inv_norm[c] = 1.0 / sqrt(ss);
    if (ss == 0.0) flat[c] = 1;
  }
  __syncthreads();

  // 4. each upper-triangle entry once: r, its distance, both halves of a
  //    C x C matrix after the partials; then the matrix written out, coalesced
  float* dm = reinterpret_cast<float*>(zd + 16 * gt);
  for (int s = threadIdx.x; s < 16 * a.tiles; s += THREADS) {
    const int e = s / a.tiles, tile = s - e * a.tiles;
    const int i = 4 * tile_i[tile] + (e >> 2), j = 4 * tile_j[tile] + (e & 3);
    if (i >= j || j >= a.C) continue;          // a diagonal tile's lower half, pad channels
    float r = 0.f;
    if (!flat[i] && !flat[j]) {
      const double* p = zd + e * gt + tile;
      double g = 0.0;
      for (int sl = 0; sl < a.slices; ++sl) g += p[sl * a.tiles];
      r = (float)(g * inv_norm[i] * inv_norm[j]);
    }
    const float d = distance(r, a.method);
    dm[i * a.C + j] = d;
    dm[j * a.C + i] = d;
  }
  if (threadIdx.x < a.C) dm[threadIdx.x * (a.C + 1)] = 0.f;
  __syncthreads();
  float* o = a.out + (long long)w * a.C * a.C;
  for (int e = threadIdx.x; e < a.C * a.C; e += THREADS) o[e] = dm[e];
}

// dynamic shared bytes of a launch: the staged window, or the Gram partials
// and the distance matrix
int smem_bytes(int win, int tiles, int slices) {
  const int window = win * CP * (int)sizeof(float);
  const int partials = 16 * tiles * slices * (int)sizeof(double) +
                       MAX_C * MAX_C * (int)sizeof(float);
  return window > partials ? window : partials;
}

}  // namespace

// The kernel as this library builds it, at window length `win` and C = MAX_C:
// threads a block, MAX_C, CP, shared bytes a block (static + dynamic),
// registers and local (spill) bytes a thread, blocks an SM by the card's
// occupancy calculator at that shared size.  Returns a cudaError_t.
extern "C" int window_distance_layout(int win, int* out) {
  const int nt = MAX_C / 4, tiles = nt * (nt + 1) / 2, slices = THREADS / tiles;
  const int dyn = smem_bytes(win, tiles, slices);
  cudaError_t e = cudaFuncSetAttribute(window_distance_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, window_distance_kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, window_distance_kernel, THREADS, dyn);
  if (e != cudaSuccess) return (int)e;
  out[0] = THREADS;
  out[1] = MAX_C;
  out[2] = CP;
  out[3] = (int)attr.sharedSizeBytes + dyn;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = blocks;
  return 0;
}

// One call over n_windows = B * NB * K windows: banded float32 (B, C, NB, T)
// and int64 indices (B, NB, K), any strides; 1 <= C <= MAX_C; method 0..3
// (euclidean, abs, standard, sqrt); nt, tiles, slices as the launcher's plan;
// out (B, NB, K, C, C) float32 contiguous.  One launch on `stream`, a block a
// window; returns the cudaError_t of the launch.
extern "C" int window_distance_launch(const float* x, long long sb, long long sc, long long sn,
                                      long long st, const long long* idx, long long ib,
                                      long long in, long long ik, int n_windows, int C, int NB,
                                      int T, int K, int win, int step, int method, int nt,
                                      int tiles, int slices, float* out, void* stream) {
  if (n_windows < 1 || C < 1 || C > MAX_C || NB < 1 || K < 1 || win < 1 || step < 0 ||
      method < 0 || method > 3 || nt != (C + 3) / 4 || tiles != nt * (nt + 1) / 2 ||
      slices < 1 || slices > win || tiles * slices > THREADS || n_windows % (NB * K) != 0)
    return (int)cudaErrorInvalidValue;
  const int dyn = smem_bytes(win, tiles, slices);
  cudaError_t e = cudaFuncSetAttribute(window_distance_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) return (int)e;
  const Args a{x, sb, sc, sn, st, idx, ib, in, ik, C, NB, T, K, win, step, method,
               nt, tiles, slices, out};
  window_distance_kernel<<<n_windows, THREADS, dyn, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
