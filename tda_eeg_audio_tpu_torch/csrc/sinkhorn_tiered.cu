// Tiered H1 Sinkhorn of the comparison stage for sm_90a: the epsilon-annealed
// entropic OT cost <P, D> on persim's cost matrix, one block per diagram pair.
//
// Replaces no Pallas kernel.  The JAX package computes the same function as
// XLA programs: `tda_eeg_audio_tpu/models/programs.py::_wass_sinkhorn_tiered`
// (:358; compaction `_compact_rows` :312, the chunk tier ladder
// `_wass_chunk_tiered` :324) over `ops/wasserstein.py::build_cost_matrix`
// (:31) and `sinkhorn_cost_stab` (:134).  It sorts the pairs by bar count and
// runs 128-pair chunks at the narrowest tier width that holds the chunk,
// because XLA needs one static shape per chunk.  Here each pair takes its own
// tier: the pad rows and columns of the cost matrix are forced zero-cost
// pad<->pad matches, and a valid row's pad entries are 1e9, whose kernel
// entries underflow to exactly 0, so the result does not depend on the width
// beyond summation order.
//
// Per pair (block p), with n1, n2 = its valid bars and W = the class width:
//   1. count the valid bars (every warp, by ballots, so the class test needs
//      no barrier); a pair of another class returns at once;
//   2. warp 0 compacts the valid bars to the front in order into shared
//      memory; an empty side becomes the single [[0, 0]] bar (persim's
//      sentinel, reference scripts/utils.py:186-187);
//   3. blocker = the largest L-inf distance between valid bars, blocker2 =
//      max(blocker, side 1's largest (d - b) / 2), scale = the largest real
//      entry (< 1e8) clamped at 1e-9; Dm = D on real entries, 1e3 * scale
//      elsewhere.  D is never stored: the thread owning column c
//      recomputes its entries from the bars and the two blockers
//      (`Column`) wherever they are needed;
//   4. the epsilon ladder (eps_rel[s] * scale, s < steps), each rung in
//      blocks of `absorb` linear-domain iterations on the stabilised kernel
//      Kt = exp((f + g - Dm) / eps), built once per block:
//        u = 1 / max(Kt v, 1e-38);  v = 1 / max(Kt^T u, 1e-38)
//      then f += eps log u, g += eps log v;
//   5. out[p] = sum exp((f + g - Dm) / (eps_lo * scale)) * D over real entries.
// Thread t < S = 2W owns row t's dual f and column t's dual g.  Kt lives in
// shared memory with row stride LD = S + 4: the row matvec reads float4s
// (a quarter warp's eight rows fall on distinct 16-byte bank groups), the
// column matvec and the column-wise rebuild touch consecutive words.
//
// Arithmetic: Kt, u, v, the matvecs, the reciprocals and every exp are
// float32 (IEEE division, expf), as the plain version.  The duals f, g,
// the exponent (f + g - Dm) / eps and the final sum are float64.  A float32 dual's last
// bit, over eps_lo = 1e-4 * scale, moves <P, D> by up to ~3e-4 on study
// pairs: two float32 runs of the same ladder that round differently (this
// kernel's first build against the plain version; the plain version against
// itself with its pairs reordered, 1.9e-4) land that far apart.  With
// float64 duals the kernel stays within ~2e-7 of a float64 run of the
// ladder, so what separates it from the plain version is the plain
// version's own rounding.  No --use_fast_math and no -ftz=true
// (ops/cuda_build.NVCC_FLAGS has neither): the matvec floor 1e-38 is below
// FLT_MIN, a subnormal; flushed to zero it would become 0 and 1 / 0 = inf
// would poison the duals.
//
// What bounds it: per pair 240 iterations of two S x S matvecs (4 S^2 FP32
// operations) and 31 passes of S^2 expf; the bars in and 4 bytes out per
// pair are far below, so the floor is the FP32 and SFU rates.  This design
// keeps Kt in shared memory (one pass of expf per absorption, not per
// iteration) and reads all of it twice per iteration, 8 S^2 bytes at the
// SM's 128 bytes a clock, between two barriers: it is bound by shared-memory
// reads and their latency, not by the rates.  It splits each matvec over
// four accumulators and sizes blocks per width class (32 threads and 5 KB
// at S = 32, up to 192 threads and 152 KB at S = 192), so that narrow pairs
// keep many blocks on an SM.  One launch per class, each over all pairs, on
// the caller's stream: no host synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_STEPS = 16;
constexpr float BIG = 1e9f;          // build_cost_matrix's "inf"
constexpr float REAL_BELOW = 1e8f;   // real = D < 1e8
constexpr float TINY = 1e-38f;       // subnormal matvec floor
constexpr int N_CLASSES = 4;
__constant__ int kWidths[N_CLASSES] = {16, 40, 80, 96};

struct Ladder {
  float rel[MAX_STEPS];  // eps_hi * (eps_lo / eps_hi) ** (s / (steps - 1)), rounded to float32
  float lo;              // eps_lo
  int steps, iters, absorb;
};

template <int W>
struct Layout {
  static constexpr int S = 2 * W;
  static constexpr int LD = S + 4;
  static constexpr int THREADS = (S + 31) / 32 * 32;
  static constexpr int WARPS = THREADS / 32;
  // floats: Kt, f (S doubles), u, v, the four bar arrays, the reduction
  // slots (WARPS doubles)
  static constexpr int FLOATS = S * LD + 4 * S + 4 * W + 2 * WARPS;
  static constexpr int BYTES = FLOATS * 4;
};

struct Bars {
  const float *b1, *d1, *b2, *d2;
  int n1, n2;
  float blocker, blocker2;
};

// Column c of persim's cost matrix at side width W: rows [side-1 bars |
// side-2 diagonal helpers], columns [side-2 bars | side-1 diagonal slots].
// The thread owning column c keeps what depends on c; `at(i)` selects the
// entry of row i without branching on c, so a warp that straddles the two
// halves of the columns does not diverge (i is the same in every lane).
template <int W>
struct Column {
  bool point;  // c < W: side-2 bar k; else side-1 diagonal slot k
  bool valid;  // k is a real bar (or the sentinel) of its side
  int k;
  float b, d, diag;

  __device__ __forceinline__ Column(const Bars& B, int c) {
    point = c < W;
    k = point ? c : c - W;
    valid = k < (point ? B.n2 : B.n1);
    const int kk = valid ? k : 0;
    b = point ? B.b2[kk] : 0.0f;
    d = point ? B.d2[kk] : 0.0f;
    diag = valid ? 0.5f * (point ? B.d2[kk] - B.b2[kk] : B.d1[kk] - B.b1[kk]) : 0.0f;
  }

  __device__ __forceinline__ float at(const Bars& B, int i) const {
    if (i < W) {
      const bool both = i < B.n1 && valid;
      const float dul = fmaxf(fabsf(B.b1[i] - b), fabsf(B.d1[i] - d));
      const float slot = i == k ? diag : (both ? B.blocker : BIG);
      return point ? (both ? dul : BIG) : slot;
    }
    const int j = i - W;
    const bool both = j < B.n2 && valid;
    const float helper = j == k ? diag : (both ? B.blocker2 : BIG);
    return point ? helper : (both ? 0.0f : BIG);
  }
};

// every thread gets the block's max (or sum); `red` is free again on return
template <int WARPS, bool MAX, typename T>
__device__ __forceinline__ T block_reduce(T x, double* red) {
  T* slot = reinterpret_cast<T*>(red);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(FULL, x, o);
    x = MAX ? (x > y ? x : y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = x;
  __syncthreads();
  T r = slot[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = MAX ? (r > slot[w] ? r : slot[w]) : r + slot[w];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int count_bars(const uint8_t* m, int K, int lane) {
  int n = 0;
  for (int k0 = 0; k0 < K; k0 += 32) n += __popc(__ballot_sync(FULL, k0 + lane < K && m[k0 + lane]));
  return n;
}

// warp 0: the valid bars of one side to the front, in order; [[0, 0]] if none
__device__ __forceinline__ void compact(const float* b, const float* d, const uint8_t* m, int K,
                                        int lane, float* sb, float* sd) {
  int base = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const bool valid = k < K && m[k];
    const unsigned bal = __ballot_sync(FULL, valid);
    if (valid) {
      const int pos = base + __popc(bal & ((1u << lane) - 1u));
      sb[pos] = b[k];
      sd[pos] = d[k];
    }
    base += __popc(bal);
  }
  if (base == 0 && lane == 0) {
    sb[0] = 0.0f;
    sd[0] = 0.0f;
  }
}

template <int W>
__global__ void __launch_bounds__(Layout<W>::THREADS)
sinkhorn_tiered_kernel(const float* __restrict__ b1, const float* __restrict__ d1,
                       const uint8_t* __restrict__ m1, int K1, const float* __restrict__ b2,
                       const float* __restrict__ d2, const uint8_t* __restrict__ m2, int K2,
                       const Ladder lad, float* __restrict__ out) {
  using L = Layout<W>;
  constexpr int S = L::S, LD = L::LD;
  const int p = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31;
  const uint8_t* r1 = m1 + (size_t)p * K1;
  const uint8_t* r2 = m2 + (size_t)p * K2;

  // 1. the pair's class, the same in every warp
  const int c1 = count_bars(r1, K1, lane), c2 = count_bars(r2, K2, lane);
  const int c = c1 > c2 ? c1 : c2;
  int w = kWidths[N_CLASSES - 1];
#pragma unroll
  for (int i = N_CLASSES - 2; i >= 0; --i)
    if (c <= kWidths[i]) w = kWidths[i];
  if (w != W) return;

  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                                         // S x LD
  double* sf = reinterpret_cast<double*>(Kt + S * LD);      // S: f, for the column passes
  float* su = reinterpret_cast<float*>(sf + S);             // S
  float* sv = su + S;                                       // S
  float* sb1 = sv + S;                                      // W each
  float* sd1 = sb1 + W;
  float* sb2 = sd1 + W;
  float* sd2 = sb2 + W;
  double* red = reinterpret_cast<double*>(sd2 + W);         // WARPS

  // 2. compacted bars, sentinel for an empty side
  if (t < 32) {
    compact(b1 + (size_t)p * K1, d1 + (size_t)p * K1, r1, K1, lane, sb1, sd1);
    compact(b2 + (size_t)p * K2, d2 + (size_t)p * K2, r2, K2, lane, sb2, sd2);
  }
  __syncthreads();
  Bars B{sb1, sd1, sb2, sd2, c1 > 0 ? c1 : 1, c2 > 0 ? c2 : 1, 0.0f, 0.0f};

  // 3. blockers and scale
  float mx = 0.0f;
  for (int i = t; i < B.n1 * B.n2; i += L::THREADS) {
    const int r = i / B.n2, cc = i - r * B.n2;
    mx = fmaxf(mx, fmaxf(fabsf(sb1[r] - sb2[cc]), fabsf(sd1[r] - sd2[cc])));
  }
  B.blocker = block_reduce<L::WARPS, true, float>(mx, red);
  mx = B.blocker;
  for (int k = t; k < B.n1; k += L::THREADS) mx = fmaxf(mx, 0.5f * (sd1[k] - sb1[k]));
  B.blocker2 = block_reduce<L::WARPS, true, float>(mx, red);
  const Column<W> col(B, t < S ? t : 0);
  mx = 0.0f;
  if (t < S)
    for (int i = 0; i < S; ++i) {
      const float D = col.at(B, i);
      if (D < REAL_BELOW) mx = fmaxf(mx, D);
    }
  const float scale = fmaxf(block_reduce<L::WARPS, true, float>(mx, red), 1e-9f);
  const float off = 1e3f * scale;  // Dm off the real entries

  // 4. the epsilon ladder
  double f = 0.0, g = 0.0;
  float u = 1.0f, v = 1.0f;
  if (t < S) sf[t] = 0.0;
  for (int s = 0; s < lad.steps; ++s) {
    const float eps = lad.rel[s] * scale;
    const double inv_eps = 1.0 / (double)eps;
    for (int done = 0; done < lad.iters; done += lad.absorb) {
      const int blk = min(lad.absorb, lad.iters - done);
      __syncthreads();  // sf complete
      if (t < S) {
        // column t of Kt; consecutive threads store consecutive words
#pragma unroll 4
        for (int i = 0; i < S; ++i) {
          const float D = col.at(B, i);
          const float dm = D < REAL_BELOW ? D : off;
          Kt[i * LD + t] = expf((float)(((sf[i] + g) - (double)dm) * inv_eps));
        }
        sv[t] = 1.0f;
      }
      u = 1.0f;
      v = 1.0f;
      __syncthreads();
      for (int it = 0; it < blk; ++it) {
        if (t < S) {
          const float4* row = reinterpret_cast<const float4*>(Kt + t * LD);
          const float4* v4 = reinterpret_cast<const float4*>(sv);
          float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 8
          for (int j = 0; j < S / 4; ++j) {
            const float4 k = row[j], x = v4[j];
            a0 = fmaf(k.x, x.x, a0);
            a1 = fmaf(k.y, x.y, a1);
            a2 = fmaf(k.z, x.z, a2);
            a3 = fmaf(k.w, x.w, a3);
          }
          u = 1.0f / fmaxf((a0 + a1) + (a2 + a3), TINY);
          su[t] = u;
        }
        __syncthreads();
        if (t < S) {
          const float4* u4 = reinterpret_cast<const float4*>(su);
          float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 8
          for (int i = 0; i < S / 4; ++i) {
            const float4 x = u4[i];
            const float* col = Kt + 4 * i * LD + t;
            a0 = fmaf(col[0], x.x, a0);
            a1 = fmaf(col[LD], x.y, a1);
            a2 = fmaf(col[2 * LD], x.z, a2);
            a3 = fmaf(col[3 * LD], x.w, a3);
          }
          v = 1.0f / fmaxf((a0 + a1) + (a2 + a3), TINY);
          sv[t] = v;
        }
        __syncthreads();
      }
      if (t < S) {
        f += (double)eps * log((double)u);
        g += (double)eps * log((double)v);
        sf[t] = f;
      }
    }
  }
  __syncthreads();

  // 5. <P, D> over the real entries
  const double inv_lo = 1.0 / (double)(lad.lo * scale);
  double acc = 0.0;
  if (t < S)
    for (int i = 0; i < S; ++i) {
      const float D = col.at(B, i);
      const bool real = D < REAL_BELOW;
      const float P = expf((float)(((sf[i] + g) - (double)(real ? D : off)) * inv_lo));
      acc += (double)P * (real ? D : 0.0f);
    }
  const double total = block_reduce<L::WARPS, false, double>(acc, red);
  if (t == 0) out[p] = (float)total;
}

template <int W>
cudaError_t launch(const float* b1, const float* d1, const uint8_t* m1, int K1, const float* b2,
                   const float* d2, const uint8_t* m2, int K2, int n_pairs, const Ladder& lad,
                   float* out, cudaStream_t stream) {
  using L = Layout<W>;
  static_assert(L::BYTES <= 232448, "a block may opt into 227 KB of shared memory");
  cudaError_t e = cudaFuncSetAttribute(sinkhorn_tiered_kernel<W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return e;
  sinkhorn_tiered_kernel<W><<<n_pairs, L::THREADS, L::BYTES, stream>>>(b1, d1, m1, K1, b2, d2,
                                                                       m2, K2, lad, out);
  return cudaGetLastError();
}

}  // namespace

// One launch of width class `width` (16, 40, 80 or 96 bars a side) over all
// n_pairs pairs, sized by Layout<width>; blocks of other classes return at
// once.  eps_rel holds `steps` float32 rungs.  Returns the cudaError_t of the
// launch.
extern "C" int sinkhorn_tiered_launch(const float* b1, const float* d1, const uint8_t* m1, int K1,
                                      const float* b2, const float* d2, const uint8_t* m2, int K2,
                                      int n_pairs, const float* eps_rel, int steps, float eps_lo,
                                      int iters, int absorb, float* out, int width,
                                      void* stream) {
  if (steps < 1 || steps > MAX_STEPS || iters < 0 || absorb < 1 || n_pairs < 1 || K1 < 1 ||
      K2 < 1 || K1 > 96 || K2 > 96)
    return (int)cudaErrorInvalidValue;
  Ladder lad{};
  for (int s = 0; s < steps; ++s) lad.rel[s] = eps_rel[s];
  lad.lo = eps_lo;
  lad.steps = steps;
  lad.iters = iters;
  lad.absorb = absorb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
#define CASE(W_) \
  case W_:       \
    return (int)launch<W_>(b1, d1, m1, K1, b2, d2, m2, K2, n_pairs, lad, out, st);
    CASE(16) CASE(40) CASE(80) CASE(96)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
