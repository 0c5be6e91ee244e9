// Tiered H1 Sinkhorn of the comparison stage for sm_90a: the epsilon-annealed
// entropic OT cost <P, D> on persim's cost matrix, one pair at a time per
// group of warps, the stabilised kernel matrix Kt held in registers.
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
// One call: `bucket_kernel` counts each pair's valid bars and appends the pair
// to its width class's list (16 / 40 / 80 / 96 bars a side, S = 2W = 32 / 80
// / 160 / 192); then one launch per class, a persistent grid (its blocks an
// SM x the SMs) whose pair groups take pairs from the class's list through an
// atomic counter.  Per pair, with n1, n2 = its valid bars:
//   1. warp 0 compacts the valid bars to the front in order into shared
//      memory; an empty side becomes the single [[0, 0]] bar (persim's
//      sentinel, reference scripts/utils.py:186-187);
//   2. blocker = the largest L-inf distance between valid bars, blocker2 =
//      max(blocker, side 1's largest (d - b) / 2), scale = the largest real
//      entry (< 1e8) clamped at 1e-9; Dm = D on real entries, 1e3 * scale
//      elsewhere, built once into shared memory (element-major: entry e of
//      thread t's tile at e * threads + t, so every access is conflict-free;
//      float64 where it fits, so a rebuild converts one value an entry, not
//      two; float32 at S = 192);
//   3. the epsilon ladder (eps_rel[s] * scale, s < steps), each rung in
//      blocks of `absorb` linear-domain iterations on the stabilised kernel
//      Kt = exp((f + g - Dm) / eps), rebuilt into registers once per block:
//        u = 1 / max(Kt v, 1e-38);  v = 1 / max(Kt^T u, 1e-38)
//      then f += eps log u, g += eps log v (f, g float64 in shared memory);
//   4. out[p] = sum exp((f + g - Dm) / (eps_lo * scale)) * D over real entries.
//
// The tiles.  A pair's group is WP warps.  Lane l of warp w owns the R x C
// tile of Kt at rows (w * A + l / B) * R + [0, R) and columns (l % B) * C +
// [0, C), A = 32 / B tile rows a warp, so B * C = S and WP * A * R = S.  The
// row sums are each thread's partial sums over its C columns, reduced over
// the B lanes of a tile row by shuffles that halve the values each step (each
// lane ends with one row's sum and computes that row's u; shuffles hand the
// R u's back).  The column sums are each thread's partial sums over its R
// rows, reduced over the A tile rows of the warp by halving shuffles, then
// over the WP warps through a WP x S buffer of partial sums in shared memory:
// thread t < S sums column t's WP partials in warp order and writes v[t].  No
// Kt element is read from shared memory in the iteration loop.  At S = 32 a
// group is one warp (R 8, C 4, B 8): no block barrier, v stays in registers,
// several groups to a block.
//
// Arithmetic: Kt, u, v, the matvecs, the reciprocals and every exp are
// float32 (IEEE division, expf), as the plain version.  The duals f, g, the
// exponent (f + g - Dm) / eps and the final sum are float64.  A float32
// dual's last bit, over eps_lo = 1e-4 * scale, moves <P, D> by up to ~3e-4
// on study pairs; with float64 duals the kernel stays within ~1e-7 of a
// float64 run of the ladder, so what separates it from the plain version is
// the plain version's own rounding.  No --use_fast_math and no -ftz=true
// (ops/cuda_build.NVCC_FLAGS has neither): the matvec floor 1e-38 is below
// FLT_MIN, a subnormal; flushed to zero it would become 0 and 1 / 0 = inf
// would poison the duals.
//
// What bounds it: per pair 240 iterations of two S x S matvecs (4 S^2 FP32
// operations) and 31 passes of S^2 expf; the bars in and 4 bytes out per
// pair are far below, so the floor is the FP32 rate.  The matvecs read Kt
// from registers, so an iteration costs its multiply-adds, a few shuffles,
// two reciprocals a lane and two block barriers (none at S = 32); the
// rebuild passes cost a float64 -> float32 conversion, three float64
// operations and an expf per entry, and the conversion and expf share the
// SM's 16-a-clock unit.  Kt in registers sets the occupancy: one pair an SM
// at S = 160 and 192 (10 and 12 warps, the 168-register cap of 3 warps a
// quarter SM), four at S = 80, eight blocks of two at S = 32.  With one pair
// an SM the warps run each iteration in lockstep between the barriers, so
// the row sums' halving shuffles, the reciprocals and the column partials'
// pass through shared memory are latency no other pair hides.
//
// With -DSINKHORN_PROFILE (a build of its own, never loaded by the port's
// entry points) each part ends with a group barrier, thread 0 of each group
// sums clock64() ticks per part, and each pair records its start, end
// (globaltimer, ns) and SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsinkhorn_tiered.so sinkhorn_tiered.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_STEPS = 16;
constexpr int MAX_K = 96;            // the comparison's pad width
constexpr float BIG = 1e9f;          // build_cost_matrix's "inf"
constexpr float REAL_BELOW = 1e8f;   // real = D < 1e8
constexpr float TINY = 1e-38f;       // subnormal matvec floor
constexpr int N_CLASSES = 4;       // width classes 16, 40, 80, 96 bars a side

// profile slots (int64 per pair): ticks of thread 0 of the group per part,
// each part closed by a group barrier, then the total
enum { kProfSetup, kProfDm, kProfRebuild, kProfRow, kProfCol, kProfFinal, kProfTotal,
       kProfSlots };

struct Ladder {
  float rel[MAX_STEPS];  // eps_hi * (eps_lo / eps_hi) ** (s / (steps - 1)), rounded to float32
  float lo;              // eps_lo
  int steps, iters, absorb;
};

struct Args {
  const float *b1, *d1, *b2, *d2;
  const uint8_t *m1, *m2;
  int K1, K2, n_pairs;
  const int* counts;     // pairs per class
  int* work;             // per class: the next slot of its list to take
  const int* list;       // per class: n_pairs slots of pair indices
  float* out;
  long long *prof, *stamps;
};

// A width class: W bars a side, tiles of R x C, B lanes along a tile row,
// WP warps a pair, PAIRS pairs a block (WP == 1 only), BPS blocks an SM, Dm
// in shared memory as float64 (DMD) or float32.
template <int W_, int R_, int C_, int B_, int WP_, int PAIRS_, int BPS_, bool DMD_>
struct Shape {
  static constexpr int W = W_, S = 2 * W_, R = R_, C = C_, B = B_, A = 32 / B_, WP = WP_,
                       PAIRS = PAIRS_, BPS = BPS_;
  using Dm = std::conditional_t<DMD_, double, float>;
  static constexpr int NT = 32 * WP;            // threads of a pair's group
  static constexpr int THREADS = NT * PAIRS;
  // shared bytes of a group: f, g (S doubles each), Dm (S^2 entries), the
  // bars (4 W floats); with WP > 1 also v (S floats), the column partial
  // sums (WP x S floats), one 16-byte reduction slot a warp and the pair slot
  static constexpr int GROUP_BYTES = 16 * S + (int)sizeof(Dm) * S * S + 16 * W +
                                     (WP > 1 ? 4 * S + 4 * WP * S + 16 * WP + 16 : 0);
  static constexpr int BYTES = PAIRS * GROUP_BYTES;
  static_assert(B * C == S && WP * A * R == S, "the tiles cover S x S");
  static_assert((B & (B - 1)) == 0 && R <= B, "row sums over a power of two of lanes");
  static_assert(WP == 1 || PAIRS == 1, "several pairs a block only a warp each");
  static_assert(WP > 1 || (C == A && (C & (C - 1)) == 0), "one column a lane at WP == 1");
  static_assert(WP == 1 || NT >= S, "a thread per column sums the partials");
  static_assert(S % 16 == 0 && BYTES <= 232448, "16-byte parts within 227 KB");
};

using Class16 = Shape<16, 8, 4, 8, 1, 2, 8, true>;
using Class40 = Shape<40, 8, 5, 16, 5, 1, 4, true>;
using Class80 = Shape<80, 8, 10, 16, 10, 1, 1, true>;
using Class96 = Shape<96, 8, 12, 16, 12, 1, 1, false>;

#ifdef SINKHORN_PROFILE
__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#define PROF_DECL long long prof_[kProfSlots] = {0}; long long t_ = clock64(); \
  const long long t_begin_ = t_; const unsigned long long stamp0_ = globaltimer_ns();
#define PROF_TICK(slot) { group_sync<SH>(); const long long c_ = clock64(); \
  prof_[slot] += c_ - t_; t_ = c_; }
#define PROF_STORE(p) if (t == 0 && a.prof) { \
  prof_[kProfTotal] = clock64() - t_begin_; \
  for (int k = 0; k < kProfSlots; ++k) a.prof[(size_t)(p) * kProfSlots + k] = prof_[k]; \
  a.stamps[3 * (size_t)(p)] = (long long)stamp0_; \
  a.stamps[3 * (size_t)(p) + 1] = (long long)globaltimer_ns(); \
  a.stamps[3 * (size_t)(p) + 2] = (long long)smid(); }
#else
#define PROF_DECL
#define PROF_TICK(slot)
#define PROF_STORE(p)
#endif

template <class SH>
__device__ __forceinline__ void group_sync() {
  if constexpr (SH::WP == 1) __syncwarp(); else __syncthreads();
}

// every thread of the group gets the group's max (or sum); butterfly in the
// warp, then the warps' values in warp order
template <class SH, bool MAX, typename T>
__device__ __forceinline__ T group_reduce(T x, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(FULL, x, o);
    x = MAX ? (x > y ? x : y) : x + y;
  }
  if constexpr (SH::WP > 1) {
    T* slot = reinterpret_cast<T*>(red);
    if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = x;
    __syncthreads();
    T r = slot[0];
#pragma unroll
    for (int w = 1; w < SH::WP; ++w) r = MAX ? (r > slot[w] ? r : slot[w]) : r + slot[w];
    __syncthreads();
    return r;
  }
  return x;
}

// Sum N values v[0, N) over the lanes that differ in the lane bits OFF, OFF / 2,
// ..., LO.  While N is even each step halves them: the lane with the bit set
// keeps the upper half and adds its partner's, `base` counts the offset of
// what it keeps; once N is odd the steps are a butterfly.  On return v[0, N')
// holds the sums of values base + [0, N').
template <int N, int OFF, int LO>
__device__ __forceinline__ void halving_sum(float* v, int lane, int& base) {
  if constexpr (N % 2 == 0) {
    const bool up = lane & OFF;
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float keep = up ? v[q + N / 2] : v[q];
      const float send = up ? v[q] : v[q + N / 2];
      v[q] = keep + __shfl_xor_sync(FULL, send, OFF);
    }
    if (up) base += N / 2;
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] += __shfl_xor_sync(FULL, v[q], OFF);
  }
  if constexpr (OFF > LO) halving_sum<(N % 2 == 0 ? N / 2 : N), OFF / 2, LO>(v, lane, base);
}

// values left per lane after halving_sum<N, OFF, LO>, and the lane bits of its
// butterfly steps (lanes that differ only there hold the same sums)
__host__ __device__ constexpr int halving_keep(int n, int off, int lo) {
  return off < lo ? n : halving_keep(n % 2 == 0 ? n / 2 : n, off / 2, lo);
}
__host__ __device__ constexpr int butterfly_bits(int n, int off, int lo) {
  return off < lo ? 0 : (n % 2 == 0 ? 0 : off) | butterfly_bits(n % 2 == 0 ? n / 2 : n, off / 2, lo);
}

__device__ __forceinline__ int count_bars(const uint8_t* m, int K, int lane) {
  int n = 0;
  for (int k0 = 0; k0 < K; k0 += 32) n += __popc(__ballot_sync(FULL, k0 + lane < K && m[k0 + lane]));
  return n;
}

// one warp: the valid bars of one side to the front, in order; [[0, 0]] if none
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

struct Bars {
  const float *b1, *d1, *b2, *d2;
  int n1, n2;
  float blocker, blocker2;
};

// Entry (i, c) of persim's cost matrix at side width W: rows [side-1 bars |
// side-2 diagonal helpers], columns [side-2 bars | side-1 diagonal slots].
template <int W>
__device__ __forceinline__ float cost(const Bars& B, int i, int c) {
  const bool point = c < W;  // c < W: side-2 bar k; else side-1 diagonal slot k
  const int k = point ? c : c - W;
  const bool valid = k < (point ? B.n2 : B.n1);
  const int kk = valid ? k : 0;
  if (i < W) {
    const bool both = i < B.n1 && valid;
    if (point) return both ? fmaxf(fabsf(B.b1[i] - B.b2[kk]), fabsf(B.d1[i] - B.d2[kk])) : BIG;
    if (i == k) return valid ? 0.5f * (B.d1[kk] - B.b1[kk]) : 0.0f;
    return both ? B.blocker : BIG;
  }
  const int j = i - W;
  const bool both = j < B.n2 && valid;
  if (!point) return both ? 0.0f : BIG;
  if (j == k) return valid ? 0.5f * (B.d2[kk] - B.b2[kk]) : 0.0f;
  return both ? B.blocker2 : BIG;
}

// shared memory of one pair group
template <class SH>
struct Smem {
  double *f, *g, *red;
  typename SH::Dm* dm;
  float *v, *part, *b1, *d1, *b2, *d2;
  int* slot;
  __device__ __forceinline__ explicit Smem(unsigned char* p) {
    constexpr int S = SH::S, W = SH::W;
    f = reinterpret_cast<double*>(p);
    g = f + S;
    dm = reinterpret_cast<typename SH::Dm*>(g + S);
    b1 = reinterpret_cast<float*>(dm + S * S);
    d1 = b1 + W;
    b2 = d1 + W;
    d2 = b2 + W;
    v = d2 + W;                 // WP > 1 from here
    part = v + S;
    red = reinterpret_cast<double*>(part + SH::WP * S);
    slot = reinterpret_cast<int*>(red + 2 * SH::WP);
  }
};

template <class SH>
__device__ void solve_pair(const Args& a, const Ladder& lad, int p, int t, const Smem<SH>& sm) {
  constexpr int S = SH::S, W = SH::W, R = SH::R, C = SH::C, B = SH::B, A = SH::A, NT = SH::NT;
  constexpr int KC = halving_keep(C, 16, B);                   // columns a lane keeps
  constexpr int COL_COPIES = butterfly_bits(C, 16, B);          // lanes holding the same
  constexpr int KR = halving_keep(R, B / 2, 1);                 // rows a lane keeps
  constexpr int ROW_COPIES = butterfly_bits(R, B / 2, 1);
  // the lane bits of row k's holder in its tile row: k / KR, by halving steps
  constexpr int ROW_STRIDE = B * KR / R;
  static_assert(R % KR == 0 && (R / KR) * ROW_STRIDE <= B, "rows halve evenly");
  const int lane = t & 31, w = t >> 5;
  const int cb = lane % B, tr = w * A + lane / B;
  const int row0 = tr * R, col0 = cb * C;
  PROF_DECL

  // 1. compacted bars, sentinel for an empty side
  const uint8_t* r1 = a.m1 + (size_t)p * a.K1;
  const uint8_t* r2 = a.m2 + (size_t)p * a.K2;
  const int c1 = count_bars(r1, a.K1, lane), c2 = count_bars(r2, a.K2, lane);
  if (w == 0) {
    compact(a.b1 + (size_t)p * a.K1, a.d1 + (size_t)p * a.K1, r1, a.K1, lane, sm.b1, sm.d1);
    compact(a.b2 + (size_t)p * a.K2, a.d2 + (size_t)p * a.K2, r2, a.K2, lane, sm.b2, sm.d2);
  }
  group_sync<SH>();
  Bars bars{sm.b1, sm.d1, sm.b2, sm.d2, c1 > 0 ? c1 : 1, c2 > 0 ? c2 : 1, 0.0f, 0.0f};

  // 2. blockers, Dm and scale
  float mx = 0.0f;
  for (int i = t; i < bars.n1 * bars.n2; i += NT) {
    const int r = i / bars.n2, cc = i - r * bars.n2;
    mx = fmaxf(mx, fmaxf(fabsf(sm.b1[r] - sm.b2[cc]), fabsf(sm.d1[r] - sm.d2[cc])));
  }
  bars.blocker = group_reduce<SH, true, float>(mx, sm.red);
  mx = bars.blocker;
  for (int k = t; k < bars.n1; k += NT) mx = fmaxf(mx, 0.5f * (sm.d1[k] - sm.b1[k]));
  bars.blocker2 = group_reduce<SH, true, float>(mx, sm.red);
  PROF_TICK(kProfSetup)
  mx = 0.0f;
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int l = 0; l < C; ++l) {
      const float D = cost<W>(bars, row0 + k, col0 + l);
      sm.dm[(k * C + l) * NT + t] = D;
      if (D < REAL_BELOW) mx = fmaxf(mx, D);
    }
  const float scale = fmaxf(group_reduce<SH, true, float>(mx, sm.red), 1e-9f);
  const float off = 1e3f * scale;  // Dm off the real entries
#pragma unroll
  for (int e = 0; e < R * C; ++e)
    if (!(sm.dm[e * NT + t] < REAL_BELOW)) sm.dm[e * NT + t] = (typename SH::Dm)off;
  for (int i = t; i < S; i += NT) {
    sm.f[i] = 0.0;
    sm.g[i] = 0.0;
    if constexpr (SH::WP > 1) sm.v[i] = 1.0f;
  }
  group_sync<SH>();
  PROF_TICK(kProfDm)

  // 3. the epsilon ladder
  float K[R][C];
  float v[C];             // WP == 1: v of this lane's columns
  float u_own[KR];        // u of rows row0 + kr + [0, KR)
  float v_own = 1.0f;     // v of this thread's own column
  int kr = 0;             // the row of this lane's row sum
  for (int s = 0; s < lad.steps; ++s) {
    const float eps = lad.rel[s] * scale;
    const double inv_eps = 1.0 / (double)eps;
    for (int done = 0; done < lad.iters; done += lad.absorb) {
      const int blk = min(lad.absorb, lad.iters - done);
      {
        double fr[R];
#pragma unroll
        for (int k = 0; k < R; ++k) fr[k] = sm.f[row0 + k];
#pragma unroll
        for (int l = 0; l < C; ++l) {
          const double gl = sm.g[col0 + l];
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const double dm = (double)sm.dm[(k * C + l) * NT + t];
            K[k][l] = expf((float)(((fr[k] + gl) - dm) * inv_eps));
          }
        }
      }
#pragma unroll
      for (int l = 0; l < C; ++l) v[l] = 1.0f;
      PROF_TICK(kProfRebuild)
      for (int it = 0; it < blk; ++it) {
        // row sums
        if constexpr (SH::WP > 1) {
#pragma unroll
          for (int l = 0; l < C; ++l) v[l] = sm.v[col0 + l];
        }
        float acc[R];
#pragma unroll
        for (int k = 0; k < R; ++k) acc[k] = 0.0f;
#pragma unroll
        for (int l = 0; l < C; ++l)
#pragma unroll
          for (int k = 0; k < R; ++k) acc[k] = fmaf(K[k][l], v[l], acc[k]);
        kr = 0;
        halving_sum<R, B / 2, 1>(acc, lane, kr);
#pragma unroll
        for (int q = 0; q < KR; ++q) u_own[q] = 1.0f / fmaxf(acc[q], TINY);
        float u[R];
#pragma unroll
        for (int k = 0; k < R; ++k)
          u[k] = KR == R ? u_own[k % KR]
                         : __shfl_sync(FULL, u_own[k % KR],
                                       (lane & ~(B - 1)) + (k / KR) * ROW_STRIDE);
        PROF_TICK(kProfRow)
        // column sums
        float cs[C];
#pragma unroll
        for (int l = 0; l < C; ++l) cs[l] = 0.0f;
#pragma unroll
        for (int k = 0; k < R; ++k)
#pragma unroll
          for (int l = 0; l < C; ++l) cs[l] = fmaf(K[k][l], u[k], cs[l]);
        int kc = 0;
        if constexpr (A > 1) halving_sum<C, 16, B>(cs, lane, kc);
        if constexpr (SH::WP > 1) {
          if ((lane & COL_COPIES) == 0)
#pragma unroll
            for (int q = 0; q < KC; ++q) sm.part[w * S + col0 + kc + q] = cs[q];
          __syncthreads();
          if (t < S) {
            float sum = sm.part[t];
#pragma unroll
            for (int ww = 1; ww < SH::WP; ++ww) sum += sm.part[ww * S + t];
            v_own = 1.0f / fmaxf(sum, TINY);
            sm.v[t] = v_own;
          }
          __syncthreads();
        } else {
          v_own = 1.0f / fmaxf(cs[0], TINY);  // column col0 + kc
#pragma unroll
          for (int l = 0; l < C; ++l) v[l] = __shfl_sync(FULL, v_own, l * B + cb);
        }
        PROF_TICK(kProfCol)
      }
      // absorb u, v into the duals
      if ((lane & ROW_COPIES) == 0)
#pragma unroll
        for (int q = 0; q < KR; ++q) sm.f[row0 + kr + q] += (double)eps * log((double)u_own[q]);
      if constexpr (SH::WP > 1) {
        if (t < S) {
          sm.g[t] += (double)eps * log((double)v_own);
          sm.v[t] = 1.0f;
        }
      } else {
        sm.g[col0 + (lane / B)] += (double)eps * log((double)v_own);
      }
      group_sync<SH>();
    }
  }

  // 4. <P, D> over the real entries
  const double inv_lo = 1.0 / (double)(lad.lo * scale);
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int l = 0; l < C; ++l) {
      const float dm = (float)sm.dm[(k * C + l) * NT + t];
      const float P = expf((float)(((sm.f[row0 + k] + sm.g[col0 + l]) - (double)dm) * inv_lo));
      acc += (double)P * (dm < off ? dm : 0.0f);
    }
  const double total = group_reduce<SH, false, double>(acc, sm.red);
  if (t == 0) a.out[p] = (float)total;
  PROF_TICK(kProfFinal)
  PROF_STORE(p)
  group_sync<SH>();   // the group's shared memory is free for its next pair
}

// Each pair group takes the next pair of class `cls` until the list is done.
template <class SH>
__global__ void __launch_bounds__(SH::THREADS, SH::BPS)
sinkhorn_class_kernel(const Args a, const Ladder lad, int cls) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = SH::WP == 1 ? threadIdx.x >> 5 : 0;
  const int t = SH::WP == 1 ? threadIdx.x & 31 : threadIdx.x;
  const Smem<SH> sm(smem + grp * SH::GROUP_BYTES);
  const int count = a.counts[cls];
  const int* list = a.list + (size_t)cls * a.n_pairs;
  for (;;) {
    int slot;
    if constexpr (SH::WP == 1) {
      slot = __shfl_sync(FULL, t == 0 ? atomicAdd(a.work + cls, 1) : 0, 0);
    } else {
      if (t == 0) *sm.slot = atomicAdd(a.work + cls, 1);
      __syncthreads();
      slot = *sm.slot;   // rewritten only after the pair's barriers
    }
    if (slot >= count) return;
    solve_pair<SH>(a, lad, list[slot], t, sm);
  }
}

// one thread per pair: its class (the smallest width that holds its larger
// side) and its place in that class's list
__global__ void bucket_kernel(const Args a, int* counts, int* list) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.n_pairs) return;
  int c1 = 0, c2 = 0;
  for (int k = 0; k < a.K1; ++k) c1 += a.m1[(size_t)p * a.K1 + k] != 0;
  for (int k = 0; k < a.K2; ++k) c2 += a.m2[(size_t)p * a.K2 + k] != 0;
  const int c = c1 > c2 ? c1 : c2;
  const int cls = c <= 16 ? 0 : c <= 40 ? 1 : c <= 80 ? 2 : 3;
  list[(size_t)cls * a.n_pairs + atomicAdd(counts + cls, 1)] = p;
}

template <class SH>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(sinkhorn_class_kernel<SH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SH::BYTES);
}

template <class SH>
cudaError_t launch_class(const Args& a, const Ladder& lad, int cls, int n_sms,
                         cudaStream_t stream) {
  const cudaError_t e = set_smem<SH>();
  if (e != cudaSuccess) return e;
  sinkhorn_class_kernel<SH><<<SH::BPS * n_sms, SH::THREADS, SH::BYTES, stream>>>(a, lad, cls);
  return cudaGetLastError();
}

template <class SH>
int layout(int* o) {
  cudaFuncAttributes fa;
  int occ = 0;
  cudaError_t e = set_smem<SH>();
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, sinkhorn_class_kernel<SH>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, sinkhorn_class_kernel<SH>,
                                                      SH::THREADS, SH::BYTES);
  if (e != cudaSuccess) return (int)e;
  o[0] = SH::THREADS;
  o[1] = SH::BYTES;
  o[2] = SH::BPS;
  o[3] = fa.numRegs;
  o[4] = (int)fa.localSizeBytes;
  o[5] = occ;
  return 0;
}

}  // namespace

// The layout of width class `width` as this build compiled it: out[0..6) =
// threads a block, dynamic shared bytes a block, blocks an SM by design (the
// persistent grid is that times the SMs), registers a thread, local (spill)
// bytes a thread, and the blocks an SM the card's occupancy calculator
// allows.  Returns the cudaError_t of the queries.
extern "C" int sinkhorn_tiered_layout(int width, int* out) {
  switch (width) {
    case 16: return layout<Class16>(out);
    case 40: return layout<Class40>(out);
    case 80: return layout<Class80>(out);
    case 96: return layout<Class96>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One call over n_pairs pairs: zero the class counters in scratch (8 + 4 *
// n_pairs ints), bucket the pairs, then one persistent launch per width class
// up to max_width (16, 40, 80 or 96; every pair must fit it), n_sms SMs.
// eps_rel holds `steps` float32 rungs.  prof / stamps (null but in the
// instrumented build): kProfSlots and 3 int64 per pair.  Returns the
// cudaError_t of the first call that failed.
extern "C" int sinkhorn_tiered_launch(const float* b1, const float* d1, const uint8_t* m1, int K1,
                                      const float* b2, const float* d2, const uint8_t* m2, int K2,
                                      int n_pairs, const float* eps_rel, int steps, float eps_lo,
                                      int iters, int absorb, float* out, int* scratch,
                                      int max_width, int n_sms, long long* prof,
                                      long long* stamps, void* stream) {
  if (steps < 1 || steps > MAX_STEPS || iters < 0 || absorb < 1 || n_pairs < 1 || K1 < 1 ||
      K2 < 1 || K1 > MAX_K || K2 > MAX_K || n_sms < 1 || max_width < (K1 > K2 ? K1 : K2) ||
      (max_width != 16 && max_width != 40 && max_width != 80 && max_width != 96))
    return (int)cudaErrorInvalidValue;
  Ladder lad{};
  for (int s = 0; s < steps; ++s) lad.rel[s] = eps_rel[s];
  lad.lo = eps_lo;
  lad.steps = steps;
  lad.iters = iters;
  lad.absorb = absorb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{b1, d1, b2, d2, m1, m2, K1, K2, n_pairs, scratch, scratch + N_CLASSES,
               scratch + 2 * N_CLASSES, out, prof, stamps};
  cudaError_t e = cudaMemsetAsync(scratch, 0, 2 * N_CLASSES * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  bucket_kernel<<<(n_pairs + 255) / 256, 256, 0, st>>>(a, scratch, scratch + 2 * N_CLASSES);
  e = cudaGetLastError();
  if (e == cudaSuccess && max_width >= 16) e = launch_class<Class16>(a, lad, 0, n_sms, st);
  if (e == cudaSuccess && max_width >= 40) e = launch_class<Class40>(a, lad, 1, n_sms, st);
  if (e == cudaSuccess && max_width >= 80) e = launch_class<Class80>(a, lad, 2, n_sms, st);
  if (e == cudaSuccess && max_width >= 96) e = launch_class<Class96>(a, lad, 3, n_sms, st);
  return (int)e;
}
