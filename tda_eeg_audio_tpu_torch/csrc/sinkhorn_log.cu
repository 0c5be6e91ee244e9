// Un-tiered log-domain H1 Sinkhorn of the staged path and the control's exact
// redo for sm_90a: the epsilon-annealed entropic OT cost <P, D> on persim's
// cost matrix, one block per diagram pair at the pair's own width, each row
// (column) of the cost matrix split over L lanes.
//
// Replaces no Pallas kernel.  The JAX package computes the same function as
// XLA code: `tda_eeg_audio_tpu/ops/wasserstein.py::sinkhorn_cost` (:93, one
// jitted `lax.fori_loop` a rung, :128) over `build_cost_matrix` (:31), 512
// pairs a call at the staged pad width K = 128 (S = 256).  The port's plain
// version (`ops/wasserstein.py::sinkhorn_cost_pairs` on a CPU tensor) runs it
// as a Python loop of 480 logsumexp half-steps, each over a materialised
// (512, 256, 256) float32 tensor.
//
// Per pair (one block of 256 threads):
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
//      float32 as the plain version's; Dm = D where real, 1e3 * scale
//      elsewhere;
//   3. the cost matrix, rows [side-1 bars | side-2 helpers] x columns
//      [side-2 bars | side-1 slots]:
//        bar i, bar c:       max(|b1_i - b2_c|, |d1_i - d2_c|)   (the table)
//        bar i, slot k:      k == i ? h1_i : blocker
//        helper j, bar c:    c == j ? h2_c : blocker2
//        helper j, slot k:   0
//      Only the bar x bar block is general.  Its Dm is written once a pair to
//      the dynamic shared memory (the table, row stride P >= n2) when n1 x P
//      doubles fit (TABLE); a larger pair computes it from the bars when it
//      uses it.  The other three blocks are a constant and a diagonal, so
//      each entry of a line is one shared load from an address the line
//      fixes — along its table row (column), or a cell holding the constant
//      — then the diagonal: every line walks the same loop, whichever block
//      it starts in, with no branch;
//   4. the ladder: eps = rel[s] * scale (float32, as the plain version's), s
//      < steps, `iters` iterations a rung of
//        F_i = -logsumexp_c(G_c - Dm_ic / eps)   (rows: side-1 bars, helpers)
//        G_c = -logsumexp_i(F_i - Dm_ic / eps)   (columns)
//      with the duals F = f / eps, G = g / eps held in units of the rung's
//      eps (rescaled by eps_prev / eps when the rung changes), so an exponent
//      is one fma.  A line (row or column) is split over L lanes, L = 8, 4,
//      2, 1 for S <= 32, 64, 128, 256 (the largest power of two with S * L
//      <= 256), chosen per pair, so uniform within the block: lane l takes
//      entries l, l + L, l + 2L, ... online in chunks of 8 (the chunk's
//      largest exponent, by a tree, rescales the float64 sum by expf when it
//      exceeds the running max, the chunk's 8 expf terms are summed in
//      float32 in order and added to the float64 sum); the L partial (max,
//      sum) pairs are merged by
//      __shfl_xor_sync in a fixed order, m = max, s = s_a e^(m_a - m) + s_b
//      e^(m_b - m) (each factor expf of the float32-rounded exponent), which
//      both lanes of a merge compute alike;
//   5. out[p] = sum over real entries of exp(F_i + G_c - D_ic / eps_lo) *
//      D_ic, each lane's entries in float64, then the block's threads in a
//      fixed order (a butterfly in each warp, then the warps in order).
//
// Lanes to entries.  The table is read along its rows in the row pass and
// along its columns in the column pass.  A 64-bit shared load serves a warp
// as two half-warps of 16 threads, each free of bank conflicts when its 16
// addresses differ mod 16 doubles.  The L lanes of a line sit either side by
// side in the warp (lane = line * L + l, merged by xor 1, 2, 4) or 32 / L
// apart (lane = l * 32 / L + line, merged by xor 32 / L, ...), and P is the
// least stride >= n2 with the residue that keeps both passes free:
//        L   row pass      column pass   P mod 16
//        1   -             -             odd
//        2   side by side  32 / L apart  2 mod 4
//        4   side by side  side by side  4 mod 8
//        8   32 / L apart  32 / L apart  4 mod 8
// The duals and the bars are read at the same entry by every line of a warp:
// L distinct doubles, broadcast.
//
// Arithmetic: the bars, the costs, the duals F and G (shared memory), every
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
// The bars in and 4 bytes out a pair are far below.  A line's chain is
// ceil(S / L) entries (a chunk of 4 for a tail of at most 4) and log2 L
// merges a half-step; every warp of a block but the last walks whole lines.
// Each entry takes ~25 instructions (expf's 8, the shared loads of its
// cost and its dual, the fma, its share of the tree max, the float32
// rounding, the segment and diagonal selects) where the expf bound counts
// one SFU op, so the SMs' instruction rate, not the SFU, is the design's
// floor; a call of few pairs waits on its widest pairs' chains (PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsinkhorn_log.so sinkhorn_log.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;       // blocks an SM: 64 registers a thread, 4 tables
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 128;          // slots a side
constexpr int MAX_S = 2 * MAX_K;    // n1 + n2
constexpr int CHUNK = 8;            // a lane's entries a step of the online logsumexp
constexpr int MAX_STEPS = 16;
constexpr int TABLE = 5632;         // doubles of the bar x bar table (44 KiB)
constexpr double REAL_BELOW = 1e8;  // real = D < 1e8; build_cost_matrix's 1e9 is not
constexpr double M0 = -1e300;       // a lane's running max before its first entry

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
  double f[MAX_S], g[MAX_S];             // duals F, G in units of the rung's eps; -inf past S
  double b1[MAX_K], d1[MAX_K], b2[MAX_K], d2[MAX_K];
  double h1[MAX_K], h2[MAX_K];           // h, then Dm of the diagonal entries
  double cell[3];                        // 0, Dm of blocker, Dm of blocker2
  double red[WARPS];
  int n1, n2;
};
enum { CELL_ZERO, CELL_B, CELL_B2 };

// what every line of a pair shares
struct Pair {
  int n1, n2, S, L, P, nk;  // nk: entries a lane walks, ceil(S / L)
  double big_m;             // 1e3 * scale
};

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ double nanmax(double a, double b) { return (a > b || a != a) ? a : b; }

// the largest power of two L <= 8 with S * L <= THREADS
__device__ __forceinline__ int lanes_of(int S) {
  int L = 8;
  while (L > 1 && S * L > THREADS) L >>= 1;
  return L;
}

// the table's row stride: the least P >= n2 whose residue mod 16 keeps the
// row and the column pass free of bank conflicts at L lanes (see the top)
__device__ __forceinline__ int table_pitch(int n2, int L) {
  const int mask = L == 1 ? 1 : L == 2 ? 3 : 7, want = L == 1 ? 1 : L == 2 ? 2 : 4;
  int p = n2;
  while ((p & mask) != want) ++p;
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a shared-memory load the compiler keeps where it is written: every entry
// loads its cost unconditionally (no branch around the load)
__device__ __forceinline__ double lds(uint32_t a) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(a));
  return v;
}

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

__device__ __forceinline__ double max2(double a, double b) { return a > b ? a : b; }

// One chunk of a lane's logsumexp: x[0, N) exponents (-inf past the end).
// The running max m and float64 sum s of exp(x - m): the chunk's max (a
// tree) rescales s by expf when it exceeds m (expf(0) = 1 otherwise), then
// the chunk's expf terms are summed in float32 in order.
template <int N>
__device__ __forceinline__ void lse_chunk(const double (&x)[N], double& m, double& s) {
  double t[N / 2];
#pragma unroll
  for (int q = 0; q < N / 2; ++q) t[q] = max2(x[2 * q], x[2 * q + 1]);
#pragma unroll
  for (int w = N / 4; w > 0; w >>= 1)
#pragma unroll
    for (int q = 0; q < w; ++q) t[q] = max2(t[2 * q], t[2 * q + 1]);
  const double mn = max2(t[0], m);
  s *= (double)expf((float)(m - mn));
  m = mn;
  float cs = 0.0f;
#pragma unroll
  for (int q = 0; q < N; ++q) cs += expf((float)(x[q] - m));
  s += (double)cs;
}

// the L lanes' (m, s) of a line merged, xor offsets lstride, 2 lstride, ...
__device__ __forceinline__ void lse_merge(double& m, double& s, int L, int lstride) {
  for (int o = lstride; o < lstride * L; o <<= 1) {
    const double mo = __shfl_xor_sync(FULL, m, o), so = __shfl_xor_sync(FULL, s, o);
    const double mm = fmax(m, mo);
    s = s * (double)expf((float)(m - mm)) + so * (double)expf((float)(mo - mm));
    m = mm;
  }
}

// a thread's line and lane: the line g and lane l, and the xor offset of
// the line's first merge
struct Lane {
  int g, l, lstride;
};

__device__ __forceinline__ Lane lane_of(int L, bool apart) {
  const int lane = threadIdx.x & 31, per = 32 / L;
  const int base = (threadIdx.x >> 5) * per;
  return apart ? Lane{base + lane % per, lane / per, per} : Lane{base + lane / L, lane % L, 1};
}

// One line of the cost matrix: row g (ROW) or column g, its entries e.
// Each entry's Dm is one shared load from an address the line fixes: its
// first segment (the other side's bars) from the table (TAB, a bar line:
// along a table row, or a column) or from a constant cell (a helper / slot
// line: blocker2 / blocker), its second segment from a constant cell
// (blocker / blocker2 for a bar line, 0 otherwise); then the diagonal.
// Past the line's end the entry's dual is -inf, so its exponent is -inf.
// Without the table a bar line's first segment is computed from the bars.
template <bool ROW, bool TAB>
struct Line {
  uint32_t a_base, a_step, b_addr, ob, od;  // shared addresses, bytes
  double xb, xd, dval, big_m;
  int nA, dpos;
  bool own;  // a bar line (a side-1 row, a side-2 column)

  __device__ __forceinline__ Line(const Smem& sm, const double* tl, const Pair& q, int g)
      : big_m(q.big_m) {
    const int n_own = ROW ? q.n1 : q.n2;
    own = g < n_own;
    nA = ROW ? q.n2 : q.n1;
    const int go = own ? g : 0, gh = own ? 0 : g - n_own;  // indices in range either way
    const double* own_h = ROW ? sm.h1 : sm.h2;
    const double* oth_h = ROW ? sm.h2 : sm.h1;
    dpos = own ? nA + g : gh;
    dval = own ? own_h[go] : oth_h[gh];
    xb = (ROW ? sm.b1 : sm.b2)[go];
    xd = (ROW ? sm.d1 : sm.d2)[go];
    ob = smem_addr(ROW ? sm.b2 : sm.b1);
    od = smem_addr(ROW ? sm.d2 : sm.d1);
    const uint32_t cell = smem_addr(sm.cell);
    // a helper (slot) line against the other side's bars: blocker2 (blocker)
    const uint32_t offA = cell + 8 * (ROW ? CELL_B2 : CELL_B);
    // a bar line against the other side's helpers (slots): blocker (blocker2)
    const uint32_t offB = cell + 8 * (ROW ? CELL_B : CELL_B2);
    a_base = TAB && own ? smem_addr(tl) + 8 * (ROW ? g * q.P : g) : offA;
    a_step = TAB && own ? 8 * (ROW ? 1 : q.P) : 0;
    b_addr = own ? offB : cell + 8 * CELL_ZERO;
  }

  // Dm of entry e (0 <= e < MAX_S; past S a finite constant)
  __device__ __forceinline__ double dm(int e) const {
    const bool inA = e < nA;
    double D = lds(inA ? a_base + e * a_step : b_addr);
    if (!TAB) {
      const uint32_t k = 8 * (inA ? e : 0);
      const double db = fabs(xb - lds(ob + k)), dd = fabs(xd - lds(od + k));
      // max(|db|, |dd|) where both are real (< 1e8; NaN is not), else 1e3 * scale
      const double T = db < REAL_BELOW && dd < REAL_BELOW ? max2(db, dd) : big_m;
      D = own && inA ? T : D;
    }
    return e == dpos ? dval : D;
  }
};

// One half-step: every line's dual out[g] = -logsumexp_e(in[e] - Dm(g, e) * inv)
template <bool ROW, bool TAB>
__device__ __forceinline__ void half_step(const Smem& sm, const double* tl, const Pair& q,
                                          double inv, const double* in, double* out) {
  const int L = q.L;
  const Lane ln = lane_of(L, ROW ? L == 8 : (L == 2 || L == 8));
  if ((threadIdx.x >> 5) * (32 / L) >= q.S) return;  // a whole warp past the last line
  const Line<ROW, TAB> line(sm, tl, q, ln.g < q.S ? ln.g : q.S - 1);
  const uint32_t dual = smem_addr(in);
  // the exponent of a lane's k-th entry; e < MAX_S: at L = 8, 4, 2, 1 (S <=
  // 32, 64, 128, 256) a lane's chunks end by entry 64, 64, 128, 256 (the
  // duals past S hold -inf)
  auto x_of = [&](int k) {
    const int e = ln.l + L * k;
    return fma(-line.dm(e), inv, lds(dual + 8 * e));
  };
  double m = M0, s = 0.0;
  int k0 = 0;
  for (; k0 + CHUNK <= q.nk; k0 += CHUNK) {
    double x[CHUNK];
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) x[u] = x_of(k0 + u);
    lse_chunk(x, m, s);
  }
  // the tail: a chunk of 4 when at most 4 entries are left (its padding
  // adds 0 to the sum and nothing to the max, as a chunk of 8's would)
  if (q.nk - k0 > CHUNK / 2) {
    double x[CHUNK];
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) x[u] = x_of(k0 + u);
    lse_chunk(x, m, s);
  } else if (q.nk > k0) {
    double x[CHUNK / 2];
#pragma unroll
    for (int u = 0; u < CHUNK / 2; ++u) x[u] = x_of(k0 + u);
    lse_chunk(x, m, s);
  }
  lse_merge(m, s, L, ln.lstride);
  if (ln.g < q.S && ln.l == 0) out[ln.g] = -(m + log(s));
}

// a thread's share of <P, D>: its row's entries, exp(r (F_i + G_c) - D_ic /
// eps_lo) * D_ic over the real ones (the helper x slot block costs 0 and is
// left out)
template <bool TAB>
__device__ __forceinline__ double result_part(const Smem& sm, const double* tl, const Pair& q,
                                              double inv_lo, double r) {
  const Lane ln = lane_of(q.L, q.L == 8);
  if ((threadIdx.x >> 5) * (32 / q.L) >= q.S || ln.g >= q.S) return 0.0;
  const Line<true, TAB> line(sm, tl, q, ln.g);
  const double fi = sm.f[ln.g];
  double acc = 0.0;
  for (int k = 0; k < q.nk; ++k) {
    const int e = ln.l + q.L * k;
    const double D = line.dm(e);
    const double term = (double)expf((float)fma(-D, inv_lo, r * (fi + sm.g[e]))) * D;
    const bool real = D < q.big_m && (line.own || e < q.n2);  // past S: exp(-inf) * D = 0
    acc += real ? term : 0.0;
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    sinkhorn_log_kernel(Args a, Ladder lad) {
  __shared__ Smem sm;
  extern __shared__ double tl[];  // TABLE doubles
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
  Pair q;
  q.n1 = n1;
  q.n2 = n2;
  q.S = S;
  q.L = lanes_of(S);
  q.P = table_pitch(n2, q.L);
  q.nk = (S + q.L - 1) / q.L;
  q.big_m = (double)(1e3f * scale);
  const bool table = n1 * q.P <= TABLE;

  // 3. Dm of the diagonals and of the constants, the table, the duals
  if (t == 0) {
    sm.cell[CELL_ZERO] = 0.0;
    sm.cell[CELL_B] = blocker < REAL_BELOW ? blocker : q.big_m;
    sm.cell[CELL_B2] = blocker2 < REAL_BELOW ? blocker2 : q.big_m;
  }
  for (int i = t; i < n1; i += THREADS)
    if (!(sm.h1[i] < REAL_BELOW)) sm.h1[i] = q.big_m;
  for (int c = t; c < n2; c += THREADS)
    if (!(sm.h2[c] < REAL_BELOW)) sm.h2[c] = q.big_m;
  if (table)
    for (int e = t; e < n1 * n2; e += THREADS) {
      const int i = e / n2, c = e - i * n2;
      const double D = nanmax(fabs(sm.b1[i] - sm.b2[c]), fabs(sm.d1[i] - sm.d2[c]));
      tl[i * q.P + c] = D < REAL_BELOW ? D : q.big_m;
    }
  for (int i = t; i < MAX_S; i += THREADS) sm.f[i] = sm.g[i] = i < S ? 0.0 : -INFINITY;
  __syncthreads();

  // 4. the ladder
  double eps_prev = 1.0;
  for (int s = 0; s < lad.steps; ++s) {
    const double eps = (double)(lad.rel[s] * scale);
    const double inv = 1.0 / eps;
    if (s > 0) {  // the duals into this rung's units
      const double r = eps_prev * inv;
      for (int i = t; i < S; i += THREADS) {
        sm.f[i] *= r;
        sm.g[i] *= r;
      }
      __syncthreads();
    }
    for (int it = 0; it < lad.iters; ++it) {
      if (table) half_step<true, true>(sm, tl, q, inv, sm.g, sm.f);
      else half_step<true, false>(sm, tl, q, inv, sm.g, sm.f);
      __syncthreads();
      if (table) half_step<false, true>(sm, tl, q, inv, sm.f, sm.g);
      else half_step<false, false>(sm, tl, q, inv, sm.f, sm.g);
      __syncthreads();
    }
    eps_prev = eps;
  }

  // 5. <P, D> over the real entries, the duals in units of eps_lo
  const double inv_lo = 1.0 / (double)(lad.lo * scale);
  const double r = eps_prev * inv_lo;
  const double part = table ? result_part<true>(sm, tl, q, inv_lo, r)
                            : result_part<false>(sm, tl, q, inv_lo, r);
  const double total = block_reduce<false>(part, sm.red);
  if (t == 0) a.out[p] = (float)total;
}

cudaError_t allow_table() {
  return cudaFuncSetAttribute(sinkhorn_log_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              TABLE * (int)sizeof(double));
}

}  // namespace

// The kernel as this library builds it: threads a block, shared bytes a
// block (static + the table), registers and local (spill) bytes a thread,
// blocks an SM by the card's occupancy calculator at that shared size.
// Returns a cudaError_t.
extern "C" int sinkhorn_log_layout(int* out) {
  cudaError_t e = allow_table();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, sinkhorn_log_kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sinkhorn_log_kernel, THREADS,
                                                    TABLE * sizeof(double));
  if (e != cudaSuccess) return (int)e;
  out[0] = THREADS;
  out[1] = (int)attr.sharedSizeBytes + TABLE * (int)sizeof(double);
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
  const cudaError_t e = allow_table();
  if (e != cudaSuccess) return (int)e;
  Ladder lad{};
  for (int s = 0; s < steps; ++s) lad.rel[s] = eps_rel[s];
  lad.lo = eps_lo;
  lad.steps = steps;
  lad.iters = iters;
  const Args a{b1, d1, b2, d2, m1, m2, K1, K2, n_pairs, out};
  sinkhorn_log_kernel<<<n_pairs, THREADS, TABLE * sizeof(double),
                        static_cast<cudaStream_t>(stream)>>>(a, lad);
  return (int)cudaGetLastError();
}
