// H1 phase 1 for the H100 (sm_90a): per window, the stable edge sort, the
// enclosing-radius cut, the rank matrix, the spanning forest and H0 deaths,
// the apparent-pair sieve and the list of non-apparent creators; one block
// per window, one launch per call, dm read once.
//
// Replaces the XLA prologue of tda_eeg_audio_tpu/ops/homology_h1.py::_phase1
// (its stable payload sort _sort_with_payload, and _boruvka_forest), which
// runs outside the Pallas body of h1_diagrams_pallas.  The port's plain
// version is tda_eeg_audio_tpu_torch/ops/homology_h1.py::_phase1; this kernel
// returns its outputs bit for bit, and its edge order is the order of the
// CPU's torch.sort(stable=True) and of JAX's lax.sort, whatever the card's
// own sort does with signed zeros.
//
// What bounds it: the function's bytes are dm in and the dict out, once
// (0.091 ms at n = 124 for 1,200 clouds); the work is each window's sort of
// its m edges, its forest and its sieve, all in shared memory, and the sort
// and the forest are chains of dependent shared-memory reads between block
// barriers.  The design:
//  * the sort key of edge (i, j), i < j, is (canonical bits of its float32
//    weight, i << 7 | j) in 64 bits: -0.0 maps to +0.0, every NaN to one
//    value above +inf, then the sign-flip twiddle.  Row-major (i, j) is the
//    static edge order, so the key is a strict total order and any correct
//    sort of it is the stable sort of the weights; it also carries each
//    edge's endpoints, so nothing decodes a static index;
//  * the sort is a merge sort in place: a thread sorts 16 keys in registers
//    (a bitonic network), then each level merges runs pairwise, each thread
//    finding its 16 outputs' start on the merge path by a binary search and
//    merging them into registers before a barrier; ceil(log2(m / 16))
//    levels, 9 at n = 124.  So a block has one thread per 16 edges: 512 at
//    n = 124 (2 blocks an SM at the 64 registers a thread this allows), 128
//    at n <= 64;
//  * the keys are dead once the order is known: the uint16 rank matrix and
//    the uint8 edge flags overlay them, and the last merge writes the
//    (i << 7 | j) of each rank and counts the in-complex edges from
//    registers.  82,480 B at n = 124;
//  * ew_r is read from dm at each rank's (i, j), so -0.0 and each NaN keep
//    their bits; the H0 deaths likewise, as the forest finds its edges;
//  * the spanning forest over the in-complex ranks is unique (the ranks are
//    a strict total order), so any minimum-spanning-forest algorithm gives
//    the plain version's bits: Boruvka rounds in shared memory (half a warp
//    per vertex row finds its cheapest outgoing edge, 8 vertices a lane
//    from one 16-byte read of ranks and one 8-byte read of uint8 roots, an
//    atomicMin per component, roots hook across it, a mutual pair keeps the
//    smaller root, every vertex chases its root), marking tree edges by rank
//    and listing them with their weights; an H0 death's place is its edge's
//    count of smaller tree ranks;
//  * the sieve: edge r = (i, j) is apparent when some vertex v has
//    rank[i][v] < r and rank[j][v] < r, its partner the first such v.  A
//    thread per edge scans 8 vertices a step: two 16-byte reads of the two
//    rows (rows 16-byte multiples apart, an odd number of them, so a warp's
//    reads of different rows spread over the banks), and a 32-bit
//    subtraction compares two ranks at once (ranks and "absent", 0x7FFF,
//    are below 0x8000).  A tree edge has no such v (it would join i and j
//    below r), so its scan is skipped;
//  * the creator list (descending) is compacted with block prefix sums.
//
// With -DH1_PHASE1_PROFILE (a build of its own, never loaded by the port's
// entry points) each part ends with a barrier, thread 0 of each block sums
// clock64() ticks per part, and each window records its start, end
// (globaltimer, ns) and SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libh1_phase1.so h1_phase1.cu

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxN = 128;
constexpr int kMaxWarps = 32;
constexpr int kBig = 2000000000;       // homology_h1.BIG: "absent" in rank_mat
constexpr uint16_t kAbsent = 0x7FFF;   // the same in the shared uint16 copy
constexpr uint8_t kTree = 1;           // edge flags, by rank
constexpr uint8_t kCreator = 2;        // positive and not apparent
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSeg = 16;               // sort keys a thread holds in registers
constexpr int kRows = 4;               // dm rows a warp reads at once
constexpr uint32_t kNanKey = 0xFFC00000u;   // every NaN, above +inf's 0xFF800000

using u64 = unsigned long long;

// profile slots (int64 per window): ticks of thread 0 per part, each part
// closed by a barrier, then counters
enum { kProfSort, kProfRanks, kProfRadius, kProfWrite, kProfForest, kProfSieve,
       kProfH0, kProfCreators, kProfTotal, kProfRounds, kProfSlots };

#ifdef H1_PHASE1_PROFILE
#define PROF_DECL long long prof_[kProfSlots] = {0}; long long t_ = clock64(); \
  const long long t_begin_ = t_; const unsigned long long stamp0_ = globaltimer_ns();
#define PROF_TICK(slot) { __syncthreads(); const long long c_ = clock64(); \
  prof_[slot] += c_ - t_; t_ = c_; }
#define PROF_ADD(slot, v) { prof_[slot] += (v); }
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
#else
#define PROF_DECL
#define PROF_TICK(slot)
#define PROF_ADD(slot, v)
#endif

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

// shared-memory index of sort position i (8-byte keys): one spare key per
// 16, so that a thread's 16 consecutive keys and its neighbours' fall on
// distinct banks
__host__ __device__ inline int pad(int i) { return i + (i >> 4); }

// row stride of the shared rank matrix: a multiple of 8 ranks (16 bytes)
// with an odd number of 16-byte words, so that 8 threads reading 16 bytes
// each from 8 rows mostly hit distinct banks
__host__ __device__ inline int row_stride(int n) {
  int s = (n + 7) & ~7;
  return (s & 8) ? s : s + 8;
}

struct Layout {
  int key, rank, flag, ij, comp, parent, cbest, tree_r, tree_w, scratch, total;
};

// Dynamic shared memory of an n-point window, in bytes (phase1_cuda.py's
// kernel_plan reckons the same and checks it at load).
__host__ __device__ inline Layout layout(int n) {
  const int m = n * (n - 1) / 2;
  Layout L;
  const int padded = pad(m);
  const int rank_bytes = up16(2 * n * row_stride(n));
  int o = 0;
  L.key = o;                                     // uint64 sort keys, then
  L.rank = o;                                    //   the uint16 rank matrix
  L.flag = o + rank_bytes;                       //   and kTree | kCreator by rank
  o += max(up16(8 * padded), rank_bytes + up16(m));
  L.ij = o;      o += up16(2 * m);               // i << 7 | j by rank
  L.comp = o;    o += up16(row_stride(n));       // forest: uint8 root of each vertex
  L.parent = o;  o += up16(4 * n);               //   hook of each root
  L.cbest = o;   o += up16(4 * n);               //   cheapest outgoing rank
  L.tree_r = o;  o += up16(4 * n);               //   tree edges' ranks
  L.tree_w = o;  o += up16(4 * n);               //   and weights, as found
  L.scratch = o; o += up16(4 * (2 * kMaxWarps + 4));
  L.total = o;
  return L;
}

struct Args {
  const float* dm;        // (B, n, n)
  const void* n_pts;      // (B,) int32 or int64, or null: all points valid
  int n_pts_64;
  float thresh;
  int n, m, na_eff, na_max;
  float* ew_r;            // (B, m)
  int* rank_mat;          // (B, n, n)
  int* iu_r;              // (B, m)
  int* ju_r;
  int* vstar_r;
  uint8_t* apparent_r;    // (B, m) bool
  int* na_list;           // (B, na_eff)
  uint8_t* overflow_na;   // (B,) bool
  float* h0_deaths;       // (B, n - 1)
  uint8_t* h0_mask;       // (B, n - 1) bool
  int* n_tree;            // (B,)
  int* m_cx;              // (B,)
  long long* prof;        // (B, kProfSlots), profile build only
  long long* stamps;      // (B, 3), profile build only
};

// canonical order-preserving bits of a float32 weight
__device__ __forceinline__ uint32_t sort_key(float x) {
  if (isnan(x)) return kNanKey;
  uint32_t u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Two 16-bit ranks packed in x and in y, all below 0x8000, against r in both
// halves of rr: bit 15 (31) set where the low (high) ranks of x and y are
// both below r.  (x | 0x8000) - r keeps bit 15 exactly when x >= r, and no
// half borrows from the other.
__device__ __forceinline__ uint32_t both_below(uint32_t x, uint32_t y, uint32_t rr) {
  return ~((x | 0x80008000u) - rr) & ~((y | 0x80008000u) - rr) & 0x80008000u;
}

// compare-exchange of positions a < b: the smaller to a
__device__ __forceinline__ void cmp_swap(u64& a, u64& b) {
  const u64 lo = a < b ? a : b, hi = a < b ? b : a;
  a = lo;
  b = hi;
}

// Merge sort of the m keys C (key << 16 | i << 7 | j, at pad(position)),
// ascending; a thread owns the 16 positions 16s .. 16s + 15 of segment
// s = threadIdx.x (blockDim.x * 16 >= m).  First each segment is sorted in
// registers by a bitonic network; then runs of L = 16, 32, ... are merged
// pairwise: each thread finds where its 16 outputs start in its pair of
// runs (a binary search along the merge path), merges them into registers,
// and all threads store after a barrier.  Positions >= m read as a key above
// every real one and are not stored.  The last merge stays in registers:
// it writes IJ by rank and returns the thread's count of keys <= lim.
// Every thread of the block must call it.
__device__ int merge_sort(u64* C, uint16_t* IJ, int m, u64 lim) {
  constexpr u64 kNone = ~0ull;
  const int s0 = threadIdx.x * kSeg;
  const bool mine = s0 < m;
  u64 c[kSeg];
#pragma unroll
  for (int e = 0; e < kSeg; ++e) c[e] = mine && s0 + e < m ? C[pad(s0 + e)] : kNone;
#pragma unroll
  for (int k = 2; k <= kSeg; k <<= 1) {
#pragma unroll
    for (int e = 0; e < kSeg; ++e)             // the flip: e against its mirror
      if ((e & (k >> 1)) == 0) cmp_swap(c[e], c[e ^ (k - 1)]);
#pragma unroll
    for (int j = k >> 2; j > 0; j >>= 1)
#pragma unroll
      for (int e = 0; e < kSeg; ++e)
        if ((e & j) == 0) cmp_swap(c[e], c[e + j]);
  }
  for (int L = kSeg; L < m; L <<= 1) {
    if (mine) {
#pragma unroll
      for (int e = 0; e < kSeg; ++e)
        if (s0 + e < m) C[pad(s0 + e)] = c[e];
    }
    __syncthreads();
    if (mine) {
      // runs A = [a0, a0 + la) and B = [a0 + L, a0 + L + lb); this thread's
      // outputs start d into their merge
      const int a0 = s0 / (2 * L) * (2 * L), d = s0 - a0;
      const int la = min(L, m - a0), lb = max(0, min(L, m - a0 - L));
      const int b0 = a0 + L;
      int lo = max(0, d - lb), hi = min(d, la);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (C[pad(a0 + mid)] < C[pad(b0 + d - 1 - mid)]) lo = mid + 1;
        else hi = mid;
      }
      int ia = lo, ib = d - lo;
      u64 ha = ia < la ? C[pad(a0 + ia)] : kNone;
      u64 hb = ib < lb ? C[pad(b0 + ib)] : kNone;
#pragma unroll
      for (int e = 0; e < kSeg; ++e) {
        const bool ta = ha < hb;
        c[e] = ta ? ha : hb;
        ia += ta ? 1 : 0;
        ib += ta ? 0 : 1;
        const bool more = ta ? ia < la : ib < lb;
        const u64 nx = more ? C[pad(ta ? a0 + ia : b0 + ib)] : kNone;
        ha = ta ? nx : ha;
        hb = ta ? hb : nx;
      }
    }
    __syncthreads();
  }
  int cnt = 0;
  if (mine) {
#pragma unroll
    for (int e = 0; e < kSeg; ++e)
      if (s0 + e < m) {
        IJ[s0 + e] = (uint16_t)c[e];
        cnt += c[e] <= lim ? 1 : 0;
      }
  }
  return cnt;
}

// Exclusive prefix count of `flag` over the block's threads in thread order;
// `total` gets the block's count.  Every thread of the block must call it.
__device__ inline int block_scan(bool flag, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned bal = __ballot_sync(kFull, flag);
  const int pre = __popc(bal & ((1u << lane) - 1u));
  if (lane == 0) scratch[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? scratch[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += t;
    }
    if (lane < nw) scratch[lane] = v;
  }
  __syncthreads();
  const int base = warp ? scratch[warp - 1] : 0;
  total = scratch[nw - 1];
  __syncthreads();
  return base + pre;
}

// 64 registers a thread: 2 blocks of 512 threads an SM
__global__ void __launch_bounds__(512, 2) h1_phase1_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, m = a.m;
  const Layout L = layout(n);
  u64* C = reinterpret_cast<u64*>(smem + L.key);
  uint16_t* R = reinterpret_cast<uint16_t*>(smem + L.rank);
  uint8_t* flag = smem + L.flag;
  uint16_t* IJ = reinterpret_cast<uint16_t*>(smem + L.ij);
  uint8_t* comp = smem + L.comp;
  int* parent = reinterpret_cast<int*>(smem + L.parent);
  int* cbest = reinterpret_cast<int*>(smem + L.cbest);
  int* tree_r = reinterpret_cast<int*>(smem + L.tree_r);
  float* tree_w = reinterpret_cast<float*>(smem + L.tree_w);
  const int ns = row_stride(n);
  int* scratch = reinterpret_cast<int*>(smem + L.scratch);

  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const float* D = a.dm + (size_t)b * n * n;
  PROF_DECL

  // 1. dm read once, a warp per row: the sort keys of the row's upper
  // triangle, and the enclosing radius over valid points, r_enc =
  // min_i max_j dm[i][j], NaN-propagating like torch's amax / amin
  int np = n;
  if (a.n_pts) {
    const long long v = a.n_pts_64 ? static_cast<const long long*>(a.n_pts)[b]
                                   : static_cast<const int*>(a.n_pts)[b];
    np = (int)max(0LL, min((long long)n, v));
  }
  float rmin = INFINITY;
  int rnan = 0;
  for (int i0 = warp; i0 < n; i0 += kRows * nw) {
    float x[kRows][kMaxN / 32];             // kRows rows of the warp in flight
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int c = 0; c < kMaxN / 32; ++c) {
        const int i = i0 + q * nw, j = lane + 32 * c;
        x[q][c] = i < n && j < n ? D[i * n + j] : 0.0f;
      }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = i0 + q * nw;
      if (i >= n) break;
      const int s0 = i * n - i * (i + 1) / 2 - i - 1;   // static index of (i, j): s0 + j
      float mx = -INFINITY;
      int isn = 0;
#pragma unroll
      for (int c = 0; c < kMaxN / 32; ++c) {
        const int j = lane + 32 * c;
        if (j > i && j < n) {
          C[pad(s0 + j)] = (u64)sort_key(x[q][c]) << 16 | (i << 7 | j);
        }
        if (j < np) {
          isn |= isnan(x[q][c]) ? 1 : 0;
          mx = fmaxf(mx, x[q][c]);
        }
      }
      for (int o = 16; o; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        isn |= __shfl_xor_sync(kFull, isn, o);
      }
      if (i < np) {
        if (isn) rnan = 1;
        else rmin = fminf(rmin, mx);
      }
    }
  }
  if (lane == 0) {
    scratch[warp] = rnan;
    scratch[kMaxWarps + warp] = __float_as_int(rmin);
  }
  __syncthreads();
  if (tid == 0) {
    int any_nan = 0;
    float r_enc = INFINITY;
    for (int w = 0; w < nw; ++w) {
      any_nan |= scratch[w];
      r_enc = fminf(r_enc, __int_as_float(scratch[kMaxWarps + w]));
    }
    // eff = min(thresh, r_enc) where r_enc is finite, else thresh (as
    // torch.minimum, a NaN thresh stays NaN)
    const float eff = (!any_nan && isfinite(r_enc) && !isnan(a.thresh))
                          ? fminf(a.thresh, r_enc) : a.thresh;
    scratch[2 * kMaxWarps] = __float_as_int(eff);
    scratch[2 * kMaxWarps + 1] = 0;
    scratch[2 * kMaxWarps + 2] = 0;
  }
  __syncthreads();
  PROF_TICK(kProfRadius)

  // 2. the stable edge sort, and the in-complex edges: ranks below
  // m_cx = #{r : ew_r[r] <= eff}, the keys up to eff's (none if eff is NaN)
  const float eff = __int_as_float(scratch[2 * kMaxWarps]);
  const u64 lim = isnan(eff) ? 0ull : (u64)sort_key(eff) << 16 | 0xFFFFu;
  int cnt = merge_sort(C, IJ, m, lim);
  for (int o = 16; o; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  if (lane == 0 && cnt) atomicAdd(&scratch[2 * kMaxWarps + 1], cnt);
  PROF_TICK(kProfSort)
  __syncthreads();
  const int mcx = scratch[2 * kMaxWarps + 1];

  // 3. ranks: the rank matrix over the dead keys; ew_r and the endpoints out
  float* EW = a.ew_r + (size_t)b * m;
#pragma unroll 4
  for (int r = tid; r < m; r += T) {
    const int ij = IJ[r];
    const int i = ij >> 7, j = ij & 127;
    R[i * ns + j] = R[j * ns + i] = (uint16_t)r;
    flag[r] = 0;
    EW[r] = D[i * n + j];
    a.iu_r[(size_t)b * m + r] = i;
    a.ju_r[(size_t)b * m + r] = j;
  }
  if (tid < n) {
    R[tid * ns + tid] = kAbsent;
    comp[tid] = (uint8_t)tid;
    parent[tid] = tid;
  }
  for (int i = warp; i < n; i += nw)
    for (int j = n + lane; j < ns; j += 32) R[i * ns + j] = kAbsent;
  PROF_TICK(kProfRanks)
  __syncthreads();

  // the rank matrix out
  int* RM = a.rank_mat + (size_t)b * n * n;
  for (int i = warp; i < n; i += nw)
    for (int j = lane; j < n; j += 32) {
      const int v = R[i * ns + j];
      RM[i * n + j] = v == kAbsent ? kBig : v;
    }
  PROF_TICK(kProfWrite)

  // 4. spanning forest of the in-complex edges, Boruvka rounds
  for (;;) {
    if (tid < n) cbest[tid] = kBig;
    __syncthreads();
    // half a warp per vertex row, 8 vertices a lane: one 16-byte read of
    // ranks, one 8-byte read of their roots
    for (int v0 = 2 * warp; v0 < n; v0 += 2 * nw) {
      const int v = v0 + (lane >> 4), u0 = (lane & 15) * 8;
      const int cv = v < n ? comp[v] : 0;
      int best = kBig;
      if (v < n && u0 < n) {
        const uint4 x = *reinterpret_cast<const uint4*>(R + v * ns + u0);
        const uint2 cu = *reinterpret_cast<const uint2*>(comp + u0);
        const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = (w[e >> 1] >> (16 * (e & 1))) & 0xFFFF;
          const int c = ((e < 4 ? cu.x : cu.y) >> (8 * (e & 3))) & 0xFF;
          if (k < mcx && c != cv) best = min(best, k);
        }
      }
      for (int o = 8; o; o >>= 1) best = min(best, __shfl_xor_sync(kFull, best, o));
      if ((lane & 15) == 0 && best < kBig) atomicMin(&cbest[cv], best);
    }
    __syncthreads();
    // each root with an outgoing edge hooks onto the component across its
    // cheapest one, which is a tree edge; two roots may share it, and then
    // the smaller lists it with its weight
    bool hooked = false;
    if (tid < n && comp[tid] == tid && cbest[tid] < kBig) {
      const int e = cbest[tid];
      flag[e] = kTree;
      const int ij = IJ[e];
      const int ci = comp[ij >> 7], cj = comp[ij & 127];
      const int other = ci == tid ? cj : ci;
      parent[tid] = other;
      if (cbest[other] != e || tid < other) {
        const int t = atomicAdd(&scratch[2 * kMaxWarps + 2], 1);
        tree_r[t] = e;
        tree_w[t] = D[(ij >> 7) * n + (ij & 127)];
      }
      hooked = true;
    }
    PROF_ADD(kProfRounds, 1)
    if (!__syncthreads_or(hooked)) break;
    // ranks are distinct, so the only hook cycles are mutual pairs: the
    // smaller root stays a root
    int p = 0;
    const bool root = tid < n && comp[tid] == tid;
    if (root) {
      p = parent[tid];
      if (p != tid && parent[p] == tid && tid < p) p = tid;
    }
    __syncthreads();
    if (root) parent[tid] = p;
    __syncthreads();
    if (tid < n) {
      int x = comp[tid];
      while (parent[x] != x) x = parent[x];
      comp[tid] = (uint8_t)x;
    }
    __syncthreads();
  }
  PROF_TICK(kProfForest)

  // 5. the sieve, one thread per edge in rank order: the first v with both
  // cross ranks below r, 8 vertices a step (two 16-byte reads; ranks and
  // kAbsent are below 0x8000, so a 32-bit subtraction compares two at once)
  for (int r = tid; r < m; r += T) {
    const int ij = IJ[r];
    const uint16_t* Ri = R + (ij >> 7) * ns;
    const uint16_t* Rj = R + (ij & 127) * ns;
    const uint32_t rr = (uint32_t)r * 0x10001u;
    int vs = -1;
    // a tree edge has none: such a v would join i and j below r
    for (int v0 = flag[r] == kTree ? n : 0; v0 < n; v0 += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(Ri + v0);
      const uint4 y = *reinterpret_cast<const uint4*>(Rj + v0);
      const uint32_t h[4] = {both_below(x.x, y.x, rr), both_below(x.y, y.y, rr),
                             both_below(x.z, y.z, rr), both_below(x.w, y.w, rr)};
      if (h[0] | h[1] | h[2] | h[3]) {
        const int q = h[0] ? 0 : h[1] ? 1 : h[2] ? 2 : 3;
        vs = v0 + 2 * q + ((h[q] & 0x8000u) ? 0 : 1);
        break;
      }
    }
    const bool positive = r < mcx && flag[r] != kTree;
    const bool apparent = positive && vs >= 0;
    a.vstar_r[(size_t)b * m + r] = vs;
    a.apparent_r[(size_t)b * m + r] = apparent ? 1 : 0;
    if (positive && !apparent) flag[r] = kCreator;
  }
  PROF_TICK(kProfSieve)
  __syncthreads();

  // 6. H0 deaths: the tree edges' weights in rank order, then +inf
  const int n1 = n - 1;
  const int ntree = scratch[2 * kMaxWarps + 2];
  float* h0 = a.h0_deaths + (size_t)b * n1;
  uint8_t* h0m = a.h0_mask + (size_t)b * n1;
  if (tid < ntree) {
    const int e = tree_r[tid];
    int pos = 0;
    for (int t = 0; t < ntree; ++t) pos += tree_r[t] < e ? 1 : 0;
    const float w = tree_w[tid];
    h0[pos] = w;
    h0m[pos] = (isfinite(w) && w > 0.0f) ? 1 : 0;
  }
  for (int k = ntree + tid; k < n1; k += T) {
    h0[k] = INFINITY;
    h0m[k] = 0;
  }
  PROF_TICK(kProfH0)

  // 7. the non-apparent creators in descending rank, padded with -1
  int* na = a.na_list + (size_t)b * a.na_eff;
  int n_na = 0;
  for (int base = 0; base < mcx; base += T) {
    const int r = mcx - 1 - (base + tid);
    const bool f = r >= 0 && flag[r] == kCreator;
    int tot;
    const int pos = n_na + block_scan(f, scratch, tot);
    if (f && pos < a.na_eff) na[pos] = r;
    n_na += tot;
  }
  for (int k = n_na + tid; k < a.na_eff; k += T) na[k] = -1;
  PROF_TICK(kProfCreators)
  if (tid == 0) {
    a.m_cx[b] = mcx;
    a.n_tree[b] = ntree;
    a.overflow_na[b] = n_na > a.na_max ? 1 : 0;
#ifdef H1_PHASE1_PROFILE
    prof_[kProfTotal] = clock64() - t_begin_;
    for (int k = 0; k < kProfSlots; ++k) a.prof[(size_t)b * kProfSlots + k] = prof_[k];
    a.stamps[3 * (size_t)b] = (long long)stamp0_;
    a.stamps[3 * (size_t)b + 1] = (long long)globaltimer_ns();
    a.stamps[3 * (size_t)b + 2] = (long long)smid();
#endif
  }
}

cudaError_t set_smem(int smem) {
  return cudaFuncSetAttribute(h1_phase1_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// The layout for n-point windows in blocks of `threads` threads: out[0..5) =
// threads a block, the dynamic shared bytes the kernel lays out, registers
// and local (spill) bytes a thread, blocks an SM by the card's occupancy
// calculator.  Returns a cudaError_t.
extern "C" int h1_phase1_layout(int n, int threads, int* out) {
  const int smem = layout(n).total;
  cudaError_t e = set_smem(smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, h1_phase1_kernel);
  if (e != cudaSuccess) return (int)e;
  int nb = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, h1_phase1_kernel, threads,
                                                    (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = threads;
  out[1] = smem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = nb;
  return 0;
}

extern "C" int h1_phase1_launch(const void* dm, const void* n_pts, int n_pts_64, int B,
                                int n, float thresh, int na_eff, int na_max, int threads,
                                void* ew_r, void* rank_mat, void* iu_r, void* ju_r,
                                void* vstar_r, void* apparent_r, void* na_list,
                                void* overflow_na, void* h0_deaths, void* h0_mask,
                                void* n_tree, void* m_cx, void* prof, void* stamps,
                                void* stream) {
  if (n < 2 || n > kMaxN || threads < n || (threads & 31) || threads > 512 ||
      threads * kSeg < n * (n - 1) / 2 || na_eff < 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Args a{(const float*)dm, n_pts, n_pts_64, thresh, n, n * (n - 1) / 2, na_eff,
               na_max, (float*)ew_r, (int*)rank_mat, (int*)iu_r, (int*)ju_r,
               (int*)vstar_r, (uint8_t*)apparent_r, (int*)na_list,
               (uint8_t*)overflow_na, (float*)h0_deaths, (uint8_t*)h0_mask,
               (int*)n_tree, (int*)m_cx, (long long*)prof, (long long*)stamps};
  const int smem = layout(n).total;
  const cudaError_t e = set_smem(smem);
  if (e != cudaSuccess) return (int)e;
  h1_phase1_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
