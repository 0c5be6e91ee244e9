// H1 persistent-cohomology reduction for the H100 (sm_90a): persistent
// blocks, one window at a time per block, everything a step reads in shared
// memory.
//
// Replaces tda_eeg_audio_tpu/ops/homology_pallas.py::_reduce_kernel (the
// Pallas TPU kernel launched by h1_diagrams_pallas).  Same pairing, same
// per-window step budget; the key layout is dense: triangle (g, v) ->
// key g*n + v, bit (key & 31) of word (key >> 5), so the lowest set bit of
// the column is its lexicographic (g, v) pivot.
//
// What bounds it: a per-step dependent chain (pivot -> apparent/claim
// lookup -> XOR -> next step), i.e. latency, not bytes or arithmetic
// (measured on an H100 80GB HBM3 with -DH1_PROFILE: ~1,400 clock ticks per
// step at n = 124, a quarter of them the pivot's four dependent shared-memory
// reads).  The design keeps many windows in flight and makes each link of
// the chain a shared-memory access:
//  * one launch per call: each block takes the next window from a device
//    counter, in window order, and reuses its slot of the stored-column
//    arena, so the arena is sized by the blocks that can be resident, not by
//    the windows;
//  * a window's operands are packed into shared memory once (rank matrix as
//    uint16, edge endpoints and apparent vertices as uint8), next to the
//    working column (118 KB at n = 124, 6.4 KB at n = 47);
//  * a two-level summary of the column (l1: one bit per column word, l2: one
//    bit per l1 word) is kept exact by every XOR, so the pivot is read off
//    it by every warp for itself: no block-wide reduction, two barriers per
//    step (three when a column finishes);
//  * finished columns are sparse (measured: 294 nonzero words in an extent
//    of 19,983 at n = 124, 90 in 1,096 at n = 47), so each is stored as a
//    compact list of (word index, word) pairs, written from the summary and
//    XORed back entry by entry: neither pass walks the column's extent.  A
//    window's lists are packed one after the other in its block's slot, a
//    few tens of KB that stay in the L2 cache; the slot's size, na * Wp
//    entries, is the most they could ever need;
//  * small clouds (n <= 64) run the same kernel with 64-thread blocks, 13
//    windows resident per SM at n = 47.
//
// With -DH1_PROFILE (a build of its own, never loaded by the port's entry
// points) thread 0 of each block sums clock64() ticks per part of the step,
// and each window records its start, end (globaltimer, ns) and SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libh1_reduce.so h1_reduce.cu

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxNa = 128;
constexpr int kMaxN = 128;          // m*n <= 2^20 keys: l1 <= 1024 words, l2 <= 32
constexpr int kEssential = -2;
constexpr unsigned kFull = 0xffffffffu;

// profile slots (int64 per window): ticks of thread 0, then counters
enum { kProfSetup, kProfPivot, kProfReduce, kProfClaim, kProfCobd, kProfStoredXor,
       kProfFinish, kProfStepBarrier, kProfTotal, kProfStepsApp, kProfStepsStored,
       kProfStepsFinish, kProfXorWords, kProfStoreWords, kProfExtentWords,
       kProfNnzWords, kProfPrepare, kProfFinishScan, kProfFinishMove,
       kProfFinishBarrier, kProfSlots };

#ifdef H1_PROFILE
#define PROF_DECL long long prof_[kProfSlots] = {0}; long long t_ = clock64(); \
  const long long t_begin_ = t_;
#define PROF_TICK(slot) { const long long c_ = clock64(); prof_[slot] += c_ - t_; t_ = c_; }
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

__host__ __device__ constexpr int up16(int x) { return (x + 15) & ~15; }

// Byte offsets of the block's dynamic shared memory; the wrapper's
// kernel_plan computes the same total (h1_reduce_layout reports it).
struct Layout {
  int col, l1, l2, rank, iu, ju, app, na, pair, off, cnt, misc, total;
};

__host__ __device__ inline Layout layout(int n, int m, int Wp) {
  Layout L;
  int o = 0;
  L.col = o;  o += Wp * 4;                // working column, Wp % 32 == 0
  L.l1 = o;   o += up16((Wp >> 5) * 4);   // bit w: col[w] != 0
  L.l2 = o;   o += 32 * 4;                // bit k: l1[k] != 0
  L.rank = o; o += up16(n * n * 2);       // uint16, 65535 on the diagonal
  L.iu = o;   o += up16(m);               // uint8 endpoints by rank
  L.ju = o;   o += up16(m);
  L.app = o;  o += up16(m);               // uint8 apparent vertex, 255 = none
  L.na = o;   o += kMaxNa * 4;            // creators, -1 padded
  L.pair = o; o += kMaxNa * 4;            // pivots of the finished columns
  L.off = o;  o += kMaxNa * 4;            // where their entries start in the slot
  L.cnt = o;  o += kMaxNa * 4;            // their entry counts
  L.misc = o; o += 16;                    // [0] window taken, [1] entries appended,
                                          // [2] entries of the window so far
  L.total = o;
  return L;
}

struct Args {
  const int* rank_mat;   // (B, n, n), BIG on the diagonal
  const int* iu_r;       // (B, m) endpoints by rank
  const int* ju_r;       // (B, m)
  const int* app_v;      // (B, m) apparent vertex or -1
  const int* na_list;    // (B, na) creators, -1 padded
  const int* m_cx;       // (B,) in-complex edge count
  int* counter;          // zero-filled by the caller
  int2* arena;           // (grid, na * Wp) (word index, word) entries, a slot per block
  int* pair_key;         // (B, na) out
  int* stepinfo;         // (B, 2) out: steps, overflow
  long long* prof;       // (B, kProfSlots), profile build only
  long long* stamps;     // (B, 3), profile build only
  int B, n, m, na, Wp, step_budget;
  unsigned inv_n;        // ceil(2^32 / n): key / n == __umulhi(key, inv_n) for keys < 2^20
};

struct Smem {
  unsigned* col;
  unsigned* l1;
  unsigned* l2;
  const uint16_t* rank;
  const uint8_t* iu;
  const uint8_t* ju;
  const uint8_t* app;
};

// Pack cnt int32 values into a narrower shared array, saturating at cap
// (so -1 and BIG both become cap): 16-byte loads over the aligned body.
template <int T, typename D>
__device__ __forceinline__ void load_pack(D* dst, const int* __restrict__ src,
                                          int cnt, unsigned cap, int tid) {
  const int head = min(cnt, (int)(((16 - ((uintptr_t)src & 15)) & 15) >> 2));
  if (tid < head) dst[tid] = (D)min((unsigned)__ldg(src + tid), cap);
  const int4* s4 = (const int4*)(src + head);
  const int n4 = (cnt - head) >> 2;
#pragma unroll 4
  for (int i = tid; i < n4; i += T) {
    const int4 x = __ldg(s4 + i);
    D* d = dst + head + 4 * i;
    d[0] = (D)min((unsigned)x.x, cap);
    d[1] = (D)min((unsigned)x.y, cap);
    d[2] = (D)min((unsigned)x.z, cap);
    d[3] = (D)min((unsigned)x.w, cap);
  }
  const int tail = head + 4 * n4 + tid;
  if (tail < cnt) dst[tail] = (D)min((unsigned)__ldg(src + tail), cap);
}

// l1 bit of column word w changed: toggle it, and the l2 bit above it when
// the l1 word went zero <-> nonzero.  Toggles commute, so concurrent
// updates of one summary word need no order.
__device__ __forceinline__ void toggle_summary(const Smem& s, int w) {
  const unsigned b1 = 1u << (w & 31);
  const unsigned o1 = atomicXor(s.l1 + (w >> 5), b1);
  if (o1 == 0u || o1 == b1) atomicXor(s.l2 + (w >> 10), 1u << ((w >> 5) & 31));
}

// Smallest set key of the column, INT_MAX if it is zero (whole warp).
// klo: an l1 word with no set bit below it (the previous pivot's, since a
// column's pivot only increases); when it is nonzero the l2 level is skipped.
// Both loads start together.  Leaves the pivot's l1 word in klo.
__device__ __forceinline__ int find_pivot(const Smem& s, int lane, int& klo) {
  unsigned z1 = s.l1[klo];
  const unsigned z2 = s.l2[lane];
  if (z1 == 0u) {
    const unsigned bal = __ballot_sync(kFull, z2 != 0u);
    if (!bal) return INT_MAX;
    const int a = __ffs(bal) - 1;
    klo = (a << 5) + __ffs(__shfl_sync(kFull, z2, a)) - 1;
    z1 = s.l1[klo];
  }
  const int w = (klo << 5) + __ffs(z1) - 1;
  return (w << 5) + __ffs(s.col[w]) - 1;
}

// Key of the cofacet of the edge ranked ge = (i, j) with vertex v, -1 if it
// is not in the complex.  Reads the window's tables only, never the column.
__device__ __forceinline__ int cobd_key(const Smem& s, int ge, int i, int j, int v,
                                        int n, int mcx) {
  const int ri = s.rank[i * n + v], rj = s.rank[j * n + v];
  const int gm = max(ge, max(ri, rj));
  if (gm >= mcx) return -1;
  return gm * n + ((gm == ri) ? j : ((gm == rj) ? i : v));
}

__device__ __forceinline__ void flip_key(const Smem& s, int key) {
  if (key < 0) return;
  const int w = key >> 5;
  const unsigned bit = 1u << (key & 31);
  const unsigned old = atomicXor(s.col + w, bit);
  if (old == 0u || old == bit) toggle_summary(s, w);
}

// The coboundary of one edge, XORed into the column in two halves: the keys
// are made before the barrier that frees the column (thread tid's first
// vertex; the tables are read-only), the flips after it.
template <int T>
struct Cobd {
  int ge, i, j, key0;
  __device__ __forceinline__ void prepare(const Smem& s, int edge, int n, int mcx,
                                          int tid) {
    ge = edge;
    i = s.iu[ge];
    j = s.ju[ge];
    key0 = tid < n ? cobd_key(s, ge, i, j, tid, n, mcx) : -1;
  }
  __device__ __forceinline__ void flip(const Smem& s, int n, int mcx, int tid) const {
    flip_key(s, key0);
    for (int v = tid + T; v < n; v += T) flip_key(s, cobd_key(s, ge, i, j, v, n, mcx));
  }
};

template <int T>
__global__ void __launch_bounds__(T) h1_reduce_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, m = a.m, na = a.na, Wp = a.Wp;
  const Layout L = layout(n, m, Wp);
  unsigned* col = (unsigned*)(smem + L.col);
  unsigned* l1 = (unsigned*)(smem + L.l1);
  unsigned* l2 = (unsigned*)(smem + L.l2);
  uint16_t* rank16 = (uint16_t*)(smem + L.rank);
  uint8_t* iu8 = smem + L.iu;
  uint8_t* ju8 = smem + L.ju;
  uint8_t* app8 = smem + L.app;
  int* s_na = (int*)(smem + L.na);
  int* s_pair = (int*)(smem + L.pair);
  int* s_off = (int*)(smem + L.off);
  int* s_cnt = (int*)(smem + L.cnt);
  int* misc = (int*)(smem + L.misc);
  const Smem s{col, l1, l2, rank16, iu8, ju8, app8};

  const int tid = threadIdx.x, lane = tid & 31;
  const int nl1 = Wp >> 5;
  int2* slot = a.arena + (size_t)blockIdx.x * na * Wp;

  for (;;) {
    if (tid == 0) misc[0] = atomicAdd(a.counter, 1);
    __syncthreads();
    const int b = misc[0];
    if (b >= a.B) break;
#ifdef H1_PROFILE
    const unsigned long long stamp0 = globaltimer_ns();
#endif
    PROF_DECL

    // the window's operands into shared memory; column and summary to zero
    const int mcx = __ldg(a.m_cx + b);
    load_pack<T>(rank16, a.rank_mat + (size_t)b * n * n, n * n, 65535u, tid);
    load_pack<T>(iu8, a.iu_r + (size_t)b * m, mcx, 255u, tid);
    load_pack<T>(ju8, a.ju_r + (size_t)b * m, mcx, 255u, tid);
    load_pack<T>(app8, a.app_v + (size_t)b * m, mcx, 255u, tid);
    for (int k = tid; k < kMaxNa; k += T) {
      s_na[k] = k < na ? __ldg(a.na_list + (size_t)b * na + k) : -1;
      s_pair[k] = -1;
    }
    for (int w = tid; w < (Wp >> 2); w += T) ((uint4*)col)[w] = make_uint4(0, 0, 0, 0);
    for (int k = tid; k < nl1; k += T) l1[k] = 0u;
    if (tid < 32) l2[tid] = 0u;
    if (tid == 0) misc[1] = misc[2] = 0;
    __syncthreads();

    int n_na = 0;
    for (int k = lane; k < kMaxNa; k += 32) n_na += s_na[k] >= 0;
    n_na = __reduce_add_sync(kFull, n_na);

    int cur = 0, steps = 0, klo = 0;
    bool active = n_na > 0;
    Cobd<T> cob;
    if (active) {
      cob.prepare(s, s_na[0], n, mcx, tid);
      cob.flip(s, n, mcx, tid);
    }
    __syncthreads();
    PROF_TICK(kProfSetup)

    while (active && steps < a.step_budget) {
      // every warp finds the pivot and what claims it from the same shared
      // state, so the outcome is uniform over the block
      const int p = find_pivot(s, lane, klo);
      const bool nonzero = p != INT_MAX;
      PROF_TICK(kProfPivot)
      const int g = nonzero ? (int)__umulhi((unsigned)p, a.inv_n) : 0;
      const bool own_app = nonzero && app8[g] == p - g * n;
      if (nonzero) cob.prepare(s, g, n, mcx, tid);    // used if own_app
      PROF_TICK(kProfPrepare)

      // claim: the finished column (entry < cur) whose pivot is p, if any;
      // pivots of finished columns are distinct
      int from = -1;
      if (nonzero && !own_app) {
        unsigned hit = 0u;
#pragma unroll
        for (int k = 0; k < kMaxNa / 32; ++k) {
          const int e = lane + 32 * k;
          hit |= (e < cur && s_pair[e] == p) ? (1u << k) : 0u;
        }
        const unsigned bal = __ballot_sync(kFull, hit != 0u);
        if (bal) {
          const int src = __ffs(bal) - 1;
          from = src + 32 * (__ffs(__shfl_sync(kFull, hit, src)) - 1);
        }
      }
      PROF_TICK(kProfClaim)
      __syncthreads();          // all warps have read the column and summary
      PROF_TICK(kProfReduce)
      ++steps;

      if (own_app) {
        cob.flip(s, n, mcx, tid);
        PROF_TICK(kProfCobd)
        PROF_ADD(kProfStepsApp, 1)
      } else if (from >= 0) {
        const int cnt = s_cnt[from];
        const int2* src = slot + s_off[from];
#pragma unroll 4
        for (int e = tid; e < cnt; e += T) {
          const int2 x = src[e];
          const unsigned old = col[x.x];
          const unsigned nw = old ^ (unsigned)x.y;
          col[x.x] = nw;
          if ((old == 0u) != (nw == 0u)) toggle_summary(s, x.x);
        }
        PROF_TICK(kProfStoredXor)
        PROF_ADD(kProfStepsStored, 1)
        PROF_ADD(kProfXorWords, cnt)
      } else {
        // finish: record the pair, move the column's nonzero words (read
        // off the summary) into the arena, load the next creator
        if (tid == 0) s_pair[cur] = nonzero ? p : kEssential;
        ++cur;
        klo = 0;
        active = cur < n_na;
        if (active) cob.prepare(s, s_na[cur], n, mcx, tid);
        if (nonzero) {
          // each thread counts the entries of its l1 words, a warp scan and
          // one atomicAdd per warp place them, then it moves them
          int2* dst = slot + misc[2];
          const int k0 = (p >> 10) + tid;
          int c = 0;
          for (int k = k0; k < nl1; k += T) c += __popc(l1[k]);
          int incl = c;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += up;
          }
          int at = 0;
          if (lane == 31 && incl) at = atomicAdd(&misc[1], incl);
          at = __shfl_sync(kFull, at, 31) + incl - c;
          PROF_TICK(kProfFinishScan)
          if (c) {
            for (int k = k0; k < nl1; k += T) {
              unsigned z = l1[k];
              if (z) {
                l1[k] = 0u;
                do {
                  const int w = (k << 5) + __ffs(z) - 1;
                  z &= z - 1;
                  dst[at++] = make_int2(w, (int)col[w]);
                  col[w] = 0u;
                } while (z);
              }
            }
          }
          if (tid < 32) l2[tid] = 0u;
          PROF_TICK(kProfFinishMove)
          __syncthreads();
          PROF_TICK(kProfFinishBarrier)
          if (tid == 0) {
            s_off[cur - 1] = misc[2];
            s_cnt[cur - 1] = misc[1];
            misc[2] += misc[1];
            PROF_ADD(kProfStoreWords, misc[1])
            PROF_ADD(kProfNnzWords, misc[1])
            PROF_ADD(kProfExtentWords, (int)(((long long)mcx * n + 31) >> 5) - (p >> 5))
            misc[1] = 0;
          }
        }
        if (active) cob.flip(s, n, mcx, tid);
        PROF_TICK(kProfFinish)
        PROF_ADD(kProfStepsFinish, 1)
      }
      __syncthreads();
      PROF_TICK(kProfStepBarrier)
    }

    for (int k = tid; k < na; k += T) a.pair_key[(size_t)b * na + k] = s_pair[k];
    if (tid == 0) {
      a.stepinfo[2 * b] = steps;
      a.stepinfo[2 * b + 1] = active ? 1 : 0;
#ifdef H1_PROFILE
      prof_[kProfTotal] = clock64() - t_begin_;
      for (int k = 0; k < kProfSlots; ++k) a.prof[(size_t)b * kProfSlots + k] = prof_[k];
      a.stamps[3 * (size_t)b] = (long long)stamp0;
      a.stamps[3 * (size_t)b + 1] = (long long)globaltimer_ns();
      a.stamps[3 * (size_t)b + 2] = (long long)smid();
#endif
    }
  }
}

template <int T>
cudaError_t set_smem(int smem) {
  return cudaFuncSetAttribute(h1_reduce_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int T>
int report(int smem, int* out) {
  cudaError_t e = set_smem<T>(smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, h1_reduce_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  int nb = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, h1_reduce_kernel<T>, T,
                                                    (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = T;
  out[1] = smem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = nb;
  return 0;
}

template <int T>
int launch(const Args& a, int grid, int smem, cudaStream_t stream) {
  const cudaError_t e = set_smem<T>(smem);
  if (e != cudaSuccess) return (int)e;
  h1_reduce_kernel<T><<<grid, T, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The layout for (n, Wp) in blocks of `threads` (64 or 256) threads:
// out[0..5) = threads a block, the dynamic shared bytes the kernel lays out,
// registers and local (spill) bytes a thread, blocks an SM by the card's
// occupancy calculator.  Returns a cudaError_t.
extern "C" int h1_reduce_layout(int n, int Wp, int threads, int* out) {
  const int smem = layout(n, n * (n - 1) / 2, Wp).total;
  switch (threads) {
    case 64: return report<64>(smem, out);
    case 256: return report<256>(smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int h1_reduce_launch(const void* rank_mat, const void* iu_r,
                                const void* ju_r, const void* app_v,
                                const void* na_list, const void* m_cx,
                                void* counter, void* arena, void* pair_key,
                                void* stepinfo, void* prof, void* stamps, int B,
                                int n, int m, int na, int Wp, int step_budget,
                                int threads, int grid, void* stream) {
  if (na > kMaxNa || n > kMaxN || n < 2 || (Wp & 31) || Wp * 32 < m * n)
    return (int)cudaErrorInvalidValue;
  const Args a{(const int*)rank_mat, (const int*)iu_r, (const int*)ju_r,
               (const int*)app_v, (const int*)na_list, (const int*)m_cx,
               (int*)counter, (int2*)arena, (int*)pair_key, (int*)stepinfo,
               (long long*)prof, (long long*)stamps,
               B, n, m, na, Wp, step_budget, 0xffffffffu / (unsigned)n + 1u};
  const int smem = layout(n, m, Wp).total;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (threads) {
    case 64: return launch<64>(a, grid, smem, st);
    case 256: return launch<256>(a, grid, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
