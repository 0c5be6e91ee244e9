// H1 persistent-cohomology reduction, one thread block per window (sm_90a).
//
// Replaces tda_eeg_audio_tpu/ops/homology_pallas.py::_reduce_kernel (the
// Pallas TPU kernel launched by h1_diagrams_pallas).  Same pairing, same
// per-window step budget; the key layout is dense: triangle (g, v) ->
// key g*n + v, bit (key & 31) of word (key >> 5), so the lowest set bit of
// the column is its lexicographic (g, v) pivot.
//
// What bounds it: a per-step dependent chain (pivot min-reduce -> claim
// lookup -> XOR -> next step), i.e. latency, not bytes or arithmetic.  The
// design keeps many windows in flight instead of interleaving chains inside
// one window: one block per window over the grid, the working column in
// shared memory (118 KB at n = 124, 6.4 KB at n = 47), finished columns in
// a global-memory arena the caller allocates (L2-resident in practice).
// Two observations shorten each step: a column's pivot only increases, so
// the pivot scan, the XOR and the store start at the pivot's word; and no
// key reaches m_cx*n, so every loop stops at word ceil(m_cx*n / 32).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libh1_reduce.so h1_reduce.cu

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNa = 128;
constexpr int kEssential = -2;

__device__ __forceinline__ int block_min(int v, int* red) {
  v = __reduce_min_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int r = (lane < (kThreads >> 5)) ? red[lane] : INT_MAX;
    r = __reduce_min_sync(0xffffffffu, r);
    if (lane == 0) red[32] = r;
  }
  __syncthreads();
  return red[32];
}

// XOR the coboundary of the edge ranked ge into the column (threads v < n).
__device__ __forceinline__ void cobd_xor(unsigned* col, int ge,
                                         const int* __restrict__ rank_b,
                                         const int* __restrict__ iu_b,
                                         const int* __restrict__ ju_b,
                                         int n, int mcx) {
  const int v = threadIdx.x;
  if (v >= n) return;
  const int i = __ldg(iu_b + ge), j = __ldg(ju_b + ge);
  const int ri = __ldg(rank_b + i * n + v), rj = __ldg(rank_b + j * n + v);
  const int gm = max(ge, max(ri, rj));
  if (gm < mcx) {
    const int opp = (gm == ri) ? j : ((gm == rj) ? i : v);
    const int key = gm * n + opp;
    atomicXor(col + (key >> 5), 1u << (key & 31));
  }
}

__global__ void __launch_bounds__(kThreads)
h1_reduce_kernel(const int* __restrict__ rank_mat,  // (B, n, n), BIG on diag
                 const int* __restrict__ iu_r,      // (B, m) endpoints by rank
                 const int* __restrict__ ju_r,      // (B, m)
                 const int* __restrict__ app_v,     // (B, m) apparent vertex or -1
                 const int* __restrict__ na_list,   // (B, na) creators, -1 padded
                 const int* __restrict__ m_cx,      // (B,) in-complex edge count
                 unsigned* __restrict__ stored,     // (B, na, W) scratch arena
                 int* __restrict__ pair_key,        // (B, na) out
                 int* __restrict__ stepinfo,        // (B, 2) out: steps, overflow
                 int n, int m, int na, int W, int step_budget) {
  extern __shared__ unsigned col[];                 // W words
  __shared__ int red[33];
  __shared__ int s_pair[kMaxNa];
  __shared__ int s_slot;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int* rank_b = rank_mat + (size_t)b * n * n;
  const int* iu_b = iu_r + (size_t)b * m;
  const int* ju_b = ju_r + (size_t)b * m;
  const int* app_b = app_v + (size_t)b * m;
  const int* na_b = na_list + (size_t)b * na;
  unsigned* st_b = stored + (size_t)b * na * W;
  const int mcx = m_cx[b];
  const int hi = (int)(((long long)mcx * n + 31) >> 5);

  int n_na = 0;
  for (int s = 0; s < na; ++s) n_na += (__ldg(na_b + s) >= 0);
  for (int s = tid; s < na; s += kThreads) s_pair[s] = -1;
  for (int w = tid; w < hi; w += kThreads) col[w] = 0u;
  __syncthreads();

  int cur = 0, steps = 0, lo = 0;
  bool active = n_na > 0;
  if (active) cobd_xor(col, __ldg(na_b), rank_b, iu_b, ju_b, n, mcx);
  __syncthreads();

  while (active && steps < step_budget) {
    // pivot: smallest set key at or after word lo (each thread's words
    // ascend, so its first nonzero word holds its smallest key)
    int local = INT_MAX;
    for (int w = lo + tid; w < hi; w += kThreads) {
      const unsigned x = col[w];
      if (x) { local = (w << 5) + __ffs(x) - 1; break; }
    }
    const int p = block_min(local, red);
    const bool nonzero = p != INT_MAX;
    const int g = nonzero ? p / n : 0;
    const bool own_app = nonzero && __ldg(app_b + g) == p - g * n;

    // claim: the finished column (slot < cur) whose pivot is p, if any
    if (tid == 0) s_slot = INT_MAX;
    __syncthreads();
    if (nonzero && !own_app)
      for (int s = tid; s < cur; s += kThreads)
        if (s_pair[s] == p) atomicMin(&s_slot, s);
    __syncthreads();
    const int slot = s_slot;
    ++steps;

    if (own_app) {
      cobd_xor(col, g, rank_b, iu_b, ju_b, n, mcx);
      lo = p >> 5;
    } else if (slot != INT_MAX) {
      const unsigned* src = st_b + (size_t)slot * W;
      for (int w = (p >> 5) + tid; w < hi; w += kThreads) col[w] ^= src[w];
      lo = p >> 5;
    } else {
      // finish: record the pair, persist and clear the column, load the
      // next creator's coboundary
      if (tid == 0) s_pair[cur] = nonzero ? p : kEssential;
      if (nonzero) {
        unsigned* dst = st_b + (size_t)cur * W;
        for (int w = (p >> 5) + tid; w < hi; w += kThreads) {
          dst[w] = col[w];
          col[w] = 0u;
        }
      }
      ++cur;
      active = cur < n_na;
      lo = 0;
      __syncthreads();
      if (active) cobd_xor(col, __ldg(na_b + cur), rank_b, iu_b, ju_b, n, mcx);
    }
    __syncthreads();
  }

  for (int s = tid; s < na; s += kThreads) pair_key[(size_t)b * na + s] = s_pair[s];
  if (tid == 0) {
    stepinfo[2 * b] = steps;
    stepinfo[2 * b + 1] = active ? 1 : 0;
  }
}

}  // namespace

extern "C" int h1_reduce_launch(const void* rank_mat, const void* iu_r,
                                const void* ju_r, const void* app_v,
                                const void* na_list, const void* m_cx,
                                void* stored, void* pair_key, void* stepinfo,
                                int B, int n, int m, int na, int W,
                                int step_budget, void* stream) {
  if (na > kMaxNa || n > kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)W * sizeof(unsigned);
  cudaError_t e = cudaFuncSetAttribute(
      h1_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  h1_reduce_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)rank_mat, (const int*)iu_r, (const int*)ju_r,
      (const int*)app_v, (const int*)na_list, (const int*)m_cx,
      (unsigned*)stored, (int*)pair_key, (int*)stepinfo,
      n, m, na, W, step_budget);
  return (int)cudaGetLastError();
}
