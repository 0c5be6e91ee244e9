// H1 phase 1 for the H100 (sm_90a): per window, the enclosing-radius cut,
// the rank matrix, the spanning forest and H0 deaths, the apparent-pair
// sieve and the list of non-apparent creators, one block per window.
//
// Replaces the XLA prologue of tda_eeg_audio_tpu/ops/homology_h1.py::_phase1
// (with :_boruvka_forest), which runs outside the Pallas body of
// h1_diagrams_pallas.  The port's plain version is
// tda_eeg_audio_tpu_torch/ops/homology_h1.py::_phase1; this kernel returns
// its outputs bit for bit.  The stable edge sort stays in front of the
// kernel (torch.sort, as XLA's sort is in front of the Pallas body): the
// kernel takes the sorted weights ew_r and their static indices e_sort.
//
// What bounds it: the sieve.  Edge r = (i, j) is apparent when some vertex v
// has rank[i][v] < r and rank[j][v] < r; its partner is the first such v.
// The plain version materialises (B, m, n) gathers for that (4.5 GB at
// n = 124 for 1,200 clouds); here the scan is two shared-memory reads and
// two compares per (edge, v), stopping at the first hit, and the bytes are
// dm in and the outputs out, once.  The design:
//  * the window's rank matrix lives in shared memory as uint16 (n <= 128
//    gives m <= 8,128 edges, so "absent" maps to 0xFFFF), with the edge
//    endpoints in rank order as uint8: ~54 KB at n = 124, 4 blocks an SM;
//  * the spanning forest over the in-complex ranks is unique (the ranks are
//    a strict total order), so any minimum-spanning-forest algorithm gives
//    the plain version's bits: Boruvka rounds in shared memory (a warp per
//    vertex row finds its cheapest outgoing edge, an atomicMin per
//    component, roots hook across it, a mutual pair keeps the smaller root,
//    every vertex chases its root), marking tree edges by rank;
//  * the sieve takes one thread per edge in rank order, so vstar_r and
//    apparent_r are written coalesced;
//  * H0 deaths (tree edges ascending) and the creator list (descending) are
//    compacted with block prefix sums.
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
constexpr uint16_t kAbsent = 0xFFFF;   // the same in the shared uint16 copy
constexpr uint8_t kTree = 1;           // edge flags, by rank
constexpr uint8_t kCreator = 2;        // positive and not apparent
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

struct Layout {
  int rank, iu, ju, flag, comp, parent, cbest, scratch, total;
};

// Dynamic shared memory of an n-point window, in bytes (phase1_cuda.py's
// kernel_plan reckons the same and checks it at load).
__host__ __device__ inline Layout layout(int n) {
  const int m = n * (n - 1) / 2;
  Layout L;
  int o = 0;
  L.rank = o;    o += up16(2 * n * n);           // uint16 rank matrix
  L.iu = o;      o += up16(m);                   // uint8 endpoints by rank
  L.ju = o;      o += up16(m);
  L.flag = o;    o += up16(m);                   // kTree | kCreator by rank
  L.comp = o;    o += up16(4 * n);               // forest: root of each vertex
  L.parent = o;  o += up16(4 * n);               //   hook of each root
  L.cbest = o;   o += up16(4 * n);               //   cheapest outgoing rank
  L.scratch = o; o += up16(4 * (2 * kMaxWarps + 4));
  L.total = o;
  return L;
}

struct Args {
  const float* dm;        // (B, n, n)
  const float* ew_r;      // (B, m) sorted weights
  const int64_t* e_sort;  // (B, m) static edge index of each rank
  const int* n_pts;       // (B,) or null: all points valid
  float thresh;
  int n, m, na_eff, na_max;
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
};

// Static upper-triangle index s -> (i, j), i < j, s = i*n - i*(i+1)/2 + j-i-1.
__device__ inline void static_ij(int s, int n, int& i, int& j) {
  const float b = 2.0f * n - 1.0f;
  int r = (int)((b - sqrtf(fmaxf(b * b - 8.0f * s, 0.0f))) * 0.5f);
  r = max(0, min(r, n - 2));
  while (r > 0 && r * (2 * n - r - 1) / 2 > s) --r;
  while (r < n - 2 && (r + 1) * (2 * n - r - 2) / 2 <= s) ++r;
  i = r;
  j = s - r * (2 * n - r - 1) / 2 + r + 1;
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

__global__ void h1_phase1_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, m = a.m;
  const Layout L = layout(n);
  uint16_t* R = reinterpret_cast<uint16_t*>(smem + L.rank);
  uint8_t* iu = smem + L.iu;
  uint8_t* ju = smem + L.ju;
  uint8_t* flag = smem + L.flag;
  int* comp = reinterpret_cast<int*>(smem + L.comp);
  int* parent = reinterpret_cast<int*>(smem + L.parent);
  int* cbest = reinterpret_cast<int*>(smem + L.cbest);
  int* scratch = reinterpret_cast<int*>(smem + L.scratch);

  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const float* D = a.dm + (size_t)b * n * n;
  const float* W = a.ew_r + (size_t)b * m;
  const int64_t* S = a.e_sort + (size_t)b * m;

  // 1. ranks: the rank matrix and the endpoints in rank order
  for (int r = tid; r < m; r += T) {
    int i, j;
    static_ij((int)S[r], n, i, j);
    R[i * n + j] = R[j * n + i] = (uint16_t)r;
    iu[r] = (uint8_t)i;
    ju[r] = (uint8_t)j;
    flag[r] = 0;
  }
  if (tid < n) {
    R[tid * n + tid] = kAbsent;
    comp[tid] = tid;
    parent[tid] = tid;
  }

  // 2. enclosing radius over valid points: r_enc = min_i max_j dm[i][j],
  // NaN-propagating like torch's amax / amin; a warp per row
  const int np = a.n_pts ? a.n_pts[b] : n;
  float rmin = INFINITY;
  int rnan = 0;
  for (int i = warp; i < n; i += nw) {
    if (i >= np) continue;
    float mx = -INFINITY;
    int isn = 0;
    for (int j = lane; j < n; j += 32) {
      if (j >= np) continue;
      const float x = D[i * n + j];
      isn |= isnan(x) ? 1 : 0;
      mx = fmaxf(mx, x);
    }
    for (int o = 16; o; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      isn |= __shfl_xor_sync(kFull, isn, o);
    }
    if (isn) rnan = 1;
    else rmin = fminf(rmin, mx);
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
    // eff = min(thresh, r_enc) where r_enc is finite, else thresh
    const float eff = (!any_nan && isfinite(r_enc)) ? fminf(a.thresh, r_enc) : a.thresh;
    scratch[2 * kMaxWarps] = __float_as_int(eff);
  }
  __syncthreads();
  const float eff = __int_as_float(scratch[2 * kMaxWarps]);

  // in-complex edges: ranks below m_cx = #{r : ew_r[r] <= eff}
  int mcx = 0;
  for (int base = 0; base < m; base += T) {
    const int r = base + tid;
    mcx += __syncthreads_count(r < m && W[r] <= eff);
  }

  // the rank matrix and the endpoints out
  int* RM = a.rank_mat + (size_t)b * n * n;
  for (int f = tid; f < n * n; f += T) {
    const int v = R[f];
    RM[f] = v == kAbsent ? kBig : v;
  }
  for (int r = tid; r < m; r += T) {
    a.iu_r[(size_t)b * m + r] = iu[r];
    a.ju_r[(size_t)b * m + r] = ju[r];
  }

  // 3. spanning forest of the in-complex edges, Boruvka rounds
  for (;;) {
    if (tid < n) cbest[tid] = kBig;
    __syncthreads();
    for (int v = warp; v < n; v += nw) {
      const int cv = comp[v];
      int best = kBig;
      for (int u = lane; u < n; u += 32) {
        const int k = R[v * n + u];
        if (k < mcx && comp[u] != cv) best = min(best, k);
      }
      for (int o = 16; o; o >>= 1) best = min(best, __shfl_xor_sync(kFull, best, o));
      if (lane == 0 && best < kBig) atomicMin(&cbest[cv], best);
    }
    __syncthreads();
    // each root with an outgoing edge hooks onto the component across its
    // cheapest one, which is a tree edge (two roots may share it)
    bool hooked = false;
    if (tid < n && comp[tid] == tid && cbest[tid] < kBig) {
      const int e = cbest[tid];
      flag[e] = kTree;
      const int ci = comp[iu[e]], cj = comp[ju[e]];
      parent[tid] = ci == tid ? cj : ci;
      hooked = true;
    }
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
      comp[tid] = x;
    }
    __syncthreads();
  }

  // 4. the sieve, one thread per edge in rank order: the first v with both
  // cross ranks below r
  for (int r = tid; r < m; r += T) {
    const uint16_t* Ri = R + iu[r] * n;
    const uint16_t* Rj = R + ju[r] * n;
    int vs = -1;
    for (int v = 0; v < n; ++v) {
      if (Ri[v] < r && Rj[v] < r) {
        vs = v;
        break;
      }
    }
    const bool positive = r < mcx && flag[r] != kTree;
    const bool apparent = positive && vs >= 0;
    a.vstar_r[(size_t)b * m + r] = vs;
    a.apparent_r[(size_t)b * m + r] = apparent ? 1 : 0;
    if (positive && !apparent) flag[r] = kCreator;
  }
  __syncthreads();

  // 5. H0 deaths: the tree edges' weights in rank order, then +inf
  const int n1 = n - 1;
  float* h0 = a.h0_deaths + (size_t)b * n1;
  uint8_t* h0m = a.h0_mask + (size_t)b * n1;
  int ntree = 0;
  for (int base = 0; base < mcx; base += T) {
    const int r = base + tid;
    const bool f = r < mcx && flag[r] == kTree;
    int tot;
    const int pos = ntree + block_scan(f, scratch, tot);
    if (f && pos < n1) {
      const float w = W[r];
      h0[pos] = w;
      h0m[pos] = (isfinite(w) && w > 0.0f) ? 1 : 0;
    }
    ntree += tot;
  }
  for (int k = ntree + tid; k < n1; k += T) {
    h0[k] = INFINITY;
    h0m[k] = 0;
  }

  // 6. the non-apparent creators in descending rank, padded with -1
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
  if (tid == 0) {
    a.m_cx[b] = mcx;
    a.n_tree[b] = ntree;
    a.overflow_na[b] = n_na > a.na_max ? 1 : 0;
  }
}

cudaError_t set_smem(int smem) {
  return cudaFuncSetAttribute(h1_phase1_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// Dynamic shared-memory bytes the kernel lays out for n-point windows.
extern "C" int h1_phase1_smem_bytes(int n) { return layout(n).total; }

// Blocks of `threads` threads one SM holds at n (< 0: error).
extern "C" int h1_phase1_blocks_per_sm(int n, int threads) {
  const int smem = layout(n).total;
  int nb = 0;
  if (set_smem(smem) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, h1_phase1_kernel, threads,
                                                    (size_t)smem) != cudaSuccess)
    return -1;
  return nb;
}

extern "C" int h1_phase1_launch(const void* dm, const void* ew_r, const void* e_sort,
                                const void* n_pts, int B, int n, float thresh,
                                int na_eff, int na_max, int threads, void* rank_mat,
                                void* iu_r, void* ju_r, void* vstar_r, void* apparent_r,
                                void* na_list, void* overflow_na, void* h0_deaths,
                                void* h0_mask, void* n_tree, void* m_cx, void* stream) {
  if (n < 2 || n > kMaxN || threads < n || (threads & 31) ||
      threads > 32 * kMaxWarps || na_eff < 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Args a{(const float*)dm, (const float*)ew_r, (const int64_t*)e_sort,
               (const int*)n_pts, thresh, n, n * (n - 1) / 2, na_eff, na_max,
               (int*)rank_mat, (int*)iu_r, (int*)ju_r, (int*)vstar_r,
               (uint8_t*)apparent_r, (int*)na_list, (uint8_t*)overflow_na,
               (float*)h0_deaths, (uint8_t*)h0_mask, (int*)n_tree, (int*)m_cx};
  const int smem = layout(n).total;
  const cudaError_t e = set_smem(smem);
  if (e != cudaSuccess) return (int)e;
  h1_phase1_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
