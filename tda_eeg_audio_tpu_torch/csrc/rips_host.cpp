// Exact Vietoris–Rips persistence (H0 and H1) of small point clouds on the
// host CPU.  It recomputes the few windows whose reduction the CUDA kernel
// flagged as overflowed (creator arena, step budget or bar count exceeded):
// no arena and no budget here, every column is a growable sorted key list.
//
// Same filtration as the device path (ops/homology_h1.py), so the bars are
// the same multiset: edges in strict (weight, i, j) order; a triangle is
// keyed rank(longest edge)·n + opposite vertex; an edge is apparent when some
// vertex closes a triangle whose two other edges are both older, and is then
// paired with the first such triangle without any reduction; the remaining
// cycle-creating edges are reduced by persistent cohomology in descending
// rank, pivot = smallest key.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -o librips_host.so rips_host.cpp

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <limits>
#include <numeric>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using Column = std::vector<int32_t>;     // sorted triangle keys, ascending

struct Window {
  int n, m, m_cx;
  std::vector<float> weight;             // by rank
  std::vector<int> lo, hi;               // endpoints by rank, lo < hi
  std::vector<int> rank;                 // (n, n) edge ranks, diagonal unused
  std::vector<char> in_forest;
  std::vector<int> apparent;             // partner vertex, or -1

  Window(const float* dm, int n_, float thresh) : n(n_), m(n_ * (n_ - 1) / 2) {
    std::vector<int> a(m), b(m), order(m);
    std::vector<float> w(m);
    int e = 0;
    for (int i = 0; i < n; ++i)
      for (int j = i + 1; j < n; ++j, ++e) {
        a[e] = i; b[e] = j; w[e] = dm[i * n + j];
      }
    std::iota(order.begin(), order.end(), 0);
    // static order is (i, j) lexicographic, so a stable sort by weight is
    // the strict (weight, i, j) order
    std::stable_sort(order.begin(), order.end(),
                     [&](int x, int y) { return w[x] < w[y]; });
    weight.resize(m); lo.resize(m); hi.resize(m);
    rank.assign(n * n, std::numeric_limits<int>::max());
    for (int k = 0; k < m; ++k) {
      const int s = order[k];
      weight[k] = w[s]; lo[k] = a[s]; hi[k] = b[s];
      rank[a[s] * n + b[s]] = rank[b[s] * n + a[s]] = k;
    }
    m_cx = 0;
    while (m_cx < m && weight[m_cx] <= thresh) ++m_cx;
  }

  // spanning forest by Kruskal; returns the number of forest edges
  int forest() {
    std::vector<int> parent(n);
    std::iota(parent.begin(), parent.end(), 0);
    auto root = [&](int x) {
      while (parent[x] != x) x = parent[x] = parent[parent[x]];
      return x;
    };
    in_forest.assign(m, 0);
    int count = 0;
    for (int k = 0; k < m_cx; ++k) {
      const int ra = root(lo[k]), rb = root(hi[k]);
      if (ra != rb) { parent[ra] = rb; in_forest[k] = 1; ++count; }
    }
    return count;
  }

  void sieve() {
    apparent.assign(m_cx, -1);
    for (int k = 0; k < m_cx; ++k) {
      if (in_forest[k]) continue;
      const int* ra = &rank[lo[k] * n];
      const int* rb = &rank[hi[k] * n];
      for (int v = 0; v < n; ++v)
        if (ra[v] < k && rb[v] < k) { apparent[k] = v; break; }
    }
  }

  // coboundary of edge k inside the complex, as sorted keys
  void coboundary(int k, Column& out) const {
    out.clear();
    const int a = lo[k], b = hi[k];
    for (int v = 0; v < n; ++v) {
      if (v == a || v == b) continue;
      const int ka = rank[a * n + v], kb = rank[b * n + v];
      const int top = std::max(k, std::max(ka, kb));
      if (top >= m_cx) continue;
      const int opposite = top == ka ? b : (top == kb ? a : v);
      out.push_back(top * n + opposite);
    }
    std::sort(out.begin(), out.end());
  }
};

// a ^= b over sorted key lists (symmetric difference), through scratch
void add_into(Column& a, const Column& b, Column& scratch) {
  scratch.clear();
  std::set_symmetric_difference(a.begin(), a.end(), b.begin(), b.end(),
                                std::back_inserter(scratch));
  a.swap(scratch);
}

void persistence(const float* dm, int n, float thresh, int max_bars,
                 float* h1_b, float* h1_d, int* h1_count, int* h1_essential,
                 float* h0_d, int* h0_count, int* n_tree) {
  Window w(dm, n, thresh);
  *n_tree = w.forest();
  int n0 = 0;
  for (int k = 0; k < w.m_cx; ++k)
    if (w.in_forest[k] && w.weight[k] > 0.0f) h0_d[n0++] = w.weight[k];
  *h0_count = n0;
  w.sieve();

  std::unordered_map<int32_t, int> owner;     // pivot key → stored column
  std::vector<Column> stored;
  Column col, other, scratch;
  int bars = 0, essential = 0;
  for (int k = w.m_cx - 1; k >= 0; --k) {
    if (w.in_forest[k] || w.apparent[k] >= 0) continue;
    w.coboundary(k, col);
    float death = 0.0f;
    bool dies = false;
    while (!col.empty()) {
      const int32_t p = col.front();
      const int g = p / n, v = p % n;
      if (!w.in_forest[g] && w.apparent[g] == v) {
        w.coboundary(g, other);
        add_into(col, other, scratch);
        continue;
      }
      auto it = owner.find(p);
      if (it != owner.end()) {
        add_into(col, stored[it->second], scratch);
        continue;
      }
      owner.emplace(p, (int)stored.size());
      stored.push_back(col);
      death = w.weight[g];
      dies = true;
      break;
    }
    const float birth = w.weight[k];
    if (!dies) {
      ++essential;
      death = std::numeric_limits<float>::infinity();
    }
    if (death > birth) {
      if (bars < max_bars) { h1_b[bars] = birth; h1_d[bars] = death; }
      ++bars;
    }
  }
  *h1_count = bars;          // may exceed max_bars: the caller flags it
  *h1_essential = essential;
}

}  // namespace

extern "C" {

// dm: (n_windows, n, n) row-major float32.  h1_b/h1_d: (n_windows, max_bars);
// h1_count (n_windows,) counts every visible bar, written or not;
// h0_d: (n_windows, n − 1) positive forest-edge weights, ascending.
void rips_host_batch(const float* dm, int n_windows, int n, float thresh,
                     int max_bars, int n_threads, float* h1_b, float* h1_d,
                     int* h1_count, int* h1_essential, float* h0_d,
                     int* h0_count, int* n_tree) {
  std::atomic<int> next(0);
  auto work = [&]() {
    for (int i = next.fetch_add(1); i < n_windows; i = next.fetch_add(1))
      persistence(dm + (int64_t)i * n * n, n, thresh, max_bars,
                  h1_b + (int64_t)i * max_bars, h1_d + (int64_t)i * max_bars,
                  h1_count + i, h1_essential + i,
                  h0_d + (int64_t)i * (n - 1), h0_count + i, n_tree + i);
  };
  if (n_threads <= 1) { work(); return; }
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
  for (auto& t : pool) t.join();
}

}  // extern "C"
