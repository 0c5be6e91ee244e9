// Exact 1-Wasserstein distance between persistence diagrams with persim's
// semantics, on the host CPU: the `host_exact` Wasserstein backend of the
// study runner (the reference's persim matching, scripts/utils.py:180-191).
//
// persim builds an (m + n) × (m + n) cost matrix for diagrams of m and n
// points: L∞ distance between off-diagonal points; each point's own diagonal
// projection at (death − birth)/2; every other diagonal slot at the maximum
// of the matrix filled so far (the second block therefore also sees the
// first diagram's projections); zero between diagonal slots.  The optimal
// assignment is found exactly by the Jonker–Volgenant shortest augmenting
// path, in float64.
//
// Build: compiled into the host engine's library (native/engine.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>

namespace {

// Shortest-augmenting-path assignment of a square n × n cost matrix;
// returns the cost of the optimal assignment.
double lap_jv(int n, const std::vector<double>& cost) {
  const double INF = 1e18;
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
  std::vector<int> p(n + 1, 0), way(n + 1, 0);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(n + 1, INF);
    std::vector<char> used(n + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = -1;
      double delta = INF;
      for (int j = 1; j <= n; ++j) {
        if (used[j]) continue;
        double cur = cost[(size_t)(i0 - 1) * n + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
        if (minv[j] < delta) { delta = minv[j]; j1 = j; }
      }
      for (int j = 0; j <= n; ++j) {
        if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
        else minv[j] -= delta;
      }
      j0 = j1;
    } while (p[j0] != 0);
    do { int j1 = way[j0]; p[j0] = p[j1]; j0 = j1; } while (j0);
  }
  double total = 0.0;
  for (int j = 1; j <= n; ++j)
    total += cost[(size_t)(p[j] - 1) * n + (j - 1)];
  return total;
}

// One pair of diagrams, m ≥ 1 and nn ≥ 1 points.
double persim_wasserstein_one(const float* b1, const float* d1, int m,
                              const float* b2, const float* d2, int nn) {
  const int S = m + nn;
  std::vector<double> D((size_t)S * S, 0.0);
  double mx = 0.0;
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < nn; ++j) {
      double c = std::max(std::fabs((double)b1[i] - b2[j]),
                          std::fabs((double)d1[i] - d2[j]));
      D[(size_t)i * S + j] = c;
      mx = std::max(mx, c);
    }
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < m; ++j)
      D[(size_t)i * S + nn + j] = (i == j) ? 0.5 * ((double)d1[i] - b1[i]) : mx;
  double mx2 = mx;
  for (int i = 0; i < m; ++i)
    mx2 = std::max(mx2, 0.5 * ((double)d1[i] - b1[i]));
  for (int i = 0; i < nn; ++i)
    for (int j = 0; j < nn; ++j)
      D[(size_t)(m + i) * S + j] = (i == j) ? 0.5 * ((double)d2[i] - b2[i]) : mx2;
  return lap_jv(S, D);
}

}  // namespace

extern "C" {

// b1/d1: (n_pairs, K1) and b2/d2: (n_pairs, K2) row-major float32, each
// row's valid bars first; c1/c2 (n_pairs,) their counts.  An empty diagram
// (count 0) is the single point (0, 0), as the reference's cleanup makes it.
void wasserstein_host_batch(const float* b1, const float* d1, const int* c1,
                            int K1, const float* b2, const float* d2,
                            const int* c2, int K2, int n_pairs, int n_threads,
                            float* out) {
  std::atomic<int> next(0);
  auto work = [&]() {
    const float zero = 0.0f;
    for (int w = next.fetch_add(1); w < n_pairs; w = next.fetch_add(1)) {
      const float* B1 = b1 + (size_t)w * K1;
      const float* D1 = d1 + (size_t)w * K1;
      const float* B2 = b2 + (size_t)w * K2;
      const float* D2 = d2 + (size_t)w * K2;
      int m = c1[w], nn = c2[w];
      if (m == 0) { B1 = D1 = &zero; m = 1; }
      if (nn == 0) { B2 = D2 = &zero; nn = 1; }
      out[w] = (float)persim_wasserstein_one(B1, D1, m, B2, D2, nn);
    }
  };
  if (n_threads <= 1) { work(); return; }
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
  for (auto& t : pool) t.join();
}

}  // extern "C"
