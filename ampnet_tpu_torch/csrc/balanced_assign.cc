// Exact balanced assignment: min-cost flow by successive shortest paths over the
// compact cluster graph.
//
// Replaces the k_means_constrained Cython/ortools solver the reference uses for
// window tiling (reference data_proc/3_kmeans.py:78-82, utils/utils.py:500-505).
//
// Problem: assign N unit-supply points to k clusters with capacities cap[c],
// minimizing sum of cost[i][c]. Instead of running SSP over the full bipartite
// graph (N+k nodes, N*k edges, N augmentations), we exploit that every point
// connects to every cluster: an augmenting path is
//     new point -> c1 (-> reassign some point j1: c1 -> c2 -> ... ) -> free cluster
// so shortest paths only need the k-node cluster graph, whose edge (c1 -> c2)
// weight is min over points currently in c1 of cost[j][c2] - cost[j][c1].
// Those mins are maintained incrementally with lazy min-heaps per cluster pair.
// Complexity ~ O(N * k^2 log N): milliseconds at the production scale
// (N = 18432, k = 9).
//
// SSP with Johnson potentials gives an exact optimum of the transportation LP
// (integral because the constraint matrix is totally unimodular).

#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

struct HeapEntry {
  float delta;     // cost[j][c2] - cost[j][c1]
  int32_t point;
  uint32_t stamp;  // assignment version of `point` when pushed
  bool operator>(const HeapEntry& o) const { return delta > o.delta; }
};

using MinHeap =
    std::priority_queue<HeapEntry, std::vector<HeapEntry>, std::greater<HeapEntry>>;

class BalancedAssigner {
 public:
  BalancedAssigner(const float* cost, int n, int k, const int32_t* cap)
      : cost_(cost), n_(n), k_(k), cap_(cap, cap + k), load_(k, 0),
        assign_(n, -1), stamp_(n, 0), pi_(k, 0.0), heaps_(k * k) {}

  // Assign all points; returns false only on internal inconsistency.
  bool Run() {
    for (int i = 0; i < n_; ++i) {
      if (!Augment(i)) return false;
    }
    return true;
  }

  const std::vector<int32_t>& assignment() const { return assign_; }

 private:
  double EdgeWeight(int c1, int c2) {
    // lazily pop stale entries; return +inf if no valid point in c1
    MinHeap& h = heaps_[c1 * k_ + c2];
    while (!h.empty()) {
      const HeapEntry& e = h.top();
      if (assign_[e.point] == c1 && stamp_[e.point] == e.stamp) return e.delta;
      h.pop();
    }
    return kInf;
  }

  int32_t BestLeaving(int c1, int c2) {
    MinHeap& h = heaps_[c1 * k_ + c2];
    while (!h.empty()) {
      const HeapEntry& e = h.top();
      if (assign_[e.point] == c1 && stamp_[e.point] == e.stamp) return e.point;
      h.pop();
    }
    return -1;
  }

  void Attach(int32_t p, int c) {
    assign_[p] = c;
    ++stamp_[p];
    ++load_[c];
    const float base = cost_[static_cast<int64_t>(p) * k_ + c];
    for (int c2 = 0; c2 < k_; ++c2) {
      if (c2 == c) continue;
      heaps_[c * k_ + c2].push(
          {cost_[static_cast<int64_t>(p) * k_ + c2] - base, p, stamp_[p]});
    }
  }

  bool Augment(int32_t point) {
    // Dijkstra from the new point over cluster nodes with reduced costs.
    // Convention: reduced(u->v) = w + pi[u] - pi[v] (>= 0 for residual edges);
    // the point's own edges are only used for initialization, so they may start
    // negative without breaking Dijkstra.
    std::vector<double> dist(k_);
    std::vector<int> prev(k_, -1);  // predecessor cluster on the path (-1 = direct)
    std::vector<bool> done(k_, false);
    const float* crow = cost_ + static_cast<int64_t>(point) * k_;
    for (int c = 0; c < k_; ++c) dist[c] = crow[c] - pi_[c];

    int target = -1;
    for (int it = 0; it < k_; ++it) {
      int u = -1;
      double best = kInf;
      for (int c = 0; c < k_; ++c)
        if (!done[c] && dist[c] < best) { best = dist[c]; u = c; }
      if (u < 0) break;
      done[u] = true;
      if (load_[u] < cap_[u]) { target = u; break; }
      for (int v = 0; v < k_; ++v) {
        if (done[v]) continue;
        double w = EdgeWeight(u, v);
        if (w >= kInf) continue;
        double nd = dist[u] + w + pi_[u] - pi_[v];
        if (nd < dist[v] - 1e-12) { dist[v] = nd; prev[v] = u; }
      }
    }
    if (target < 0) return false;  // capacities exhausted (caller guarantees not)

    // Johnson potential update: pi[c] += min(dist[c], dist[target]) keeps every
    // residual reduced cost non-negative and zeroes the shortest-path edges.
    for (int c = 0; c < k_; ++c) pi_[c] += std::min(dist[c], dist[target]);

    // Walk the path back, reassigning evicted points.
    std::vector<int> path;  // clusters from target back to the direct one
    for (int c = target; c != -1; c = prev[c]) path.push_back(c);
    // path = [target, ..., first_cluster]; reassign along it
    for (size_t idx = 0; idx + 1 < path.size(); ++idx) {
      int c_to = path[idx];
      int c_from = path[idx + 1];
      int32_t mover = BestLeaving(c_from, c_to);
      if (mover < 0) return false;
      --load_[c_from];
      Attach(mover, c_to);
    }
    Attach(point, path.back());
    return true;
  }

  static constexpr double kInf = std::numeric_limits<double>::infinity();

  const float* cost_;
  int n_, k_;
  std::vector<int32_t> cap_;
  std::vector<int32_t> load_;
  std::vector<int32_t> assign_;
  std::vector<uint32_t> stamp_;
  std::vector<double> pi_;
  std::vector<MinHeap> heaps_;
};

}  // namespace

extern "C" {

// cost: row-major [n, k]; caps: [k] with sum >= n; out: [n] cluster indices.
// Returns 0 on success.
int ampnet_balanced_assign(const float* cost, int32_t n, int32_t k,
                           const int32_t* caps, int32_t* out) {
  int64_t total = 0;
  for (int c = 0; c < k; ++c) total += caps[c];
  if (total < n) return 1;
  BalancedAssigner solver(cost, n, k, caps);
  if (!solver.Run()) return 2;
  std::memcpy(out, solver.assignment().data(), sizeof(int32_t) * n);
  return 0;
}

// Squared-euclidean cost matrix helper: points [n, d], centroids [k, d].
void ampnet_sqdist(const float* pts, const float* cents, int32_t n, int32_t k,
                   int32_t d, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + i * d;
    for (int c = 0; c < k; ++c) {
      const float* q = cents + static_cast<int64_t>(c) * d;
      float acc = 0.f;
      for (int j = 0; j < d; ++j) {
        const float diff = p[j] - q[j];
        acc += diff * diff;
      }
      out[i * k + c] = acc;
    }
  }
}

// Full balanced k-means: Lloyd iterations with exact balanced assignment.
// points [n, d]; caps [k]; out_assign [n]; out_centroids [k, d].
// Returns 0 on success.
int ampnet_balanced_kmeans(const float* pts, int32_t n, int32_t d, int32_t k,
                           const int32_t* caps, int32_t iters, uint64_t seed,
                           int32_t* out_assign, float* out_centroids) {
  // init: k distinct points chosen by a splitmix64 shuffle
  std::vector<int64_t> perm(n);
  for (int64_t i = 0; i < n; ++i) perm[i] = i;
  uint64_t s = seed + 0x9E3779B97F4A7C15ull;
  auto next = [&s]() {
    s += 0x9E3779B97F4A7C15ull;
    uint64_t z = s;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  };
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(next() % (i + 1));
    std::swap(perm[i], perm[j]);
  }
  std::vector<float> cents(static_cast<size_t>(k) * d);
  for (int c = 0; c < k; ++c)
    std::memcpy(&cents[static_cast<size_t>(c) * d], pts + perm[c] * d,
                sizeof(float) * d);

  std::vector<float> cost(static_cast<size_t>(n) * k);
  for (int it = 0; it < iters; ++it) {
    ampnet_sqdist(pts, cents.data(), n, k, d, cost.data());
    if (int rc = ampnet_balanced_assign(cost.data(), n, k, caps, out_assign))
      return rc;
    // centroid update
    std::vector<double> acc(static_cast<size_t>(k) * d, 0.0);
    std::vector<int64_t> cnt(k, 0);
    for (int64_t i = 0; i < n; ++i) {
      const int c = out_assign[i];
      ++cnt[c];
      for (int j = 0; j < d; ++j) acc[static_cast<size_t>(c) * d + j] += pts[i * d + j];
    }
    for (int c = 0; c < k; ++c)
      for (int j = 0; j < d; ++j)
        cents[static_cast<size_t>(c) * d + j] =
            cnt[c] ? static_cast<float>(acc[static_cast<size_t>(c) * d + j] / cnt[c])
                   : cents[static_cast<size_t>(c) * d + j];
  }
  ampnet_sqdist(pts, cents.data(), n, k, d, cost.data());
  if (int rc = ampnet_balanced_assign(cost.data(), n, k, caps, out_assign)) return rc;
  std::memcpy(out_centroids, cents.data(), sizeof(float) * k * d);
  return 0;
}

// Farthest point sampling (reference utils/utils.py:889-933 semantics, start at 0).
// points [n, d] (first 3 dims used); out [m] indices.
void ampnet_fps(const float* pts, int32_t n, int32_t d, int32_t m, int32_t* out) {
  const int dd = d < 3 ? d : 3;
  std::vector<float> dist(n, std::numeric_limits<float>::infinity());
  int32_t last = 0;
  out[0] = 0;
  for (int i = 1; i < m; ++i) {
    const float* p = pts + static_cast<int64_t>(last) * d;
    float best = -1.f;
    int32_t arg = 0;
    for (int64_t j = 0; j < n; ++j) {
      const float* q = pts + j * d;
      float acc = 0.f;
      for (int t = 0; t < dd; ++t) {
        const float diff = p[t] - q[t];
        acc += diff * diff;
      }
      if (acc < dist[j]) dist[j] = acc;
      if (dist[j] > best) { best = dist[j]; arg = static_cast<int32_t>(j); }
    }
    out[i] = arg;
    last = arg;
    dist[arg] = -1.f;  // never re-selected
  }
}

// Grid-pruned exact FPS for large offline tiles (same results as ampnet_fps,
// bit-exact including ties — smallest index among maxima). Pruning idea follows
// the bucketed FPS literature (FlashFPS/QuickFPS, see repo PAPERS.md): points are
// bucketed into a coarse grid with tight per-cell bounding boxes; a cell whose
// bbox min-distance to the new center is >= the cell's current max min-distance
// cannot change, so it is neither swept nor rescanned — its cached (max, argmax)
// keeps representing it in the global argmax.
void ampnet_fps_grid(const float* pts, int32_t n, int32_t d, int32_t m,
                     int32_t* out) {
  const int dd = d < 3 ? d : 3;
  // bounding box
  float lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
  for (int t = 0; t < dd; ++t) { lo[t] = hi[t] = pts[t]; }
  for (int64_t j = 1; j < n; ++j)
    for (int t = 0; t < dd; ++t) {
      const float v = pts[j * d + t];
      if (v < lo[t]) lo[t] = v;
      if (v > hi[t]) hi[t] = v;
    }
  // per-axis resolution ~ cbrt(n/32), capped — fine enough to prune, coarse
  // enough that the per-iteration cell scan stays cheap
  int r = 1;
  while (static_cast<int64_t>(r + 1) * (r + 1) * (r + 1) * 32 <= n && r < 48) ++r;
  int res[3] = {1, 1, 1};
  float inv[3] = {0, 0, 0};
  for (int t = 0; t < dd; ++t) {
    res[t] = (hi[t] > lo[t]) ? r : 1;
    inv[t] = (hi[t] > lo[t]) ? res[t] / (hi[t] - lo[t]) : 0.f;
  }
  const int n_cells = res[0] * res[1] * res[2];

  auto cell_of = [&](const float* q) {
    int c = 0;
    for (int t = 0; t < dd; ++t) {
      int ix = static_cast<int>((q[t] - lo[t]) * inv[t]);
      if (ix >= res[t]) ix = res[t] - 1;
      if (ix < 0) ix = 0;
      c = c * res[t] + ix;
    }
    return c;
  };

  // CSR bucketing in ascending point order (keeps in-cell index order for ties)
  std::vector<int32_t> count(n_cells, 0), offs(n_cells + 1, 0), order(n);
  for (int64_t j = 0; j < n; ++j) count[cell_of(pts + j * d)]++;
  for (int c = 0; c < n_cells; ++c) offs[c + 1] = offs[c] + count[c];
  {
    std::vector<int32_t> cur(offs.begin(), offs.end() - 1);
    for (int64_t j = 0; j < n; ++j) order[cur[cell_of(pts + j * d)]++] = j;
  }
  // tight per-cell bboxes
  std::vector<float> blo(static_cast<size_t>(n_cells) * 3),
      bhi(static_cast<size_t>(n_cells) * 3);
  for (int c = 0; c < n_cells; ++c) {
    if (offs[c] == offs[c + 1]) continue;
    for (int t = 0; t < 3; ++t) {
      blo[c * 3 + t] = std::numeric_limits<float>::infinity();
      bhi[c * 3 + t] = -std::numeric_limits<float>::infinity();
    }
    for (int32_t s = offs[c]; s < offs[c + 1]; ++s) {
      const float* q = pts + static_cast<int64_t>(order[s]) * d;
      for (int t = 0; t < dd; ++t) {
        blo[c * 3 + t] = std::min(blo[c * 3 + t], q[t]);
        bhi[c * 3 + t] = std::max(bhi[c * 3 + t], q[t]);
      }
    }
  }

  const float inf = std::numeric_limits<float>::infinity();
  std::vector<float> dist(n, inf);
  std::vector<float> cmax(n_cells, inf);
  std::vector<int32_t> carg(n_cells, -1);
  // initial per-cell argmax: smallest index (all dists inf)
  for (int c = 0; c < n_cells; ++c)
    if (offs[c] < offs[c + 1]) carg[c] = order[offs[c]];

  auto sweep_cell = [&](int c, const float* p) {
    // update dists in cell against center p (p = nullptr: rescan only),
    // recompute (cmax, carg) with smallest-index tie-breaking
    float best = -inf;
    int32_t arg = -1;
    for (int32_t s = offs[c]; s < offs[c + 1]; ++s) {
      const int64_t j = order[s];
      if (p) {
        const float* q = pts + j * d;
        float acc = 0.f;
        for (int t = 0; t < dd; ++t) {
          const float diff = p[t] - q[t];
          acc += diff * diff;
        }
        if (acc < dist[j]) dist[j] = acc;
      }
      if (dist[j] > best) { best = dist[j]; arg = static_cast<int32_t>(j); }
    }
    cmax[c] = best;
    carg[c] = arg;
  };

  int32_t last = 0;
  out[0] = 0;  // dist[0] becomes 0 on the first sweep, exactly like ampnet_fps
  for (int i = 1; i < m; ++i) {
    const float* p = pts + static_cast<int64_t>(last) * d;
    for (int c = 0; c < n_cells; ++c) {
      if (offs[c] == offs[c + 1]) continue;
      float bd = 0.f;  // min squared distance from p to the cell's tight bbox
      for (int t = 0; t < dd; ++t) {
        const float v = p[t];
        const float g = v < blo[c * 3 + t] ? blo[c * 3 + t] - v
                        : v > bhi[c * 3 + t] ? v - bhi[c * 3 + t]
                                             : 0.f;
        bd += g * g;
      }
      if (bd < cmax[c]) sweep_cell(c, p);
    }
    // global argmax over cell caches, smallest point index on ties
    float best = -inf;
    int32_t arg = 0;
    for (int c = 0; c < n_cells; ++c) {
      if (carg[c] < 0) continue;
      if (cmax[c] > best || (cmax[c] == best && carg[c] < arg)) {
        best = cmax[c];
        arg = carg[c];
      }
    }
    out[i] = arg;
    last = arg;
    dist[arg] = -1.f;
    sweep_cell(cell_of(pts + static_cast<int64_t>(arg) * d), nullptr);
  }
}

}  // extern "C"
