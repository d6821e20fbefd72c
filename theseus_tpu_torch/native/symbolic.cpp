// Native symbolic-analysis core for the batched block-sparse Cholesky.
//
// A copy of the JAX package's theseus_tpu/native/symbolic.cpp (the port
// imports nothing of that package): fill-reducing orderings (greedy minimum
// degree, BFS nested dissection), symbolic elimination fill, and the
// elimination tree. Host-side setup only: the numeric factorization runs on
// the card (sparse/cholesky.py). Exposed through a plain C ABI and loaded
// with ctypes (theseus_tpu_torch/native/__init__.py, which builds it with
// g++ -O2 -shared -fPIC -std=c++17 at first use); the Python analysis in
// sparse/structure.py is its twin in the tests.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <set>
#include <vector>

extern "C" {

struct SymbolicResult {
  std::vector<int64_t> perm;
  std::vector<int64_t> col_ptr;   // n+1
  std::vector<int64_t> col_rows;  // nnz (rows per column, diag first, sorted)
  std::vector<int64_t> etree;     // n (parent or -1)
  std::vector<int64_t> level_of;  // n
};

static void build_adj(int64_t n, int64_t ne, const int64_t* edges,
                      std::vector<std::vector<int64_t>>& adj) {
  adj.assign(n, {});
  for (int64_t e = 0; e < ne; ++e) {
    int64_t i = edges[2 * e], j = edges[2 * e + 1];
    if (i == j) continue;
    adj[i].push_back(j);
    adj[j].push_back(i);
  }
  for (auto& a : adj) {
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
  }
}

// Greedy exact-minimum-degree with neighbor merging (matches the Python
// amd_ordering in sparse/structure.py).
static void amd_order(int64_t n, const std::vector<std::vector<int64_t>>& adj0,
                      std::vector<int64_t>& perm) {
  std::vector<std::set<int64_t>> adj(n);
  for (int64_t i = 0; i < n; ++i) adj[i] = {adj0[i].begin(), adj0[i].end()};
  std::vector<char> alive(n, 1);
  std::vector<int64_t> degree(n);
  perm.clear();
  perm.reserve(n);
  for (int64_t step = 0; step < n; ++step) {
    int64_t best = -1, best_deg = INT64_MAX;
    for (int64_t v = 0; v < n; ++v) {
      if (!alive[v]) continue;
      int64_t d = 0;
      for (int64_t u : adj[v])
        if (alive[u]) ++d;
      if (d < best_deg) {
        best_deg = d;
        best = v;
      }
    }
    perm.push_back(best);
    alive[best] = 0;
    std::vector<int64_t> nbrs;
    for (int64_t u : adj[best])
      if (alive[u]) nbrs.push_back(u);
    for (int64_t u : nbrs) {
      for (int64_t w : nbrs)
        if (w != u) adj[u].insert(w);
      adj[u].erase(u);
    }
  }
}

// BFS-bisection nested dissection (matches nd_ordering in structure.py).
static void nd_rec(const std::vector<std::vector<int64_t>>& adj,
                   std::vector<int64_t> nodes, int64_t leaf_size,
                   std::vector<int64_t>& out) {
  if ((int64_t)nodes.size() <= leaf_size) {
    std::sort(nodes.begin(), nodes.end());
    out.insert(out.end(), nodes.begin(), nodes.end());
    return;
  }
  std::set<int64_t> node_set(nodes.begin(), nodes.end());
  auto bfs = [&](int64_t start, std::vector<std::vector<int64_t>>& levels,
                 std::set<int64_t>& seen) {
    levels.clear();
    seen.clear();
    seen.insert(start);
    std::vector<int64_t> frontier{start};
    levels.push_back(frontier);
    while (!frontier.empty()) {
      std::vector<int64_t> nxt;
      for (int64_t u : frontier)
        for (int64_t v : adj[u])
          if (node_set.count(v) && !seen.count(v)) {
            seen.insert(v);
            nxt.push_back(v);
          }
      if (!nxt.empty()) levels.push_back(nxt);
      frontier = nxt;
    }
  };
  int64_t start = *std::min_element(nodes.begin(), nodes.end());
  std::vector<std::vector<int64_t>> levels;
  std::set<int64_t> seen;
  bfs(start, levels, seen);
  if (seen.size() != nodes.size()) {  // disconnected
    std::vector<int64_t> a(seen.begin(), seen.end()), b;
    for (int64_t v : nodes)
      if (!seen.count(v)) b.push_back(v);
    nd_rec(adj, a, leaf_size, out);
    nd_rec(adj, b, leaf_size, out);
    return;
  }
  bfs(levels.back()[0], levels, seen);  // pseudo-peripheral restart
  if (levels.size() < 3) {
    std::sort(nodes.begin(), nodes.end());
    out.insert(out.end(), nodes.begin(), nodes.end());
    return;
  }
  size_t mid = levels.size() / 2;
  std::vector<int64_t> sep = levels[mid], left, right;
  for (size_t l = 0; l < mid; ++l)
    left.insert(left.end(), levels[l].begin(), levels[l].end());
  for (size_t l = mid + 1; l < levels.size(); ++l)
    right.insert(right.end(), levels[l].begin(), levels[l].end());
  nd_rec(adj, left, leaf_size, out);
  nd_rec(adj, right, leaf_size, out);
  std::sort(sep.begin(), sep.end());
  out.insert(out.end(), sep.begin(), sep.end());
}

// mode: 0 = natural, 1 = amd, 2 = nd
SymbolicResult* symbolic_analyze(int64_t n, int64_t ne, const int64_t* edges,
                                 int64_t mode) {
  auto* res = new SymbolicResult();
  std::vector<std::vector<int64_t>> adj;
  build_adj(n, ne, edges, adj);

  if (mode == 1) {
    amd_order(n, adj, res->perm);
  } else if (mode == 2) {
    std::vector<int64_t> nodes(n);
    for (int64_t i = 0; i < n; ++i) nodes[i] = i;
    nd_rec(adj, nodes, 8, res->perm);
  } else {
    res->perm.resize(n);
    for (int64_t i = 0; i < n; ++i) res->perm[i] = i;
  }

  std::vector<int64_t> iperm(n);
  for (int64_t i = 0; i < n; ++i) iperm[res->perm[i]] = i;

  // symbolic fill: pattern(j) = below(j) union child patterns (minus parent)
  std::vector<std::set<int64_t>> pattern(n);
  for (int64_t e = 0; e < ne; ++e) {
    int64_t i = edges[2 * e], j = edges[2 * e + 1];
    if (i == j) continue;
    int64_t pi = iperm[i], pj = iperm[j];
    if (pi > pj) std::swap(pi, pj);
    pattern[pi].insert(pj);
  }
  res->etree.assign(n, -1);
  for (int64_t j = 0; j < n; ++j) {
    if (!pattern[j].empty()) {
      int64_t parent = *pattern[j].begin();
      res->etree[j] = parent;
      for (int64_t r : pattern[j])
        if (r != parent) pattern[parent].insert(r);
    }
  }

  res->col_ptr.assign(n + 1, 0);
  for (int64_t j = 0; j < n; ++j)
    res->col_ptr[j + 1] = res->col_ptr[j] + 1 + (int64_t)pattern[j].size();
  res->col_rows.reserve(res->col_ptr[n]);
  for (int64_t j = 0; j < n; ++j) {
    res->col_rows.push_back(j);
    for (int64_t r : pattern[j]) res->col_rows.push_back(r);
  }

  res->level_of.assign(n, 0);
  for (int64_t j = 0; j < n; ++j) {
    int64_t p = res->etree[j];
    if (p >= 0 && res->level_of[p] < res->level_of[j] + 1)
      res->level_of[p] = res->level_of[j] + 1;
  }
  return res;
}

int64_t symbolic_nnz(SymbolicResult* r) { return (int64_t)r->col_rows.size(); }

void symbolic_fetch(SymbolicResult* r, int64_t* perm, int64_t* col_ptr,
                    int64_t* col_rows, int64_t* etree, int64_t* level_of) {
  std::memcpy(perm, r->perm.data(), r->perm.size() * sizeof(int64_t));
  std::memcpy(col_ptr, r->col_ptr.data(), r->col_ptr.size() * sizeof(int64_t));
  std::memcpy(col_rows, r->col_rows.data(),
              r->col_rows.size() * sizeof(int64_t));
  std::memcpy(etree, r->etree.data(), r->etree.size() * sizeof(int64_t));
  std::memcpy(level_of, r->level_of.data(),
              r->level_of.size() * sizeof(int64_t));
}

void symbolic_free(SymbolicResult* r) { delete r; }

}  // extern "C"
