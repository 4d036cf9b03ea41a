// Native pose-graph shortest-path core.
//
// C++ replacement for the runtime role Boost.Graph plays in the reference
// (dijkstra_shortest_paths with visitors + filtered_graph,
// LoopCloser.hpp:211,275, Localizer.hpp:448). One entry point covers all
// three call sites: weighted SSSP with optional vertex/edge suppression
// predicates (the filtered-graph analog) and an optional early stop after
// N settled vertices (the record-n-and-stop visitor analog).
//
// Exposed as a C ABI for ctypes; no external dependencies.

#include <cstdint>
#include <queue>
#include <vector>
#include <limits>
#include <utility>

extern "C" {

// Returns the number of settled vertices. out_dist must hold n_vertices
// floats (filled with +inf for unreached), out_settled must hold
// n_vertices ints (settle order).
int pg_dijkstra(int n_vertices, int n_edges,
                const int32_t* edge_from, const int32_t* edge_to,
                const float* weights, int source,
                const uint8_t* vertex_ok,   // nullable: 1 = keep
                const uint8_t* edge_ok,     // nullable: 1 = keep
                int max_settled,            // <=0: no cap
                float* out_dist, int32_t* out_settled) {
  const float INF = std::numeric_limits<float>::infinity();
  // CSR adjacency (undirected: both directions).
  std::vector<int> degree(n_vertices, 0);
  for (int e = 0; e < n_edges; ++e) {
    if (edge_ok && !edge_ok[e]) continue;
    int u = edge_from[e], v = edge_to[e];
    if (u < 0 || u >= n_vertices || v < 0 || v >= n_vertices) continue;
    if (vertex_ok && (!vertex_ok[u] || !vertex_ok[v])) continue;
    ++degree[u];
    ++degree[v];
  }
  std::vector<int> offset(n_vertices + 1, 0);
  for (int i = 0; i < n_vertices; ++i) offset[i + 1] = offset[i] + degree[i];
  std::vector<int> adj_v(offset[n_vertices]);
  std::vector<float> adj_w(offset[n_vertices]);
  std::vector<int> cursor(offset.begin(), offset.end() - 1);
  for (int e = 0; e < n_edges; ++e) {
    if (edge_ok && !edge_ok[e]) continue;
    int u = edge_from[e], v = edge_to[e];
    if (u < 0 || u >= n_vertices || v < 0 || v >= n_vertices) continue;
    if (vertex_ok && (!vertex_ok[u] || !vertex_ok[v])) continue;
    float w = weights[e];
    adj_v[cursor[u]] = v; adj_w[cursor[u]] = w; ++cursor[u];
    adj_v[cursor[v]] = u; adj_w[cursor[v]] = w; ++cursor[v];
  }

  for (int i = 0; i < n_vertices; ++i) out_dist[i] = INF;
  if (source < 0 || source >= n_vertices) return 0;
  if (vertex_ok && !vertex_ok[source]) return 0;
  out_dist[source] = 0.0f;

  using Item = std::pair<float, int>;
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
  std::vector<uint8_t> done(n_vertices, 0);
  heap.emplace(0.0f, source);
  int n_settled = 0;
  while (!heap.empty()) {
    auto [d, u] = heap.top();
    heap.pop();
    if (done[u]) continue;
    done[u] = 1;
    out_settled[n_settled++] = u;
    if (max_settled > 0 && n_settled >= max_settled) break;
    for (int k = offset[u]; k < offset[u] + degree[u]; ++k) {
      int v = adj_v[k];
      float nd = d + adj_w[k];
      if (nd < out_dist[v]) {
        out_dist[v] = nd;
        heap.emplace(nd, v);
      }
    }
  }
  return n_settled;
}

// Connected-component labels (utility for graph sanity checks / batching).
int pg_components(int n_vertices, int n_edges,
                  const int32_t* edge_from, const int32_t* edge_to,
                  int32_t* out_label) {
  std::vector<int> parent(n_vertices);
  for (int i = 0; i < n_vertices; ++i) parent[i] = i;
  std::vector<int> rank_(n_vertices, 0);
  auto find = [&](int x) {
    while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
    return x;
  };
  for (int e = 0; e < n_edges; ++e) {
    int a = find(edge_from[e]), b = find(edge_to[e]);
    if (a == b) continue;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    if (rank_[a] == rank_[b]) ++rank_[a];
  }
  int n_comp = 0;
  std::vector<int> remap(n_vertices, -1);
  for (int i = 0; i < n_vertices; ++i) {
    int r = find(i);
    if (remap[r] < 0) remap[r] = n_comp++;
    out_label[i] = remap[r];
  }
  return n_comp;
}

}  // extern "C"
