"""Host Dijkstra over the pose graph and the loop closer's candidate
composition. Counterpart of the Python path of
:mod:`pgslam_tpu.graph.shortest_path`."""

from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np

INF = np.float32(np.inf)


def _adjacency(n_vertices: int, edge_from, edge_to, weights,
               vertex_ok=None, edge_ok=None):
    """Adjacency lists honoring vertex/edge suppression predicates."""
    adj = [[] for _ in range(n_vertices)]
    for e in range(len(edge_from)):
        if edge_ok is not None and not edge_ok[e]:
            continue
        u, v = int(edge_from[e]), int(edge_to[e])
        if vertex_ok is not None and (not vertex_ok[u] or not vertex_ok[v]):
            continue
        w = float(weights[e])
        adj[u].append((v, w))
        adj[v].append((u, w))
    return adj


def dijkstra(n_vertices: int, edge_from, edge_to, weights, source: int,
             vertex_ok=None, edge_ok=None,
             max_settled: Optional[int] = None) -> Tuple[np.ndarray, list]:
    """Weighted SSSP. Returns (dists, settled vertices in examination
    order); stops once ``max_settled`` vertices are settled."""
    adj = _adjacency(n_vertices, edge_from, edge_to, weights, vertex_ok,
                     edge_ok)
    dist = np.full((n_vertices,), INF, np.float32)
    done = np.zeros((n_vertices,), bool)
    dist[source] = 0.0
    heap = [(0.0, source)]
    settled = []
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        settled.append(u)
        if max_settled is not None and len(settled) >= max_settled:
            break
        for v, w in adj[u]:
            nd = d + w
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist, settled


def candidate_composition(n_vertices: int, edge_from, edge_to, weights,
                          candidate: int, size: int,
                          vertex_ok, edge_ok) -> Optional[list]:
    """The first ``size`` vertices settled from ``candidate`` on the
    filtered graph, candidate LAST; None if fewer are reachable."""
    _, settled = dijkstra(n_vertices, edge_from, edge_to, weights, candidate,
                          vertex_ok=vertex_ok, edge_ok=edge_ok,
                          max_settled=size)
    if len(settled) < size:
        return None
    return list(reversed(settled))
