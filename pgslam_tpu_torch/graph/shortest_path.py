"""Host Dijkstra over the pose graph, the loop closer's candidate
composition, and a dense Bellman-Ford on tensors. Counterpart of
:mod:`pgslam_tpu.graph.shortest_path`: :func:`dijkstra` runs the native
core (:mod:`pgslam_tpu_torch.native`) where it builds, else a Python
heap with the same results."""

from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np
import torch

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
    try:
        from ..native import native_dijkstra
        return native_dijkstra(n_vertices, edge_from, edge_to, weights,
                               source, vertex_ok=vertex_ok, edge_ok=edge_ok,
                               max_settled=max_settled)
    except ImportError:
        pass
    return dijkstra_python(n_vertices, edge_from, edge_to, weights, source,
                           vertex_ok, edge_ok, max_settled)


def dijkstra_python(n_vertices: int, edge_from, edge_to, weights,
                    source: int, vertex_ok=None, edge_ok=None,
                    max_settled: Optional[int] = None
                    ) -> Tuple[np.ndarray, list]:
    """:func:`dijkstra` on a Python heap."""
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


def dense_adjacency(n: int, edge_from: torch.Tensor, edge_to: torch.Tensor,
                    weights: torch.Tensor, edge_mask: torch.Tensor
                    ) -> torch.Tensor:
    """Dense ``[n, n]`` weight matrix of the masked edges, both
    directions, the least weight where edges repeat; inf without an
    edge."""
    w = torch.where(edge_mask, weights.to(torch.float32),
                    torch.full_like(weights, float("inf"),
                                    dtype=torch.float32))
    W = torch.full((n * n,), float("inf"), dtype=torch.float32,
                   device=w.device)
    ef, et = edge_from.long(), edge_to.long()
    idx = torch.cat([ef * n + et, et * n + ef])
    W.scatter_reduce_(0, idx, torch.cat([w, w]), reduce="amin")
    return W.reshape(n, n)


def bellman_ford(W: torch.Tensor, source) -> torch.Tensor:
    """Single-source shortest distances over a dense weight matrix by
    min-plus relaxation sweeps until nothing changes (at most ``n``)."""
    n = W.shape[0]
    dist = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=W.device)
    dist[int(source)] = 0.0
    for _ in range(n):
        new = torch.minimum(dist, (dist[:, None] + W).amin(0))
        if not bool((new < dist).any()):
            break
        dist = new
    return dist
