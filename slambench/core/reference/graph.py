"""Plain host code of the reference's loop-closure search: Dijkstra on the
pose graph and the candidate local map of a new keyframe (geometrically
close, topologically far, grown by Dijkstra on the graph without loop
edges). A frozen copy of ``pgslam_tpu_torch/graph/shortest_path.py``'s
Python heap and ``loopcloser.py::find_candidate_composition``.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

LOOP_EDGE = 1   # the program's LOOP_CONSTRAINT edge type


def dijkstra(n, edge_from, edge_to, weights, source, vertex_ok=None,
             edge_ok=None, max_settled=None) -> Tuple[np.ndarray, list]:
    adj = [[] for _ in range(n)]
    for e in range(len(edge_from)):
        if edge_ok is not None and not edge_ok[e]:
            continue
        u, v = int(edge_from[e]), int(edge_to[e])
        if vertex_ok is not None and (not vertex_ok[u] or not vertex_ok[v]):
            continue
        w = float(weights[e])
        adj[u].append((v, w))
        adj[v].append((u, w))
    dist = np.full((n,), np.inf, np.float32)
    done = np.zeros((n,), bool)
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


def candidate(graph: dict, v: int, cfg: dict
              ) -> Tuple[Optional[List[int]], bool]:
    """The candidate composition for new keyframe ``v`` of the graph
    snapshot ``graph`` (``n``, ``poses``, ``edge_from``, ``edge_to``,
    ``edge_weight``, ``edge_type``), or None; and whether a threshold
    decided it by less than 1 % (a knife edge)."""
    n = graph["n"]
    if n <= 1:
        return None, False
    ef, et = graph["edge_from"], graph["edge_to"]
    ew, ety = graph["edge_weight"], graph["edge_type"]
    topo, _ = dijkstra(n, ef, et, ew, v)
    pos = graph["poses"][:n, :3, 3]
    geom = np.linalg.norm(pos - pos[v], axis=-1)
    g_thr, t_thr = cfg["geom_dist_threshold"], cfg["topo_dist_threshold"]
    edge = bool(np.any(np.abs(geom - g_thr) < 0.01 * g_thr)
                | np.any(np.abs(topo[np.isfinite(topo)] - t_thr)
                         < 0.01 * t_thr))
    cand = np.nonzero((geom <= g_thr) & (topo > t_thr))[0]
    cand = cand[np.argsort(geom[cand], kind="stable")]
    vertex_ok = topo > t_thr
    edge_ok = ety != LOOP_EDGE
    size = cfg.get("candidate_local_map_size", 3)
    for c in cand:
        _, settled = dijkstra(n, ef, et, ew, int(c), vertex_ok=vertex_ok,
                              edge_ok=edge_ok, max_settled=size)
        if len(settled) >= size:
            return list(reversed(settled)), edge
    return None, edge
