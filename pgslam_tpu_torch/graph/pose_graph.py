"""Pose-graph store and MapManager: single-writer host state in numpy.

A copy of :mod:`pgslam_tpu.graph.pose_graph` whose device accessors
return torch tensors. Vertices are integer ids in insertion order;
``update_times`` are monotonically increasing integer stamps.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..cloud import Cloud

ODOM_CONSTRAINT = 0
LOOP_CONSTRAINT = 1


@dataclasses.dataclass
class Keyframe:
    """Vertex payload snapshot."""
    id: int
    cloud: Cloud
    T_world_kf: np.ndarray
    optimized_T_world_kf: np.ndarray
    update_time: int


class PoseGraph:
    """Growable struct-of-arrays pose graph (capacities double)."""

    def __init__(self, initial_vertex_capacity: int = 64,
                 initial_edge_capacity: int = 128):
        self.n_vertices = 0
        self.n_edges = 0
        vc, ec = initial_vertex_capacity, initial_edge_capacity
        self.poses = np.zeros((vc, 4, 4), np.float32)
        self.optimized_poses = np.zeros((vc, 4, 4), np.float32)
        self.update_times = np.zeros((vc,), np.int64)
        self.clouds: List[Optional[Cloud]] = []
        self.edge_from = np.zeros((ec,), np.int32)
        self.edge_to = np.zeros((ec,), np.int32)
        self.edge_T = np.zeros((ec, 4, 4), np.float32)
        self.edge_cov = np.zeros((ec, 6, 6), np.float32)
        self.edge_type = np.zeros((ec,), np.int32)
        self.edge_weight = np.zeros((ec,), np.float32)

    def _ensure_vertex_capacity(self, n: int):
        cap = self.poses.shape[0]
        if n <= cap:
            return
        new = max(cap * 2, n)
        self.poses = _grow(self.poses, new)
        self.optimized_poses = _grow(self.optimized_poses, new)
        self.update_times = _grow(self.update_times, new)

    def _ensure_edge_capacity(self, n: int):
        cap = self.edge_from.shape[0]
        if n <= cap:
            return
        new = max(cap * 2, n)
        for name in ("edge_from", "edge_to", "edge_T", "edge_cov",
                     "edge_type", "edge_weight"):
            setattr(self, name, _grow(getattr(self, name), new))

    def add_vertex(self, cloud: Cloud, T_world_kf, update_time: int) -> int:
        v = self.n_vertices
        self._ensure_vertex_capacity(v + 1)
        self.poses[v] = np.asarray(T_world_kf, np.float32)
        self.optimized_poses[v] = np.asarray(T_world_kf, np.float32)
        self.update_times[v] = update_time
        self.clouds.append(cloud)
        self.n_vertices += 1
        return v

    def add_edge(self, u: int, v: int, T_from_to, cov, etype: int) -> int:
        if self.has_edge(u, v):
            raise ValueError(f"edge ({u}, {v}) already exists in the graph")
        e = self.n_edges
        self._ensure_edge_capacity(e + 1)
        self.edge_from[e] = u
        self.edge_to[e] = v
        T = np.asarray(T_from_to, np.float32)
        self.edge_T[e] = T
        self.edge_cov[e] = np.asarray(cov, np.float32)
        self.edge_type[e] = etype
        self.edge_weight[e] = float(np.linalg.norm(T[:3, 3]))
        self.n_edges += 1
        return e

    def has_edge(self, u: int, v: int) -> bool:
        f = self.edge_from[:self.n_edges]
        t = self.edge_to[:self.n_edges]
        return bool(np.any(((f == u) & (t == v)) | ((f == v) & (t == u))))

    def keyframe(self, v: int) -> Keyframe:
        return Keyframe(id=v, cloud=self.clouds[v],
                        T_world_kf=self.poses[v].copy(),
                        optimized_T_world_kf=self.optimized_poses[v].copy(),
                        update_time=int(self.update_times[v]))

    def adjacent_vertices(self, v: int) -> np.ndarray:
        f = self.edge_from[:self.n_edges]
        t = self.edge_to[:self.n_edges]
        return np.unique(np.concatenate([t[f == v], f[t == v]]))

    # -- device exports (torch) ------------------------------------------

    def device_poses(self, optimized: bool = True, device=None):
        arr = self.optimized_poses if optimized else self.poses
        return torch.as_tensor(arr[:self.n_vertices], device=device)

    def device_edges(self, device=None):
        e = self.n_edges
        return tuple(torch.as_tensor(a[:e], device=device) for a in (
            self.edge_from, self.edge_to, self.edge_T, self.edge_cov,
            self.edge_type, self.edge_weight))


def _grow(arr: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    out[:arr.shape[0]] = arr
    return out


class MapManager:
    """Sole owner of the pose graph; notifies the localizers and the loop
    closer."""

    def __init__(self):
        self.graph = PoseGraph()
        self.fixed_vertex: Optional[int] = None
        self._clock = 0
        self._localizers: List = []
        self._loop_closer = None

    def set_localizer(self, localizer) -> None:
        self._localizers = [localizer]

    def add_localizer(self, localizer) -> None:
        """Register one more localizer: a fleet's agents share the graph,
        and every one of them resyncs after an optimization writeback."""
        self._localizers.append(localizer)

    def set_loop_closer(self, loop_closer) -> None:
        self._loop_closer = loop_closer

    def get_graph(self) -> PoseGraph:
        return self.graph

    def get_fixed_vertex(self) -> int:
        return self.fixed_vertex

    def now(self) -> int:
        self._clock += 1
        return self._clock

    def add_first_keyframe(self, cloud: Cloud, T_world_kf) -> int:
        v = self.graph.add_vertex(cloud, T_world_kf, self.now())
        if self.fixed_vertex is None:
            self.fixed_vertex = v
        return v

    def add_new_keyframe(self, from_v: int, T_world_newkf, meas_T_from_newkf,
                         meas_cov_from_newkf, cloud: Cloud) -> int:
        """Vertex + odometry edge, then the loop closer runs on it."""
        if not 0 <= from_v < self.graph.n_vertices:
            raise ValueError("AddNewKeyframe: vertex 'from' must exist")
        v = self.graph.add_vertex(cloud, T_world_newkf, self.now())
        self.graph.add_edge(from_v, v, meas_T_from_newkf,
                            meas_cov_from_newkf, ODOM_CONSTRAINT)
        if self._loop_closer is not None:
            self._loop_closer.add_new_vertex(v)
        return v

    def add_loop_closing_constraint(self, from_v: int, to_v: int, T_from_to,
                                    cov_from_to) -> None:
        self.graph.add_edge(from_v, to_v, T_from_to, cov_from_to,
                            LOOP_CONSTRAINT)

    def update_keyframe_transforms_bulk(self, poses: np.ndarray,
                                        update_time: int) -> None:
        """Optimizer writeback of vertices ``0..len(poses)``."""
        n = len(poses)
        self.graph.optimized_poses[:n] = np.asarray(poses, np.float32)
        self.graph.update_times[:n] = update_time

    def notify_keyframe_update(self) -> None:
        for localizer in self._localizers:
            localizer.update_from_graph()

    def write_graphviz(self, path: str) -> None:
        g = self.graph
        lines = ["graph G {"]
        lines += [f"{v} [label={v}];" for v in range(g.n_vertices)]
        for e in range(g.n_edges):
            attr = "" if g.edge_type[e] == ODOM_CONSTRAINT \
                else " [style=dashed]"
            lines.append(f"{g.edge_from[e]}--{g.edge_to[e]}{attr};")
        lines.append("}")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
