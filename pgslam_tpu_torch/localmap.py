"""LocalMap: the sliding window of keyframes the robot localizes against,
with its cloud in the reference keyframe's frame (the reference keyframe
is the last of the window). Counterpart of :mod:`pgslam_tpu.localmap`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import se3
from .cloud import ROTATED_DESCRIPTORS, Cloud
from .graph.pose_graph import Keyframe, PoseGraph


class Composition:
    """Vertex-id circular buffer: ``push_back`` evicts the front once
    full; the back is the reference keyframe."""

    def __init__(self, capacity: int, items: Sequence[int] = ()):
        self.capacity = int(capacity)
        self._items: List[int] = []
        for v in items:
            self.push_back(v)

    def push_back(self, v: int) -> None:
        self._items.append(int(v))
        if len(self._items) > self.capacity:
            self._items.pop(0)

    def clear(self) -> None:
        self._items.clear()

    def back(self) -> int:
        return self._items[-1]

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)

    def __repr__(self):
        return f"Composition(cap={self.capacity}, {self._items})"

    def as_list(self) -> List[int]:
        return list(self._items)


def build_cloud(points, masks, descs, T_refkf_kf, slot_valid,
                desc_keys: Tuple[str, ...]):
    """Transform each keyframe cloud into the reference frame and flatten:
    ``[C, N, ...] -> [C*N, ...]``."""
    pts = se3.apply(T_refkf_kf, points)
    mask = masks & slot_valid[:, None]
    out_desc = {}
    for k in desc_keys:
        v = descs[k]
        if k in ROTATED_DESCRIPTORS and v.shape[-1] == 3:
            v = se3.rotate(T_refkf_kf, v)
        out_desc[k] = v.reshape(-1, v.shape[-1])
    return pts.reshape(-1, 3), mask.reshape(-1), out_desc


def stack_keyframes(kfs, capacity: int):
    """Stack keyframe clouds and their poses relative to the last one into
    the fixed-shape inputs of :func:`build_cloud`. Returns (points, masks,
    descs, T_refkf_kf, slot_valid, desc_keys, T_world_ref)."""
    ref = kfs[-1]
    C = capacity
    T_ref = np.asarray(ref.optimized_T_world_kf, np.float64)
    T_refkf_world = np.linalg.inv(T_ref)
    caps = {kf.cloud.capacity for kf in kfs}
    if len(caps) != 1:
        raise ValueError(
            f"composition requires equal keyframe cloud capacities: {caps}")
    n = caps.pop()
    dev = ref.cloud.device
    desc_keys = tuple(sorted(kfs[0].cloud.descriptors.keys()))

    def pad(arrs, fill):
        return arrs + [fill] * (C - len(arrs))

    points = torch.stack(pad([kf.cloud.points for kf in kfs],
                             torch.zeros((n, 3), device=dev)))
    masks = torch.stack(pad([kf.cloud.mask for kf in kfs],
                            torch.zeros(n, dtype=torch.bool, device=dev)))
    descs = {}
    for k in desc_keys:
        d = kfs[0].cloud.descriptors[k].shape[-1]
        descs[k] = torch.stack(pad([kf.cloud.descriptors[k] for kf in kfs],
                                   torch.zeros((n, d), device=dev)))
    Ts = np.stack(pad(
        [(T_refkf_world @ np.asarray(kf.optimized_T_world_kf, np.float64)
          ).astype(np.float32) for kf in kfs],
        np.eye(4, dtype=np.float32)))
    slot_valid = torch.as_tensor([True] * len(kfs) + [False] * (C - len(kfs)),
                                 device=dev)
    return (points, masks, descs, torch.as_tensor(Ts, device=dev),
            slot_valid, desc_keys, T_ref.astype(np.float32))


def stack_composition(graph: PoseGraph, comp_ids, capacity: int):
    return stack_keyframes([graph.keyframe(v) for v in comp_ids], capacity)


class LocalMap:
    """Sliding-window submap."""

    def __init__(self, capacity: int):
        self._capacity = int(capacity)
        self._data: List[Tuple[int, Keyframe]] = []
        self._cloud: Optional[Cloud] = None

    def update_to_new_composition(self, graph: PoseGraph,
                                  comp: Composition) -> None:
        self._capacity = comp.capacity
        self._data = [(v, graph.keyframe(v)) for v in comp]
        self._build_cloud()

    def update_from_graph(self, graph: PoseGraph) -> None:
        """Refresh payload snapshots for the current vertices."""
        self._data = [(v, graph.keyframe(v)) for v, _ in self._data]
        self._build_cloud()

    def capacity(self) -> int:
        return self._capacity

    def has_cloud(self) -> bool:
        return self._cloud is not None and len(self._data) > 0

    def cloud(self) -> Cloud:
        return self._cloud

    def cloud_in_world_frame(self) -> Cloud:
        from .cloud import transform_cloud
        T = torch.as_tensor(self.reference_keyframe().optimized_T_world_kf,
                            device=self._cloud.device)
        return transform_cloud(T, self._cloud)

    def get_composition(self) -> Composition:
        return Composition(self._capacity, [v for v, _ in self._data])

    def reference_vertex(self) -> int:
        return self._data[-1][0]

    def reference_keyframe(self) -> Keyframe:
        return self._data[-1][1]

    def has_same_vertex_set(self, comp: Composition) -> bool:
        return set(v for v, _ in self._data) == set(comp)

    def has_same_reference_vertex(self, comp: Composition) -> bool:
        return len(self._data) > 0 and len(comp) > 0 and \
            self._data[-1][0] == comp.back()

    def has_same_composition(self, comp: Composition) -> bool:
        return self.has_same_reference_vertex(comp) and \
            self.has_same_vertex_set(comp)

    def is_outdated(self, graph: PoseGraph) -> bool:
        return any(graph.update_times[v] > kf.update_time
                   for v, kf in self._data)

    def is_reference_keyframe_outdated(self, graph: PoseGraph) -> bool:
        v, kf = self._data[-1]
        return graph.update_times[v] > kf.update_time

    def find_closest_vertex(self, T_world_x) -> int:
        T = np.asarray(T_world_x)
        d = [np.linalg.norm(kf.optimized_T_world_kf[:3, 3] - T[:3, 3])
             for _, kf in self._data]
        return self._data[int(np.argmin(d))][0]

    def _build_cloud(self) -> None:
        if not self._data:
            self._cloud = None
            return
        points, masks, descs, Ts, slot_valid, desc_keys, _ = \
            stack_keyframes([kf for _, kf in self._data], self._capacity)
        pts, mask, out_desc = build_cloud(points, masks, descs, Ts,
                                          slot_valid, desc_keys)
        self._cloud = Cloud(points=pts, mask=mask, descriptors=out_desc)
