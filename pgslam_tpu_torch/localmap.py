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
    ``[..., C, N, ...] -> [..., C*N, ...]`` (leading dimensions are a batch
    of compositions)."""
    lead = points.shape[:-3]
    pts = se3.apply(T_refkf_kf, points)
    mask = masks & slot_valid[..., None]
    out_desc = {}
    for k in desc_keys:
        v = descs[k]
        if k in ROTATED_DESCRIPTORS and v.shape[-1] == 3:
            v = se3.rotate(T_refkf_kf, v)
        out_desc[k] = v.reshape(*lead, -1, v.shape[-1])
    return pts.reshape(*lead, -1, 3), mask.reshape(*lead, -1), out_desc


def stack_keyframes(kfs, capacity: int):
    """Stack keyframe clouds and their poses relative to the last one into
    the fixed-shape inputs of :func:`build_cloud`. Returns (points, masks,
    descs, T_refkf_kf, slot_valid, desc_keys, T_world_ref)."""
    points, masks, descs, Ts, slot_valid, desc_keys, T_refs = _stack_many(
        [kfs], capacity)
    return (points[0], masks[0], {k: v[0] for k, v in descs.items()}, Ts[0],
            slot_valid[0], desc_keys, T_refs[0])


def _stack_many(kf_lists, capacity: int):
    """Stack several keyframe windows into ``[M, C, ...]`` inputs of
    :func:`build_cloud` (each window padded to ``capacity`` slots).
    Returns (points, masks, descs, T_refkf_kf, slot_valid, desc_keys,
    T_world_refs ``[M, 4, 4]`` host numpy)."""
    M, C = len(kf_lists), capacity
    kf0 = kf_lists[0][-1]
    ncap = kf0.cloud.capacity
    dev = kf0.cloud.device
    desc_keys = tuple(sorted(kf0.cloud.descriptors.keys()))
    zero_pts = torch.zeros((ncap, 3), device=dev)
    zero_mask = torch.zeros(ncap, dtype=torch.bool, device=dev)
    zero_desc = {k: torch.zeros((ncap, kf0.cloud.descriptors[k].shape[-1]),
                                device=dev) for k in desc_keys}
    pts_l, mask_l, Ts_l, valid_l, T_refs = [], [], [], [], []
    desc_l = {k: [] for k in desc_keys}
    for kfs in kf_lists:
        if len(kfs) > C:
            raise ValueError("a window holds more keyframes than slots")
        T_ref = np.asarray(kfs[-1].optimized_T_world_kf, np.float64)
        T_refs.append(T_ref.astype(np.float32))
        T_refkf_world = np.linalg.inv(T_ref)
        for kf in kfs:
            if kf.cloud.capacity != ncap:
                raise ValueError(
                    "compositions require equal keyframe cloud capacities")
            pts_l.append(kf.cloud.points)
            mask_l.append(kf.cloud.mask)
            for k in desc_keys:
                desc_l[k].append(kf.cloud.descriptors[k])
            Ts_l.append((T_refkf_world
                         @ np.asarray(kf.optimized_T_world_kf, np.float64)
                         ).astype(np.float32))
        for _ in range(C - len(kfs)):
            pts_l.append(zero_pts)
            mask_l.append(zero_mask)
            for k in desc_keys:
                desc_l[k].append(zero_desc[k])
            Ts_l.append(np.eye(4, dtype=np.float32))
        valid_l += [True] * len(kfs) + [False] * (C - len(kfs))
    points = torch.stack(pts_l).reshape(M, C, ncap, 3)
    masks = torch.stack(mask_l).reshape(M, C, ncap)
    descs = {k: torch.stack(v).reshape(M, C, ncap, -1)
             for k, v in desc_l.items()}
    Ts = torch.as_tensor(np.stack(Ts_l).reshape(M, C, 4, 4), device=dev)
    slot_valid = torch.as_tensor(np.asarray(valid_l).reshape(M, C),
                                 device=dev)
    return (points, masks, descs, Ts, slot_valid, desc_keys,
            np.stack(T_refs))


def stack_compositions(graph: PoseGraph, ids_list, capacity: int):
    """Stack M compositions' keyframe payloads into ``[M, C, ...]`` inputs
    of :func:`build_cloud` (``pgslam_tpu.localmap.stack_compositions``).
    Returns (points, masks, descs, T_refkf_kf, slot_valid, desc_keys,
    T_world_refs ``[M, 4, 4]`` host numpy)."""
    return _stack_many([[graph.keyframe(v) for v in ids] for ids in ids_list],
                       capacity)


def batch_rebuild(local_maps, pad_to: int = 0,
                  return_stacked: bool = False) -> Optional[Cloud]:
    """Rebuild several LocalMaps' clouds in one batched build (the fleet
    path). All maps share capacity, keyframe cloud capacity and
    descriptor keys. The batch is padded with copies of the first map to
    ``max(pad_to, next power of two)``; with ``return_stacked`` the
    padded batch ``[bucket, C*N, ...]`` is returned as one cloud."""
    if not local_maps:
        return None
    if len(local_maps) == 1 and pad_to <= 1 and not return_stacked:
        local_maps[0]._build_cloud()
        return None
    n = len(local_maps)
    bucket = max(pad_to, 1 << (n - 1).bit_length())
    lms = list(local_maps) + [local_maps[0]] * (bucket - n)
    C = local_maps[0]._capacity
    if any(lm._capacity != C for lm in lms):
        raise ValueError("batch_rebuild requires equal map capacities")
    points, masks, descs, Ts, slot_valid, desc_keys, _ = _stack_many(
        [[kf for _, kf in lm._data] for lm in lms], C)
    pts, mask, out_desc = build_cloud(points, masks, descs, Ts, slot_valid,
                                      desc_keys)
    for i, lm in enumerate(local_maps):
        lm._cloud = Cloud(points=pts[i], mask=mask[i],
                          descriptors={k: v[i] for k, v in out_desc.items()})
    if return_stacked:
        return Cloud(points=pts, mask=mask, descriptors=out_desc)
    return None


class LocalMap:
    """Sliding-window submap."""

    def __init__(self, capacity: int):
        self._capacity = int(capacity)
        self._data: List[Tuple[int, Keyframe]] = []
        self._cloud: Optional[Cloud] = None

    def update_to_new_composition(self, graph: PoseGraph,
                                  comp: Composition,
                                  build: bool = True) -> None:
        """Take the composition's snapshots; ``build=False`` leaves the
        cloud to a batched build (:func:`batch_rebuild`)."""
        self._capacity = comp.capacity
        self._data = [(v, graph.keyframe(v)) for v in comp]
        if build:
            self._build_cloud()

    def update_from_graph(self, graph: PoseGraph, build: bool = True) -> None:
        """Refresh payload snapshots for the current vertices."""
        self._data = [(v, graph.keyframe(v)) for v, _ in self._data]
        if build:
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
