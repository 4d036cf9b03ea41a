"""Localizer: input filtering, scan-to-local-map ICP, keyframe spawning
and local-map composition management. Counterpart of the classic per-scan
path of :mod:`pgslam_tpu.localizer` (``sync_lag=0``, ``micro_batch=0``,
no forced deferral): the same decision tree, the same overlap-probe
cache, and the same fp64 host re-anchoring.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from .cloud import Cloud, dequantize_cloud, transform_cloud
from .graph.pose_graph import MapManager
from .graph.shortest_path import dijkstra
from .localmap import Composition, LocalMap, build_cloud, stack_composition
from .ops import filters as F
from .ops.icp import (ICPConfig, ICPEngine, ICPResult, compute_overlap,
                      icp_core, to_host)

log = logging.getLogger("pgslam_tpu_torch.localizer")


def _orthonormalize(T: np.ndarray) -> np.ndarray:
    """Project the rotation block back onto SO(3) in fp64. Re-anchoring
    ``inv(kf) @ T_world`` squares any scale error in fp32 at every
    keyframe, so every anchor point goes through here."""
    U, _, Vt = np.linalg.svd(T[:3, :3].astype(np.float64))
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = (U * np.array([1.0, 1.0, -1.0])) @ Vt
    out = np.array(T, np.float32, copy=True)
    out[:3, :3] = R.astype(np.float32)
    return out


def _rigid_inverse(T: np.ndarray) -> np.ndarray:
    """fp64 inverse of a rigid 4x4 (R^T, -R^T t)."""
    T = np.asarray(T, np.float64)
    R = T[:3, :3]
    Tinv = np.eye(4, dtype=np.float64)
    Tinv[:3, :3] = R.T
    Tinv[:3, 3] = -R.T @ T[:3, 3]
    return Tinv


@dataclasses.dataclass(frozen=True)
class LocalizerConfig:
    """Same fields and defaults as ``pgslam_tpu.localizer.LocalizerConfig``.
    ``sync_lag``, ``force_deferred`` and ``micro_batch`` select the
    deferred and streaming paths, which are not ported yet."""
    local_map_size: int = 3
    overlap_threshold: float = 0.8
    minimal_overlap: float = 0.5
    input_filters: Tuple = ()
    icp: ICPConfig = ICPConfig()
    keyframe_cloud_capacity: int = 1024
    sync_lag: int = 0
    force_deferred: bool = False
    micro_batch: int = 0


def prepare_input(chain, capacity: int, cloud: Cloud,
                  T_robot_sensor: torch.Tensor) -> Cloud:
    """Input filters in the sensor frame, compaction to the keyframe
    capacity, then the sensor->robot transform."""
    cloud = F.apply_chain(chain, dequantize_cloud(cloud))
    return transform_cloud(T_robot_sensor, F.compact(cloud, capacity))


class Localizer:

    def __init__(self, map_manager: MapManager,
                 config: LocalizerConfig = LocalizerConfig(), device=None):
        if config.sync_lag > 0 or config.force_deferred \
                or config.micro_batch > 1:
            raise NotImplementedError(
                "the deferred (sync_lag / force_deferred) and streaming "
                "(micro_batch) localizer paths are not ported yet")
        self.mm = map_manager
        self.config = config
        self.device = torch.device(device or "cpu")
        self.icp_engine = ICPEngine(config.icp)
        self.local_map = LocalMap(config.local_map_size)
        self.next_composition = Composition(config.local_map_size)
        self.T_refkf_robot = np.eye(4, dtype=np.float32)
        self.T_world_robot = np.eye(4, dtype=np.float32)
        self.last_input_T_world_robot = np.eye(4, dtype=np.float32)
        self.count = 0
        self.input_cloud: Optional[Cloud] = None
        self.last_result: Optional[ICPResult] = None
        self._probe_cache: dict = {}

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # -- data entry --------------------------------------------------------

    def add_new_data(self, timestamp, world_frame_id, T_world_robot,
                     T_robot_sensor, cloud: Cloud) -> None:
        del timestamp, world_frame_id
        self.process_data(np.asarray(T_world_robot, np.float32),
                          np.asarray(T_robot_sensor, np.float32), cloud)

    def process_data(self, input_T_world_robot: np.ndarray,
                     input_T_robot_sensor: np.ndarray,
                     input_cloud: Cloud) -> None:
        log.info("[Localizer] Processing cloud #%d", self.count)
        self.count += 1
        cloud = prepare_input(self.config.input_filters,
                              self.config.keyframe_cloud_capacity,
                              input_cloud, self._tensor(input_T_robot_sensor))
        self.input_cloud = cloud
        if not self.local_map.has_cloud():
            self.process_first_cloud(cloud, input_T_world_robot)
            self.last_input_T_world_robot = np.asarray(input_T_world_robot,
                                                       np.float32)
            return
        # Odometry-predicted initial guess (host, fp64 increment).
        input_dT_robot = (
            np.linalg.inv(np.asarray(self.last_input_T_world_robot,
                                     np.float64))
            @ np.asarray(input_T_world_robot, np.float64)).astype(np.float32)
        input_T_refkf_robot = self.T_refkf_robot @ input_dT_robot
        # The neighbour probe's candidate is chosen from the predicted
        # pose and evaluated at the post-ICP pose, as the JAX package's
        # one-dispatch scan path does.
        T_world_refkf = np.asarray(
            self.local_map.reference_keyframe().optimized_T_world_kf,
            np.float32)
        probe_comp = self.neighbor_probe_request(
            T_world_robot=T_world_refkf @ input_T_refkf_robot)

        reading = self.icp_engine.prepare_reading(cloud)

        result = icp_core(reading, self.icp_engine.reference,
                          self._tensor(input_T_refkf_robot),
                          self.icp_engine.config)
        ov = None
        if probe_comp is not None:
            probe_map = self._cached_probe_map(probe_comp)
            T_world_robot = self._tensor(T_world_refkf) @ result.T
            ov = float(compute_overlap(reading, probe_map, T_world_robot,
                                       self.icp_engine.config))
        result = self.begin_finish(to_host(result))
        self.decide_composition(result, probe_comp, ov)
        self.apply_composition()
        self.last_input_T_world_robot = np.asarray(input_T_world_robot,
                                                   np.float32)

    def begin_finish(self, result: ICPResult) -> ICPResult:
        """Pose composition from a host-side ICP result."""
        self.last_result = result
        self.T_refkf_robot = _orthonormalize(np.asarray(result.T))
        self.T_world_robot = _orthonormalize(
            self.local_map.reference_keyframe().optimized_T_world_kf
            @ self.T_refkf_robot)
        return result

    def process_first_cloud(self, cloud: Cloud, T_world_robot) -> None:
        v = self.mm.add_first_keyframe(cloud, T_world_robot)
        self.next_composition.clear()
        self.next_composition.push_back(v)
        self.local_map.update_to_new_composition(self.mm.get_graph(),
                                                 self.next_composition)
        self.icp_engine.set_map(self.local_map.cloud())
        self.T_refkf_robot = np.eye(4, dtype=np.float32)
        self.T_world_robot = np.asarray(T_world_robot, np.float32)

    # -- post-ICP decision tree --------------------------------------------

    def neighbor_probe_request(self, T_world_robot=None):
        """The neighbour composition that needs an overlap probe, or None."""
        comp, found = self.find_neighbor_local_map_composition(
            T_world_robot=T_world_robot)
        if not found or self.local_map.has_same_composition(comp):
            return None
        return comp

    def decide_composition(self, result: ICPResult, comp, probe_ov) -> None:
        """The post-ICP decision tree, given the neighbour composition and
        its probe overlap (both None when there is no candidate)."""
        overlap = float(result.overlap)
        log.info("[Localizer] current overlap = %.4f", overlap)
        is_better = (comp is not None and self.is_overlap_enough(probe_ov)
                     and probe_ov > overlap)
        if self.is_overlap_enough(overlap):
            if is_better:
                self.next_composition = comp
            else:
                # Re-reference the local map on the closest vertex.
                closest_v = self.local_map.find_closest_vertex(
                    self.T_world_robot)
                ref_v = self.local_map.reference_vertex()
                if closest_v != ref_v:
                    cur = self.local_map.get_composition()
                    items = cur.as_list()
                    i, j = items.index(closest_v), items.index(ref_v)
                    items[i], items[j] = items[j], items[i]
                    self.next_composition = Composition(cur.capacity, items)
        elif is_better:
            self.next_composition = comp
        else:
            # Spawn a keyframe; this cascades synchronously into the loop
            # closer and possibly the optimizer before returning.
            v = self.mm.add_new_keyframe(
                self.local_map.reference_vertex(), self.T_world_robot,
                self.T_refkf_robot, np.asarray(result.cov), self.input_cloud)
            self.next_composition.push_back(v)
            log.info("[Localizer] next composition = %s",
                     self.next_composition)

    def apply_composition(self) -> bool:
        """Rebuild the local map if the composition changed."""
        if self.local_map.has_same_composition(self.next_composition):
            return False
        old_ref = self.local_map.reference_vertex()
        self.local_map.update_to_new_composition(self.mm.get_graph(),
                                                 self.next_composition)
        if self.local_map.reference_vertex() != old_ref:
            self.update_refkf_robot_pose()
        self.icp_engine.set_map(self.local_map.cloud())
        return True

    def update_refkf_robot_pose(self) -> None:
        Tinv = _rigid_inverse(
            self.local_map.reference_keyframe().optimized_T_world_kf)
        self.T_refkf_robot = _orthonormalize(
            (Tinv @ np.asarray(self.T_world_robot, np.float64)
             ).astype(np.float32))

    def update_world_robot_pose(self) -> None:
        self.T_world_robot = _orthonormalize(
            self.local_map.reference_keyframe().optimized_T_world_kf
            @ self.T_refkf_robot)

    # -- graph-update notification -----------------------------------------

    def update_from_graph(self) -> None:
        """Post-optimization resync: rebuild an outdated local map and
        re-anchor the world pose on a moved reference keyframe."""
        if not self.local_map.has_cloud():
            return
        graph = self.mm.get_graph()
        lm_outdated = self.local_map.is_outdated(graph)
        ref_outdated = self.local_map.is_reference_keyframe_outdated(graph)
        if lm_outdated:
            self.local_map.update_from_graph(graph)
            self.icp_engine.set_map(self.local_map.cloud())
        if ref_outdated:
            self.update_world_robot_pose()

    # -- overlap logic -----------------------------------------------------

    def is_overlap_enough(self, overlap: float) -> bool:
        if overlap < self.config.minimal_overlap:
            log.warning("[Localizer] overlap below minimal overlap! "
                        "(%.3f < %.3f)", overlap, self.config.minimal_overlap)
        return overlap >= self.config.overlap_threshold

    def _cached_probe_map(self, comp: Composition) -> Cloud:
        """The candidate map in the world frame after the reference
        filters, cached per (composition, member update times)."""
        graph = self.mm.get_graph()
        key = tuple(comp.as_list())
        times = tuple(int(graph.update_times[v]) for v in key)
        hit = self._probe_cache.get(key)
        if hit is not None and hit[0] == times:
            return hit[1]
        points, masks, descs, Ts, slot_valid, desc_keys, T_world_ref = \
            stack_composition(graph, comp.as_list(), comp.capacity)
        pts, mask, desc = build_cloud(points, masks, descs, Ts, slot_valid,
                                      desc_keys)
        world = transform_cloud(self._tensor(T_world_ref),
                                Cloud(points=pts, mask=mask,
                                      descriptors=desc))
        world = F.apply_chain(self.config.icp.reference_filters, world)
        if len(self._probe_cache) >= 8:
            self._probe_cache.pop(next(iter(self._probe_cache)))
        self._probe_cache[key] = (times, world)
        return world

    # -- neighbour-composition search --------------------------------------

    def find_neighbor_local_map_composition(
            self, T_world_robot=None) -> Tuple[Optional[Composition], bool]:
        graph = self.mm.get_graph()
        curr = self.local_map.get_composition().as_list()
        if T_world_robot is None:
            T_world_robot = self.T_world_robot
        adj = set()
        for v in curr:
            for a in graph.adjacent_vertices(v):
                if int(a) not in curr:
                    adj.add(int(a))
        if not adj:
            return None, False
        adj = sorted(adj)
        robot_t = np.asarray(T_world_robot)[:3, 3]
        dists = np.linalg.norm(
            graph.optimized_poses[np.asarray(adj)][:, :3, 3] - robot_t,
            axis=1)
        closest_adj = adj[int(np.argmin(dists))]
        ext = curr + [closest_adj]
        vertex_ok = np.zeros(graph.n_vertices, bool)
        vertex_ok[np.asarray(ext)] = True
        e = graph.n_edges
        topo, _ = dijkstra(graph.n_vertices, graph.edge_from[:e],
                           graph.edge_to[:e], graph.edge_weight[:e],
                           closest_adj, vertex_ok=vertex_ok)
        # Decreasing topological distance; the two nearest go last with
        # the one closest to the robot at the back (reference keyframe).
        ext.sort(key=lambda v: topo[v], reverse=True)
        comp = Composition(self.local_map.capacity())
        for v in ext[:-2]:
            comp.push_back(v)
        last, before_last = ext[-1], ext[-2]
        d_last = float(np.linalg.norm(
            graph.optimized_poses[last][:3, 3] - robot_t))
        d_before = float(np.linalg.norm(
            graph.optimized_poses[before_last][:3, 3] - robot_t))
        if d_before < d_last:
            comp.push_back(last)
            comp.push_back(before_last)
        else:
            comp.push_back(before_last)
            comp.push_back(last)
        return comp, True

    # -- map access --------------------------------------------------------

    def get_local_map(self) -> Tuple[Optional[Cloud], bool]:
        if self.local_map.has_cloud():
            return self.local_map.cloud(), True
        return None, False

    def get_local_map_in_world_frame(self) -> Tuple[Optional[Cloud], bool]:
        if self.local_map.has_cloud():
            return self.local_map.cloud_in_world_frame(), True
        return None, False
