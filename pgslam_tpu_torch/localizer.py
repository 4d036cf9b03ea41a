"""Localizer: input filtering, scan-to-local-map ICP, keyframe spawning
and local-map composition management. Counterpart of the classic per-scan
path of :mod:`pgslam_tpu.localizer` (``sync_lag=0``, ``micro_batch=0``,
no forced deferral): the same decision tree, the same overlap-probe
cache, and the same fp64 host re-anchoring. The fleet
(:class:`~pgslam_tpu_torch.parallel.multi_agent.MultiAgentSlam`) drives
the split entry points instead: :meth:`Localizer.prepare_scan`,
:meth:`Localizer.begin_finish`, :meth:`Localizer.decide_composition`,
``apply_composition(build=False)`` and the deferred graph resync.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from .cloud import Cloud, dequantize_cloud, transform_cloud
from .devices import resolve_device
from .graph.pose_graph import MapManager
from .graph.shortest_path import dijkstra
from .localmap import Composition, LocalMap, build_cloud, stack_compositions
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


def prepare_input_batched(chain, capacity: int, clouds, T_robot_sensors,
                          reading_chain=()):
    """A fleet's input preparation (``_prepare_input_batched``): per agent
    :func:`prepare_input`, then the reading filter chain. Returns the
    prepared clouds and readings, one each per agent."""
    prepped = [prepare_input(chain, capacity, c, T)
               for c, T in zip(clouds, T_robot_sensors)]
    return prepped, [F.apply_chain(reading_chain, c) for c in prepped]


def probe_build_batched(points, masks, descs, Ts, slot_valid, desc_keys,
                        T_world_refs, ref_chain):
    """Candidate maps of the overlap probe for a batch of compositions
    (stacked by :func:`localmap.stack_compositions`): one batched build,
    then per map the move to the world frame and the reference filter
    chain."""
    pts, mask, desc = build_cloud(points, masks, descs, Ts, slot_valid,
                                  desc_keys)
    T = torch.as_tensor(np.asarray(T_world_refs, np.float32),
                        device=pts.device)
    worlds = transform_cloud(T, Cloud(points=pts, mask=mask,
                                      descriptors=desc))
    return [F.apply_chain(ref_chain, worlds.map(lambda a: a[i]))
            for i in range(pts.shape[0])]


def probe_overlap_from_batched(readings, worlds, T_world_robots,
                               cfg: ICPConfig) -> torch.Tensor:
    """Overlap of each reading against its pre-built candidate map at its
    world pose (``_probe_overlap_from_batched``)."""
    return torch.stack([compute_overlap(r, w, T, cfg) for r, w, T
                        in zip(readings, worlds, T_world_robots)])


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
        self.device = resolve_device(device)
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
        # The scan's prepared reading, reused by the overlap probe.
        self._last_reading: Optional[Cloud] = None
        # Fleet mode: an optimization writeback only flags the resync
        # (the MT variant's outdated flag); the fleet runs it, batched,
        # at its next step.
        self.defer_graph_resync = False
        self._needs_resync = False

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
        prep = self.prepare_scan(input_T_world_robot, input_T_robot_sensor,
                                 input_cloud)
        if prep is None:
            return
        reading, input_T_refkf_robot = prep
        # The neighbour probe's candidate is chosen from the predicted
        # pose and evaluated at the post-ICP pose, as the JAX package's
        # one-dispatch scan path does.
        T_world_refkf = np.asarray(
            self.local_map.reference_keyframe().optimized_T_world_kf,
            np.float32)
        probe_comp = self.neighbor_probe_request(
            T_world_robot=T_world_refkf @ input_T_refkf_robot)

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

    def prepare_scan(self, input_T_world_robot, input_T_robot_sensor,
                     input_cloud: Cloud, prepared: Optional[Cloud] = None,
                     reading: Optional[Cloud] = None):
        """Everything before the registration (the per-scan path's, and a
        batcher's that registers many agents at once). Returns (reading,
        odometry-predicted initial transform as host float32) or None when
        this was the first cloud (fully handled). ``prepared`` and
        ``reading`` carry the batcher's input preparation and reading
        filters."""
        log.info("[Localizer] Processing cloud #%d", self.count)
        self.count += 1
        cloud = prepared if prepared is not None else prepare_input(
            self.config.input_filters, self.config.keyframe_cloud_capacity,
            input_cloud, self._tensor(input_T_robot_sensor))
        self.input_cloud = cloud
        if not self.local_map.has_cloud():
            self.process_first_cloud(cloud, input_T_world_robot)
            self.last_input_T_world_robot = np.asarray(input_T_world_robot,
                                                       np.float32)
            return None
        # Odometry-predicted initial guess (host, fp64 increment).
        input_dT_robot = (
            np.linalg.inv(np.asarray(self.last_input_T_world_robot,
                                     np.float64))
            @ np.asarray(input_T_world_robot, np.float64)).astype(np.float32)
        input_T_refkf_robot = self.T_refkf_robot @ input_dT_robot
        if reading is None:
            reading = self.icp_engine.prepare_reading(cloud)
        self._last_reading = reading
        return reading, input_T_refkf_robot

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

    def apply_composition(self, build: bool = True) -> bool:
        """Rebuild the local map if the composition changed. With
        ``build=False`` only the snapshots are taken and the pose
        re-anchored; the caller builds the cloud (batched) and then runs
        :meth:`finish_apply`."""
        if self.local_map.has_same_composition(self.next_composition):
            return False
        old_ref = self.local_map.reference_vertex()
        self.local_map.update_to_new_composition(
            self.mm.get_graph(), self.next_composition, build=build)
        if self.local_map.reference_vertex() != old_ref:
            self.update_refkf_robot_pose()
        if build:
            self.finish_apply()
        return True

    def finish_apply(self) -> None:
        """Install the (re)built local-map cloud as the ICP reference."""
        self.icp_engine.set_map(self.local_map.cloud())

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
        """Post-optimization notification: resync now, or flag it for the
        fleet's next step (``defer_graph_resync``)."""
        if self.defer_graph_resync:
            self._needs_resync = True
            return
        self.resync_from_graph()

    def resync_from_graph(self, build: bool = True) -> bool:
        """Rebuild an outdated local map and re-anchor the world pose on a
        moved reference keyframe. Returns whether the local map is
        outdated; with ``build=False`` only its snapshots are refreshed
        and the caller builds it (batched)."""
        self._needs_resync = False
        if not self.local_map.has_cloud():
            return False
        graph = self.mm.get_graph()
        lm_outdated = self.local_map.is_outdated(graph)
        ref_outdated = self.local_map.is_reference_keyframe_outdated(graph)
        if lm_outdated:
            self.local_map.update_from_graph(graph, build=build)
            if build:
                self.finish_apply()
        if ref_outdated:
            self.update_world_robot_pose()
        return lm_outdated

    # -- overlap logic -----------------------------------------------------

    def is_overlap_enough(self, overlap: float) -> bool:
        if overlap < self.config.minimal_overlap:
            log.warning("[Localizer] overlap below minimal overlap! "
                        "(%.3f < %.3f)", overlap, self.config.minimal_overlap)
        return overlap >= self.config.overlap_threshold

    def _cached_probe_map(self, comp: Composition) -> Cloud:
        """The candidate map in the world frame after the reference
        filters, cached per (composition, member update times)."""
        world = self._probe_cache_get(comp)
        if world is None:
            world = probe_build_batched(
                *stack_compositions(self.mm.get_graph(), [comp.as_list()],
                                    comp.capacity),
                self.config.icp.reference_filters)[0]
            self._probe_cache_put(comp, world)
        return world

    def _probe_key(self, comp: Composition):
        graph = self.mm.get_graph()
        key = tuple(comp.as_list())
        return key, tuple(int(graph.update_times[v]) for v in key)

    def _probe_cache_get(self, comp: Composition) -> Optional[Cloud]:
        """The cached candidate map, or None (the fleet builds every miss
        in one batched build)."""
        key, times = self._probe_key(comp)
        hit = self._probe_cache.get(key)
        if hit is not None and hit[0] == times:
            return hit[1]
        return None

    def _probe_cache_put(self, comp: Composition, world: Cloud) -> None:
        key, times = self._probe_key(comp)
        if len(self._probe_cache) >= 8:
            self._probe_cache.pop(next(iter(self._probe_cache)))
        self._probe_cache[key] = (times, world)

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
