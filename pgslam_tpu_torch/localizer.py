"""Localizer: input filtering, scan-to-local-map ICP, keyframe spawning
and local-map composition management. Counterpart of
:mod:`pgslam_tpu.localizer`: the same decision tree, the same overlap-probe
cache, the same fp64 host re-anchoring, and its three scan paths:

* classic (``sync_lag=0``): each scan's result, with the overlap probe
  riding in it, is packed into one vector, fetched once and committed
  before the next scan;
* under ``PGSLAM_FUSED_SINGLE=1`` an eligible config registers each scan
  of the classic and deferred paths in K2 at a batch of one instead of
  ``icp_core`` (on the card only; :func:`single_route`);
* deferred (``sync_lag > 0``, or ``force_deferred`` at any lag): a scan
  is dispatched at once with an odometry-extrapolated guess and
  committed ``sync_lag`` scans later;
* streaming (``micro_batch > 1``): scans are buffered and ``micro_batch``
  of them register against the one local map in one batch (one K2
  launch on the card), then commit as deferred scans.

The fleet (:class:`~pgslam_tpu_torch.parallel.multi_agent.MultiAgentSlam`)
drives the split entry points instead: :meth:`Localizer.prepare_scan`,
:meth:`Localizer.begin_finish`, :meth:`Localizer.decide_composition`,
``apply_composition(build=False)`` and the deferred graph resync.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cloud import (Cloud, dequantize_cloud, pad_cloud, stack_clouds,
                    transform_cloud, unbind_cloud)
from .devices import resolve_device
from .graph.pose_graph import MapManager
from .graph.shortest_path import dijkstra
from .localmap import Composition, LocalMap, build_cloud, stack_compositions
from .ops import filters as F
from .ops.icp import (HostFetch, ICPConfig, ICPEngine, ICPResult,
                      compute_overlap, icp_core, pack_result, unpack_result)
from .parallel.batched import batched_register, fused_ready, register_one
from .utils import timing

log = logging.getLogger("pgslam_tpu_torch.localizer")

# The reference's opt-in (pgslam_tpu/localizer.py:45): "1" registers each
# scan of an eligible config in K2 at a batch of one. Read once, off by
# default.
FUSED_SINGLE = os.environ.get("PGSLAM_FUSED_SINGLE", "0") == "1"
# The devices the single-scan route runs on. The reference never takes it
# on the CPU backend; a test adds "cpu" to run K2's plain version.
FUSED_SINGLE_DEVICES = ("cuda",)


def single_route(cfg: ICPConfig, reference: Cloud,
                 device: torch.device) -> bool:
    """Whether a scan registers in K2 at a batch of one: the switch is on,
    the device is one of ``FUSED_SINGLE_DEVICES``, and K2 covers the
    registration (``fused_ready``: an eligible config, reference normals
    for point-to-plane). No fallback follows: a K2 that fails to build or
    launch fails the scan."""
    return (FUSED_SINGLE and device.type in FUSED_SINGLE_DEVICES
            and fused_ready(cfg, reference))


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
    ``sync_lag`` k > 0 commits each scan k scans after its dispatch;
    ``force_deferred`` takes the deferred path at any lag (at lag 0 it
    gives the classic path's bits); ``micro_batch`` B > 1 registers B
    buffered scans in one batch (0 and 1 are the classic path)."""
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
                  T_robot_sensor: torch.Tensor, seed: int = 0) -> Cloud:
    """Input filters in the sensor frame (their draws seeded by ``seed``,
    the scan's count), compaction to the keyframe capacity, then the
    sensor->robot transform."""
    cloud = F.apply_chain(chain, dequantize_cloud(cloud), seed)
    return transform_cloud(T_robot_sensor, F.compact(cloud, capacity))


def _own(cloud: Cloud) -> Cloud:
    """A keyframe's copy of its cloud: a batch's prepared cloud is a view
    of the whole batch, which the graph would otherwise keep alive."""
    return cloud.map(torch.clone)


class PreparedBatch(NamedTuple):
    """A batch's input preparation: each scan's prepared cloud and
    reading, and the readings as one ``[B, ...]`` cloud when they are
    views of one (else None)."""
    clouds: List[Cloud]
    readings: List[Cloud]
    reading_batch: Optional[Cloud]


def prepare_input_batched(chain, capacity: int, raw: Cloud,
                          T_robot_sensors: torch.Tensor, reading_chain=(),
                          seeds=None) -> PreparedBatch:
    """A batch's input preparation (``_prepare_input_batched``) with each
    scan's :func:`prepare_input` under its seed (its scan count; 0 when
    ``seeds`` is None), then the reading filter chain. ``raw`` is the
    scans as one ``[B, N]`` cloud, ``T_robot_sensors`` ``[B, 4, 4]``.

    Dequantization, compaction and transform run once over the batch. A
    non-empty input chain runs on each scan's slice under its own seed,
    its outputs padded to the largest capacity (padding compacts away).
    An empty reading chain makes the readings the prepared clouds."""
    seeds = [0] * raw.points.shape[0] if seeds is None else seeds
    batch = dequantize_cloud(raw)
    if chain:
        outs = [F.apply_chain(chain, c, seed)
                for c, seed in zip(unbind_cloud(batch), seeds)]
        top = max(c.capacity for c in outs)
        batch = stack_clouds([pad_cloud(c, top) for c in outs])
    prepared = transform_cloud(T_robot_sensors,
                               F.compact_batched(batch, capacity))
    prepped = unbind_cloud(prepared)
    if reading_chain:
        readings = [F.apply_chain(reading_chain, c) for c in prepped]
        return PreparedBatch(prepped, readings, None)
    return PreparedBatch(prepped, prepped, prepared)


def probe_build_batched(points, masks, descs, Ts, slot_valid, desc_keys,
                        T_world_refs, ref_chain):
    """Candidate maps of the overlap probe for a batch of compositions
    (stacked by :func:`localmap.stack_compositions`): one batched build,
    then per map the move to the world frame and the reference filter
    chain."""
    pts, mask, desc = build_cloud(points, masks, descs, Ts, slot_valid,
                                  desc_keys)
    with timing.wait("localmap.upload"):
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


def prepare_register_stream(chain, capacity: int, cfg: ICPConfig, clouds,
                            T_robot_sensors, reference: Cloud,
                            T0s: torch.Tensor, seeds=None):
    """The streaming path's batch (``_prepare_register_stream``): each
    scan's input preparation and reading filters, then one
    :func:`batched_register` of all B readings against B copies of the
    one local map (one K2 launch on the card; the kernel takes contiguous
    tensors, so the copies are materialized). Returns the prepared
    clouds, the readings and the packed results ``[B, 59]``."""
    prep = prepare_input_batched(chain, capacity, stack_clouds(clouds),
                                 torch.stack(list(T_robot_sensors)),
                                 cfg.reading_filters, seeds)
    B = len(prep.clouds)
    refs = reference.map(lambda a: a[None].expand(B, *a.shape).contiguous())
    readings = (prep.reading_batch if prep.reading_batch is not None
                else stack_clouds(prep.readings))
    result = batched_register(readings, refs, T0s, cfg)
    return prep.clouds, prep.readings, pack_result(result)


@dataclasses.dataclass
class _Inflight:
    """A dispatched scan whose result is not committed yet."""
    fetch: HostFetch           # its packed result on the way to the host
    row: Optional[int]         # its row in a streamed batch's fetch
    cloud: Cloud               # prepared input cloud
    reading: Cloud             # filtered reading
    # The reference keyframe result.T is relative to. A stale commit
    # composes with this vertex's pose at commit time: with the pose at
    # dispatch an optimizer writeback landing in between is lost (2.4x
    # the classic path's drift, pgslam_tpu/localizer.py:427-437).
    refkf_vertex: int
    probe_comp: Optional[Composition]
    odom_pose: np.ndarray      # the scan's odometry world pose
    comp_items: Tuple[int, ...]  # composition registered against
    # The reference keyframe's optimized pose at dispatch: a commit that
    # finds it, the vertex and the composition unchanged is fresh and
    # takes the classic pose composition.
    refkf_pose_at_dispatch: np.ndarray

    def result(self) -> Tuple[ICPResult, Optional[float]]:
        vec = self.fetch.get()
        return unpack_result(vec if self.row is None else vec[self.row])


class Localizer:

    def __init__(self, map_manager: MapManager,
                 config: LocalizerConfig = LocalizerConfig(), device=None):
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
        # Dispatched scans not committed yet, oldest first; the odometry
        # pose of the last committed scan (the base of the extrapolated
        # guesses across the gap); the streaming path's buffered scans.
        self._inflight: "collections.deque[_Inflight]" = collections.deque()
        self._committed_odom = np.eye(4, dtype=np.float32)
        self._microbuf: list = []

    def _tensor(self, a) -> torch.Tensor:
        with timing.wait("localizer.upload"):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

    # -- configuration setters ---------------------------------------------

    def set_local_map_max_size(self, size: int) -> None:
        self.local_map = LocalMap(size)
        self.next_composition = Composition(size)

    def set_overlap_threshold(self, v: float) -> None:
        self.config = dataclasses.replace(self.config, overlap_threshold=v)

    def set_minimal_overlap_threshold(self, v: float) -> None:
        self.config = dataclasses.replace(self.config, minimal_overlap=v)

    def set_icp_config(self, path: str) -> None:
        """Load an ICP YAML; a live local map is installed in the new
        engine."""
        from .config import load_icp_config
        icp = load_icp_config(path)
        self.config = dataclasses.replace(self.config, icp=icp)
        self.icp_engine = ICPEngine(icp)
        if self.local_map.has_cloud():
            self.icp_engine.set_map(self.local_map.cloud())

    def set_input_filters_config(self, path: str) -> None:
        """Load the input filter chain from a YAML list."""
        from .config import load_input_filters
        self.config = dataclasses.replace(
            self.config, input_filters=load_input_filters(path))

    # -- data entry --------------------------------------------------------

    def add_new_data(self, timestamp, world_frame_id, T_world_robot,
                     T_robot_sensor, cloud: Cloud) -> None:
        del timestamp, world_frame_id
        self.process_data(np.asarray(T_world_robot, np.float32),
                          np.asarray(T_robot_sensor, np.float32), cloud)

    @timing.spanned("pgslam.frontend")
    def process_data(self, input_T_world_robot: np.ndarray,
                     input_T_robot_sensor: np.ndarray,
                     input_cloud: Cloud) -> None:
        odom = np.asarray(input_T_world_robot, np.float32)
        T_rs = np.asarray(input_T_robot_sensor, np.float32)
        if not self.local_map.has_cloud():
            # The first cloud: prepare_scan bootstraps the map.
            self.prepare_scan(odom, T_rs, input_cloud)
            self._committed_odom = odom
            return
        if self.config.micro_batch > 1:
            return self._process_data_stream(odom, T_rs, input_cloud)
        deferred = self.config.sync_lag > 0 or self.config.force_deferred
        log.info("[Localizer] Processing cloud #%d%s", self.count,
                 " (deferred)" if deferred else "")
        self.count += 1
        if deferred and self._inflight:
            T0, T_world_refkf, T_pred = self._extrapolated_guess(odom)
        else:
            # Fresh: the classic guess and probe pose, the very float
            # operations of prepare_scan, so that the deferred path at
            # lag 0 gives the classic path's bits.
            T0 = self._odometry_guess(odom)
            T_world_refkf, T_pred = self._probe_pose(T0)
        inflight = self._dispatch(odom, T_rs, input_cloud, T0,
                                  T_world_refkf, T_pred)
        self.last_input_T_world_robot = odom
        # Deferred loop-closure verifications of an earlier spawn commit
        # here, behind this scan's dispatch.
        self.mm.drain_loop_closer()
        if not deferred:
            self._commit(inflight, fresh=True)
            return
        self._inflight.append(inflight)
        while len(self._inflight) > self.config.sync_lag:
            self._commit(self._inflight.popleft())

    def _odometry_guess(self, input_T_world_robot) -> np.ndarray:
        """The classic initial guess relative to the reference keyframe:
        the odometry increment since the last scan (fp64) after the
        current relative pose."""
        input_dT_robot = (
            np.linalg.inv(np.asarray(self.last_input_T_world_robot,
                                     np.float64))
            @ np.asarray(input_T_world_robot, np.float64)).astype(np.float32)
        return self.T_refkf_robot @ input_dT_robot

    def _probe_pose(self, T0: np.ndarray):
        """(reference keyframe world pose, predicted world pose) in fp32:
        the overlap probe's candidate is chosen at the predicted pose and
        evaluated at the post-ICP one, as the JAX package's one-dispatch
        scan path does."""
        T_world_refkf = np.asarray(
            self.local_map.reference_keyframe().optimized_T_world_kf,
            np.float32)
        return T_world_refkf, T_world_refkf @ T0

    def _extrapolated_guess(self, input_T_world_robot):
        """With scans in flight: the last committed world pose after the
        odometry increment since the last committed scan (the in-flight
        scans' ICP corrections are what deferral gives up). Returns (T0,
        reference keyframe pose, predicted pose)."""
        T_pred = (np.asarray(self.T_world_robot, np.float64)
                  @ np.linalg.inv(np.asarray(self._committed_odom,
                                             np.float64))
                  @ np.asarray(input_T_world_robot, np.float64))
        T_world_refkf = np.asarray(
            self.local_map.reference_keyframe().optimized_T_world_kf,
            np.float64)
        T0 = _orthonormalize((_rigid_inverse(T_world_refkf) @ T_pred)
                             .astype(np.float32))
        return (T0, T_world_refkf.astype(np.float32),
                T_pred.astype(np.float32))

    def _dispatch(self, odom, T_rs, input_cloud: Cloud, T0, T_world_refkf,
                  T_pred) -> _Inflight:
        """Input preparation, the registration from ``T0`` and the
        neighbour probe at the post-ICP pose; the packed result's copy to
        the host is started, nothing waits for it."""
        with timing.span("pgslam.frontend.filters"):
            cloud = prepare_input(self.config.input_filters,
                                  self.config.keyframe_cloud_capacity,
                                  input_cloud, self._tensor(T_rs),
                                  self.count - 1)
            reading = self.icp_engine.prepare_reading(cloud)
        probe_comp = self.neighbor_probe_request(T_world_robot=T_pred)
        cfg, ref = self.icp_engine.config, self.icp_engine.reference
        with timing.span("pgslam.frontend.icp"):
            if single_route(cfg, ref, self.device):
                result = register_one(reading, ref, self._tensor(T0), cfg)
            else:
                result = icp_core(reading, ref, self._tensor(T0), cfg,
                                  self.icp_engine.index)
        ov = None
        if probe_comp is not None:
            ov = compute_overlap(reading, self._cached_probe_map(probe_comp),
                                 self._tensor(T_world_refkf) @ result.T,
                                 self.icp_engine.config)
        return self._record(HostFetch(pack_result(result, ov)), None,
                            cloud, reading, probe_comp, odom)

    def _record(self, fetch, row, cloud, reading, probe_comp,
                odom) -> _Inflight:
        return _Inflight(
            fetch=fetch, row=row, cloud=cloud, reading=reading,
            refkf_vertex=self.local_map.reference_vertex(),
            probe_comp=probe_comp, odom_pose=odom,
            comp_items=tuple(self.local_map.get_composition().as_list()),
            refkf_pose_at_dispatch=np.array(
                self.local_map.reference_keyframe().optimized_T_world_kf,
                np.float32, copy=True))

    def _commit(self, inflight: _Inflight, fresh: Optional[bool] = None
                ) -> None:
        """Consume one dispatched scan: its packed result, the pose state
        and the decision tree. ``fresh`` (nothing landed since dispatch)
        is found from the record unless the caller knows it."""
        result, ov = inflight.result()
        comp_unchanged = inflight.comp_items == tuple(
            self.local_map.get_composition().as_list())
        if fresh is None:
            fresh = (comp_unchanged
                     and inflight.refkf_vertex
                     == self.local_map.reference_vertex()
                     and np.array_equal(
                         inflight.refkf_pose_at_dispatch,
                         np.asarray(self.local_map.reference_keyframe()
                                    .optimized_T_world_kf, np.float32)))
        if fresh:
            self.begin_finish(result)
        else:
            # result.T is relative to the reference keyframe at dispatch:
            # compose with that vertex's pose now, then re-anchor on the
            # current reference keyframe.
            self.last_result = result
            T_ref_now = np.asarray(
                self.mm.get_graph().optimized_poses[inflight.refkf_vertex],
                np.float64)
            self.T_world_robot = _orthonormalize(
                (T_ref_now @ np.asarray(result.T, np.float64))
                .astype(np.float32))
            self.update_refkf_robot_pose()
        self.input_cloud = inflight.cloud
        self._last_reading = inflight.reading
        self._committed_odom = inflight.odom_pose
        if not comp_unchanged:
            # The scan's overlap was measured against the composition
            # before an earlier commit changed it: acting on it would
            # spawn keyframes one scan apart. The scan only localizes.
            log.info("[Localizer] deferred commit against a stale "
                     "composition: decision muted")
            return
        self.decide_composition(result, inflight.probe_comp, ov)
        self.apply_composition()

    # -- streaming path (micro_batch > 1) ------------------------------------

    def _process_data_stream(self, odom, T_rs, input_cloud: Cloud) -> None:
        """Buffer the scan; at ``micro_batch`` scans register them in one
        batch and hand them to the deferred commits (a commit lags up to
        ``micro_batch + sync_lag`` scans)."""
        log.info("[Localizer] Buffering cloud #%d (stream)", self.count)
        self._microbuf.append((odom, T_rs, input_cloud, self.count))
        self.count += 1
        self.last_input_T_world_robot = odom
        if len(self._microbuf) >= self.config.micro_batch:
            self._flush_microbatch()

    def _flush_microbatch(self) -> None:
        buf, self._microbuf = self._microbuf, []
        if not buf:
            return
        n = len(buf)
        buf_p = buf + [buf[-1]] * (self.config.micro_batch - n)
        # Every scan's guess extrapolates the odometry from the last
        # committed pose against the one reference keyframe snapshot.
        Tinv = _rigid_inverse(
            self.local_map.reference_keyframe().optimized_T_world_kf)
        base = (np.asarray(self.T_world_robot, np.float64)
                @ np.linalg.inv(np.asarray(self._committed_odom,
                                           np.float64)))
        T0s = np.stack([_orthonormalize(
            (Tinv @ base @ np.asarray(o, np.float64)).astype(np.float32))
            for o, _, _, _ in buf_p])
        clouds, readings, packed = prepare_register_stream(
            self.config.input_filters, self.config.keyframe_cloud_capacity,
            self.icp_engine.config, [c for _, _, c, _ in buf_p],
            [self._tensor(t) for _, t, _, _ in buf_p],
            self.icp_engine.reference, self._tensor(T0s),
            seeds=[n for _, _, _, n in buf_p])
        fetch = HostFetch(packed)
        # The speculative neighbour probe is skipped in this mode.
        for j in range(n):
            self._inflight.append(self._record(fetch, j, clouds[j],
                                               readings[j], None, buf[j][0]))
        self.mm.drain_loop_closer()
        while len(self._inflight) > self.config.sync_lag:
            self._commit(self._inflight.popleft())

    def flush(self) -> None:
        """Commit every buffered and in-flight scan and every deferred
        loop-closure verification. The facade's accessors call it."""
        if self._microbuf:
            self._flush_microbatch()
        while self._inflight:
            self._commit(self._inflight.popleft())
            self.mm.drain_loop_closer()
        self.mm.drain_loop_closer()

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
        cloud = prepared
        if cloud is None:
            with timing.span("pgslam.frontend.filters"):
                cloud = prepare_input(
                    self.config.input_filters,
                    self.config.keyframe_cloud_capacity, input_cloud,
                    self._tensor(input_T_robot_sensor), self.count - 1)
        self.input_cloud = cloud
        if not self.local_map.has_cloud():
            self.process_first_cloud(cloud, input_T_world_robot)
            self.last_input_T_world_robot = np.asarray(input_T_world_robot,
                                                       np.float32)
            return None
        input_T_refkf_robot = self._odometry_guess(input_T_world_robot)
        if reading is None:
            with timing.span("pgslam.frontend.filters"):
                reading = self.icp_engine.prepare_reading(cloud)
        self._last_reading = reading
        return reading, input_T_refkf_robot

    def finish_scan(self, result: ICPResult, input_T_world_robot) -> None:
        """Everything after a registration: the pose composition, then the
        decision tree with its overlap probe (:meth:`update_after_icp`)."""
        self.update_after_icp(self.begin_finish(result))
        self.last_input_T_world_robot = np.asarray(input_T_world_robot,
                                                   np.float32)

    def begin_finish(self, result: ICPResult) -> ICPResult:
        """Pose composition from an ICP result (on the device or the
        host); returns it on the host."""
        if isinstance(result.T, torch.Tensor):
            with timing.wait("localizer.fetch"):
                vec = pack_result(result).cpu()
            result, _ = unpack_result(vec)
        self.last_result = result
        self.T_refkf_robot = _orthonormalize(np.asarray(result.T))
        self.T_world_robot = _orthonormalize(
            self.local_map.reference_keyframe().optimized_T_world_kf
            @ self.T_refkf_robot)
        return result

    def process_first_cloud(self, cloud: Cloud, T_world_robot) -> None:
        v = self.mm.add_first_keyframe(_own(cloud), T_world_robot)
        self.next_composition.clear()
        self.next_composition.push_back(v)
        self.local_map.update_to_new_composition(self.mm.get_graph(),
                                                 self.next_composition)
        self.finish_apply()
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

    def update_after_icp(self, result: ICPResult) -> None:
        """The decision tree with the overlap probe computed here, at the
        current pose, then the composition applied."""
        comp = self.neighbor_probe_request()
        ov = None if comp is None else self.compute_overlap_with(
            comp, reading=self._last_reading)
        self.decide_composition(result, comp, ov)
        self.apply_composition()

    def decide_composition(self, result: ICPResult, comp, probe_ov) -> None:
        """The post-ICP decision tree, given the neighbour composition and
        its probe overlap (both None when there is no candidate)."""
        overlap = float(result.overlap)
        log.info("[Localizer] current overlap = %.4f", overlap)
        is_better = comp is not None and self._overlap_is_better(
            probe_ov, overlap)
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
                self.T_refkf_robot, np.asarray(result.cov),
                _own(self.input_cloud))
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
        """Install the (re)built local-map cloud as the ICP reference (its
        reference filter chain is part of the local map's build)."""
        with timing.span("pgslam.localmap.build"):
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

    def _overlap_is_better(self, candidate_overlap: float,
                           current_overlap: float) -> bool:
        return (self.is_overlap_enough(candidate_overlap)
                and candidate_overlap > current_overlap)

    def is_better_composition(self, current_overlap: float,
                              candidate: Composition) -> bool:
        """Whether ``candidate`` (not the current composition) overlaps
        the scan enough and more than the current one does."""
        if self.local_map.has_same_composition(candidate):
            return False
        return self._overlap_is_better(self.compute_overlap_with(candidate),
                                       current_overlap)

    def compute_overlap_with(self, comp: Composition,
                             reading: Optional[Cloud] = None) -> float:
        """The overlap probe: the scan's reading (prepared here from the
        input cloud unless given) against ``comp``'s candidate map in the
        world frame (cached), at the current world pose."""
        if reading is None:
            reading = self.icp_engine.prepare_reading(self.input_cloud)
        ov = compute_overlap(reading, self._cached_probe_map(comp),
                             self._tensor(self.T_world_robot),
                             self.icp_engine.config)
        with timing.wait("localizer.overlap"):
            return float(ov)

    def _cached_probe_map(self, comp: Composition) -> Cloud:
        """The candidate map in the world frame after the reference
        filters, cached per (composition, member update times)."""
        world = self._probe_cache_get(comp)
        if world is None:
            with timing.span("pgslam.localmap.build"):
                world = probe_build_batched(
                    *stack_compositions(self.mm.get_graph(),
                                        [comp.as_list()], comp.capacity),
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
