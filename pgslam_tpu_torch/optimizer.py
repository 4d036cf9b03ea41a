"""Optimizer component: assembles the pose graph plus the pending loop
constraints into one LM problem, runs it, writes the poses back and only
then inserts the loop edges. Counterpart of :mod:`pgslam_tpu.optimizer`.

By default the problem lives on the device between optimizes
(:mod:`.optim.resident`, ``OptimizerConfig.resident``): each optimize
uploads what changed and fetches the poses and stats in one copy. The
classic path (``resident="off"``, or ``PGSLAM_PGO_RESIDENT=0``) uploads
the whole padded problem every time; it also takes a batch whose
resident optimize raised.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Tuple

import numpy as np
import torch

from .graph.pose_graph import LOOP_CONSTRAINT, MapManager
from .devices import resolve_device
from .optim.pgo import PGOConfig, optimize_pose_graph
from .utils import timing

log = logging.getLogger("pgslam_tpu_torch.optimizer")


def pm_cov_to_gtsam_cov(mat: np.ndarray) -> np.ndarray:
    """Swap the 3x3 blocks of a 6x6 covariance (or a stack of them):
    libpointmatcher's [t; r] order to GTSAM's [r; t]. Its own inverse.
    The port's solver reads [t; r] natively, so no path converts; this
    is for interchange with GTSAM-ordered data."""
    out = np.empty_like(mat)
    out[..., :3, :3] = mat[..., 3:, 3:]
    out[..., 3:, 3:] = mat[..., :3, :3]
    out[..., 3:, :3] = mat[..., :3, 3:]
    out[..., :3, 3:] = mat[..., 3:, :3]
    return out


def _bucket(n: int, bucket: int) -> int:
    """Next power of two, at least ``bucket``."""
    return max(bucket, 1 << max(0, n - 1).bit_length())


def pad_graph(poses, edge_from, edge_to, edge_T, edge_cov, bucket: int):
    """A pose graph padded to fixed shapes, as numpy arrays (poses, vmask,
    edge_from, edge_to, edge_T, edge_cov, emask): vertices and edges each
    to the next power of two (at least ``bucket``); padded poses,
    measurements and covariances are the identity, masks False and
    endpoints 0."""
    nv, ne = len(poses), len(edge_from)
    V, E = _bucket(nv, bucket), _bucket(ne, bucket)
    out_poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    out_poses[:nv] = poses
    vmask = np.zeros(V, bool)
    vmask[:nv] = True
    ef = np.zeros(E, np.int32)
    et = np.zeros(E, np.int32)
    eT = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    ec = np.tile(np.eye(6, dtype=np.float32), (E, 1, 1))
    emask = np.zeros(E, bool)
    ef[:ne], et[:ne], eT[:ne], ec[:ne] = edge_from, edge_to, edge_T, edge_cov
    emask[:ne] = True
    return out_poses, vmask, ef, et, eT, ec, emask


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Same fields and defaults as ``pgslam_tpu.optimizer.OptimizerConfig``.
    ``resident``: "auto" keeps the padded graph on the device across
    optimizes (:class:`.optim.resident.ResidentPGO`, the same solve, the
    same bits as a rebuild), "off" uploads it whole every time.
    ``writeback_pack``: how the poses come back from the mirror,
    "exact12" (bit-exact), "quat7" (~1e-7 of rotation round-off, 7/12
    of the bytes) or "auto" (quat7 from ``resident.QUAT_MIN_V`` padded
    vertices)."""
    pgo: PGOConfig = PGOConfig()
    shape_bucket: int = 64
    resident: str = "auto"
    writeback_pack: str = "auto"


class Optimizer:

    def __init__(self, map_manager: MapManager,
                 config: OptimizerConfig = OptimizerConfig(), device=None):
        self.mm = map_manager
        self.config = config
        self.device = resolve_device(device)
        self.data_buffer: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        self.last_stats = None
        self.runs = 0
        # Vertices in the problem prepare_for_optimization built: the
        # writeback covers these only (the MT optimizer solves unlocked
        # while the localizer appends vertices).
        self._nv_snapshot = None
        # The fleet queues constraints and optimizes once per step over
        # all of them (process_pending).
        self.queue_mode = False
        self._mirror = None          # the ResidentPGO, made at first use

    def add_new_data(self, from_v: int, to_v: int, T_from_to,
                     cov_from_to) -> None:
        """One accepted loop constraint = one optimization, or a queued
        constraint in ``queue_mode``."""
        item = (int(from_v), int(to_v), np.asarray(T_from_to, np.float32),
                np.asarray(cov_from_to, np.float32))
        if self.queue_mode:
            self.data_buffer.append(item)
            return
        self.data_buffer = [item]
        self.process_data()

    def process_pending(self) -> None:
        """One optimization over every queued constraint."""
        if self.data_buffer:
            self.process_data()

    def _resident_enabled(self) -> bool:
        if os.environ.get("PGSLAM_PGO_RESIDENT", "") == "0":
            return False
        return self.config.resident != "off"

    @timing.spanned("pgslam.optimizer.optimize")
    def process_data(self) -> None:
        log.info("[Optimizer] Building factor graph with %d new loop "
                 "closing factors", len(self.data_buffer))
        resident_failed = False
        if self._resident_enabled():
            try:
                # The prepare is inside the fail-soft too: a host-side
                # bookkeeping error takes the classic path as a device
                # failure does. It consumed pose_dirty, but the classic
                # path rebuilds from the whole graph, and invalidate()
                # makes the mirror's next call a rebuild.
                prep = self.prepare_for_optimization_resident()
                new_poses, self.last_stats = self._mirror.execute(prep)
            except Exception as e:
                # A slower optimize beats a SLAM loop that stops.
                log.warning("[Optimizer] resident optimize failed "
                            "(%s: %s) — falling back to the classic "
                            "path for this batch", type(e).__name__, e,
                            exc_info=True)
                if self._mirror is not None:
                    self._mirror.invalidate()
                resident_failed = True
        if not self._resident_enabled() or resident_failed:
            args, rmask = self.prepare_for_optimization()
            new_poses, stats = optimize_pose_graph(
                *args, robust_emask=rmask, config=self.config.pgo)
            self.last_stats = {}
            for k, v in stats.items():
                with timing.wait("optimizer.fetch"):
                    self.last_stats[k] = float(v)
            with timing.wait("optimizer.fetch"):
                new_poses = new_poses.cpu().numpy()
        log.info("[Optimizer] cost %.3e -> %.3e in %d iters",
                 self.last_stats["initial_cost"],
                 self.last_stats["final_cost"],
                 int(self.last_stats["iterations"]))
        self.runs += 1
        self.update_after_optimization(new_poses)

    def prepare_for_optimization_resident(self):
        """The mirror's host snapshot (graph reads only; the MT optimizer
        takes the graph lock around it, as around
        :meth:`prepare_for_optimization`)."""
        if self._mirror is None:
            from .optim.resident import ResidentPGO
            self._mirror = ResidentPGO(self.config.pgo,
                                       shape_bucket=self.config.shape_bucket,
                                       pack=self.config.writeback_pack,
                                       device=self.device)
        g = self.mm.get_graph()
        self._nv_snapshot = g.n_vertices
        return self._mirror.prepare(g, self.mm.get_fixed_vertex(),
                                    self.data_buffer)

    def prepare_for_optimization(self):
        """Padded problem: every graph edge plus the pending loop edges,
        the current optimized poses as initial values, and the anchor."""
        g = self.mm.get_graph()
        nv, ne = g.n_vertices, g.n_edges
        self._nv_snapshot = nv
        pend = self.data_buffer
        n_pending = len(pend)
        arrays = pad_graph(
            g.optimized_poses[:nv],
            np.concatenate([g.edge_from[:ne], [p[0] for p in pend]]),
            np.concatenate([g.edge_to[:ne], [p[1] for p in pend]]),
            np.concatenate([g.edge_T[:ne]] + [p[2][None] for p in pend]),
            np.concatenate([g.edge_cov[:ne]] + [p[3][None] for p in pend]),
            self.config.shape_bucket)
        rmask = None
        if self.config.pgo.robust != "none":
            rm = np.zeros(len(arrays[2]), bool)
            rm[:ne] = g.edge_type[:ne] == LOOP_CONSTRAINT
            rm[ne:ne + n_pending] = True
            with timing.wait("optimizer.upload"):
                rmask = torch.as_tensor(rm, device=self.device)
        args = []
        for a in arrays:
            with timing.wait("optimizer.upload"):
                args.append(torch.as_tensor(a, device=self.device))
        args = tuple(args)
        return args + (self.mm.get_fixed_vertex(),), rmask

    def update_after_optimization(self, new_poses: np.ndarray) -> None:
        """Write back the poses of the vertices the problem held under one
        stamp (vertices appended since keep theirs), then insert the loop
        edges, then tell the localizer."""
        g = self.mm.get_graph()
        t_opt = self.mm.now()
        n = min(len(new_poses), g.n_vertices)
        if self._nv_snapshot is not None:
            n = min(n, self._nv_snapshot)
        # mark_dirty=False: these poses are the device's result (or its
        # packed round trip); the mirror needs no upload of them.
        self.mm.update_keyframe_transforms_bulk(new_poses[:n], t_opt,
                                                mark_dirty=False)
        try:
            for (f, t, T, c) in self.data_buffer:
                self.mm.add_loop_closing_constraint(f, t, T, c)
        finally:
            # Also after an insert raised: the graph then holds fewer
            # edges than the mirror's slots, and the mirror is dropped.
            if self._mirror is not None:
                self._mirror.confirm_inserts(g)
        self.data_buffer = []
        self.mm.notify_keyframe_update()
