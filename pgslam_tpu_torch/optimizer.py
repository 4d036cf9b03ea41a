"""Optimizer component: assembles the pose graph plus the pending loop
constraints into one LM problem, runs it, writes the poses back and only
then inserts the loop edges. Counterpart of the classic path of
:mod:`pgslam_tpu.optimizer` (the device-resident mirror is not ported).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Tuple

import numpy as np
import torch

from .graph.pose_graph import LOOP_CONSTRAINT, MapManager
from .devices import resolve_device
from .optim.pgo import PGOConfig, optimize_pose_graph

log = logging.getLogger("pgslam_tpu_torch.optimizer")


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
    """Same fields and defaults as ``pgslam_tpu.optimizer.OptimizerConfig``;
    ``resident`` and ``writeback_pack`` belong to the device-resident
    mirror, which is not ported, and are ignored."""
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
        # The fleet queues constraints and optimizes once per step over
        # all of them (process_pending).
        self.queue_mode = False

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

    def process_data(self) -> None:
        log.info("[Optimizer] Building factor graph with %d new loop "
                 "closing factors", len(self.data_buffer))
        nv = self.mm.get_graph().n_vertices
        args, rmask = self.prepare_for_optimization()
        new_poses, stats = optimize_pose_graph(
            *args, robust_emask=rmask, config=self.config.pgo)
        self.last_stats = {k: float(v) for k, v in stats.items()}
        log.info("[Optimizer] cost %.3e -> %.3e in %d iters",
                 self.last_stats["initial_cost"],
                 self.last_stats["final_cost"],
                 int(self.last_stats["iterations"]))
        self.runs += 1
        self.update_after_optimization(new_poses.cpu().numpy()[:nv])

    def prepare_for_optimization(self):
        """Padded problem: every graph edge plus the pending loop edges,
        the current optimized poses as initial values, and the anchor."""
        g = self.mm.get_graph()
        nv, ne = g.n_vertices, g.n_edges
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
            rmask = torch.as_tensor(rm, device=self.device)
        args = tuple(torch.as_tensor(a, device=self.device) for a in arrays)
        return args + (self.mm.get_fixed_vertex(),), rmask

    def update_after_optimization(self, new_poses: np.ndarray) -> None:
        """Write the poses back under one stamp, then insert the loop
        edges, then tell the localizer."""
        g = self.mm.get_graph()
        t_opt = self.mm.now()
        n = min(len(new_poses), g.n_vertices)
        self.mm.update_keyframe_transforms_bulk(new_poses[:n], t_opt)
        for (f, t, T, c) in self.data_buffer:
            self.mm.add_loop_closing_constraint(f, t, T, c)
        self.data_buffer = []
        self.mm.notify_keyframe_update()
