"""LoopCloser: per new keyframe, find vertices that are geometrically close
but topologically far, assemble a candidate local map by Dijkstra on the
loop-edge-free graph, verify with a second ICP and accept only a
converged, overlapping, low-residual registration. Counterpart of the
synchronous path of :mod:`pgslam_tpu.loopcloser`; the verification ICP
runs on K2 when the config is eligible.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from .cloud import Cloud, stack_clouds
from .devices import resolve_device
from .graph.pose_graph import LOOP_CONSTRAINT, MapManager
from .graph.shortest_path import candidate_composition, dijkstra
from .localmap import Composition, LocalMap, batch_rebuild
from .ops import filters as F
from .ops.icp import (ICPConfig, ICPResult, compute_residual, eps_dead_zone,
                      eps_margin, icp_core, reference_chain, to_host)
from .ops.icp_fused import fused_eligible, fused_icp_register
from .utils import counters

log = logging.getLogger("pgslam_tpu_torch.loopcloser")


@dataclasses.dataclass(frozen=True)
class LoopCloserConfig:
    """Same fields and defaults as ``pgslam_tpu.loopcloser.
    LoopCloserConfig``; ``deferred_verification`` is not ported yet."""
    topo_dist_threshold: float = 3.0
    geom_dist_threshold: float = 3.0
    overlap_threshold: float = 0.8
    residual_error_threshold: float = 5000.0
    candidate_local_map_size: int = 3
    icp: ICPConfig = ICPConfig()
    deferred_verification: bool = False


def verify(reading: Cloud, ref_cloud: Cloud, T0: torch.Tensor,
           cfg: ICPConfig):
    """The verification stage: both filter chains, the registration (K2
    when eligible), and the fresh residual at the result. Returns
    (result, residual, prepared reference)."""
    reading = F.apply_chain(cfg.reading_filters, reading)
    ref = F.apply_chain(reference_chain(cfg, ref_cloud), ref_cloud)
    if fused_eligible(cfg):
        lift = lambda c: c.map(lambda a: a[None])
        res = fused_icp_register(lift(reading), lift(ref), T0[None], cfg)
        T = res.T[0]
        result = to_host(res, index=0)
    else:
        res = icp_core(reading, ref, T0, cfg)
        T = res.T
        result = to_host(res)
    residual = float(compute_residual(reading, ref, T, cfg))
    return result, residual, ref


def verify_batch(readings: Cloud, refs: Cloud, T0s: torch.Tensor,
                 cfg: ICPConfig):
    """The verification stage for a stacked batch (``_verify_batch``):
    both filter chains per entry, one batched registration (one K2 launch
    on the card when the config is eligible) and each entry's residual
    computed fresh at its result. Returns (batched result, residuals)."""
    from .parallel.batched import batched_register
    B = readings.points.shape[0]
    rd = [F.apply_chain(cfg.reading_filters, readings.map(lambda a: a[b]))
          for b in range(B)]
    chain = reference_chain(cfg, refs)
    rf = [F.apply_chain(chain, refs.map(lambda a: a[b])) for b in range(B)]
    res = batched_register(stack_clouds(rd), stack_clouds(rf), T0s, cfg)
    residuals = [float(compute_residual(r, m, res.T[b], cfg))
                 for b, (r, m) in enumerate(zip(rd, rf))]
    return res, residuals


class LoopCloser:

    def __init__(self, map_manager: MapManager, optimizer,
                 config: LoopCloserConfig = LoopCloserConfig(), device=None):
        if config.deferred_verification:
            raise NotImplementedError(
                "deferred loop-closure verification is not ported yet")
        self._validate_verification_profile(config.icp)
        self.mm = map_manager
        self.optimizer = optimizer
        self.config = config
        self.device = resolve_device(device)
        self.candidate_local_map = LocalMap(config.candidate_local_map_size)
        self.input_vertex: Optional[int] = None
        self.input_cloud: Optional[Cloud] = None
        self.input_T_world_kf: Optional[np.ndarray] = None
        self.T_refkf_kf: Optional[np.ndarray] = None
        self.last_result: Optional[ICPResult] = None
        # This closer's outcomes; utils.counters sums them over every
        # closer in the process under "loopcloser/<outcome>".
        self.accepted = 0
        self.rejected = 0
        self.rejected_duplicate = 0
        # The fleet queues new vertices and verifies them in one batch per
        # step (process_pending_batched), padded to at least batch_pad_to.
        self.queue_mode = False
        self.batch_pad_to = 0
        self._pending = []

    def _count(self, outcome: str) -> None:
        setattr(self, outcome, getattr(self, outcome) + 1)
        counters[f"loopcloser/{outcome}"] += 1

    def add_new_vertex(self, v: int) -> None:
        if self.queue_mode:
            self._pending.append(int(v))
            return
        self.process_vertex(int(v))

    def process_pending_batched(self) -> None:
        """Verify every queued vertex: the host candidate searches, one
        batched candidate-map build, one batched verification, then the
        serial acceptance (``pgslam_tpu`` ``process_pending_batched``)."""
        if not self._pending:
            return
        vs, self._pending = self._pending, []
        graph = self.mm.get_graph()
        reqs = [(v, c) for v in vs
                for c in [self.find_candidate_composition(v)] if c is not None]
        if not reqs:
            return
        size = self.config.candidate_local_map_size
        lms = []
        for _, comp in reqs:
            lm = LocalMap(size)
            lm.update_to_new_composition(graph, comp, build=False)
            lms.append(lm)
        n = len(reqs)
        bucket = max(self.batch_pad_to, 1 << (n - 1).bit_length())
        refs = batch_rebuild(lms, pad_to=bucket, return_stacked=True)
        readings = [graph.clouds[v] for v, _ in reqs]
        T0s = [(np.linalg.inv(np.asarray(lm.reference_keyframe()
                                         .optimized_T_world_kf, np.float64))
                @ np.asarray(graph.optimized_poses[v], np.float64)
                ).astype(np.float32) for (v, _), lm in zip(reqs, lms)]
        readings += [readings[0]] * (bucket - n)
        T0s += [T0s[0]] * (bucket - n)
        res, residuals = verify_batch(
            stack_clouds(readings), refs,
            torch.as_tensor(np.stack(T0s), device=refs.device),
            self.config.icp)
        accepted_pairs = set()
        for i, ((v, _), lm) in enumerate(zip(reqs, lms)):
            result = to_host(res, index=i)
            self.input_vertex = v
            self.input_cloud = graph.clouds[v]
            self.input_T_world_kf = graph.optimized_poses[v].copy()
            self.candidate_local_map = lm
            self.T_refkf_kf = np.asarray(result.T)
            self.last_result = result
            ref_v = lm.reference_vertex()
            # Every search of the batch ran before any insertion, so two
            # vertices can pick each other; one closure per pair. The set
            # covers the queued optimizer, which inserts the edges later.
            if graph.has_edge(ref_v, v) or (ref_v, v) in accepted_pairs \
                    or (v, ref_v) in accepted_pairs:
                self._count("rejected_duplicate")
                log.info("[LoopCloser] Loop closure %d -> %d dropped: edge "
                         "already exists", ref_v, v)
            elif self.check_icp_result(result, residual=residuals[i]):
                self._count("accepted")
                accepted_pairs.add((ref_v, v))
                log.info("[LoopCloser] Loop closure accepted: %d -> %d",
                         ref_v, v)
                self.optimizer.add_new_data(ref_v, v, self.T_refkf_kf,
                                            np.asarray(result.cov))
            else:
                self._count("rejected")
                log.info("[LoopCloser] Loop closure rejected for vertex %d",
                         v)

    def process_vertex(self, input_vertex: int) -> None:
        rec = self._dispatch_verification(input_vertex)
        if rec is not None:
            self._commit_verification(rec)

    def _verification_init(self) -> np.ndarray:
        """Input keyframe pose in the candidate reference keyframe's frame
        (fp64 host compose)."""
        from .localizer import _rigid_inverse
        ref_kf = self.candidate_local_map.reference_keyframe()
        Tinv = _rigid_inverse(ref_kf.optimized_T_world_kf)
        return (Tinv @ np.asarray(self.input_T_world_kf, np.float64)
                ).astype(np.float32)

    def _dispatch_verification(self, input_vertex: int):
        """Candidate search and the verification; None when no candidate
        exists."""
        self.input_vertex = input_vertex
        if not self.process_local_map_candidate():
            return None
        T0 = torch.as_tensor(self._verification_init(), device=self.device)
        result, residual, _ = verify(self.input_cloud,
                                     self.candidate_local_map.cloud(), T0,
                                     self.config.icp)
        rec = {"vertex": input_vertex, "lm": self.candidate_local_map,
               "result": result, "residual": residual}
        self.candidate_local_map = LocalMap(
            self.config.candidate_local_map_size)
        return rec

    def _commit_verification(self, rec) -> None:
        result = rec["result"]
        self.last_result = result
        self.T_refkf_kf = np.asarray(result.T)
        self._accept_or_reject(rec["vertex"], rec["lm"], result,
                               rec["residual"])

    def _accept_or_reject(self, input_vertex: int, lm, result,
                          residual) -> None:
        ref_v = lm.reference_vertex()
        if self.check_icp_result(result, residual=residual):
            self._count("accepted")
            log.info("[LoopCloser] Loop closure accepted: %d -> %d", ref_v,
                     input_vertex)
            self.optimizer.add_new_data(ref_v, input_vertex, self.T_refkf_kf,
                                        np.asarray(result.cov))
        else:
            self._count("rejected")
            log.info("[LoopCloser] Loop closure rejected for vertex %d",
                     input_vertex)

    def process_local_map_candidate(self) -> bool:
        graph = self.mm.get_graph()
        comp = self.find_candidate_composition(self.input_vertex)
        if comp is None:
            return False
        self.candidate_local_map.update_to_new_composition(graph, comp)
        self.input_cloud = graph.clouds[self.input_vertex]
        self.input_T_world_kf = graph.optimized_poses[self.input_vertex].copy()
        return True

    def find_candidate_composition(self, input_v: int):
        """Host-only candidate search: the winning composition or None."""
        graph = self.mm.get_graph()
        if graph.n_vertices <= 1:
            return None
        cfg = self.config
        n, e = graph.n_vertices, graph.n_edges
        topo, _ = dijkstra(n, graph.edge_from[:e], graph.edge_to[:e],
                           graph.edge_weight[:e], input_v)
        geom = np.linalg.norm(
            graph.optimized_poses[:n, :3, 3]
            - graph.optimized_poses[input_v, :3, 3], axis=-1)
        cand = np.nonzero((geom <= cfg.geom_dist_threshold)
                          & (topo > cfg.topo_dist_threshold))[0]
        cand = cand[np.argsort(geom[cand], kind="stable")]
        if len(cand) == 0:
            return None
        vertex_ok = topo > cfg.topo_dist_threshold
        edge_ok = graph.edge_type[:e] != LOOP_CONSTRAINT
        size = self.candidate_local_map.capacity()
        for candidate_v in cand:
            comp = candidate_composition(
                n, graph.edge_from[:e], graph.edge_to[:e],
                graph.edge_weight[:e], int(candidate_v), size,
                vertex_ok=vertex_ok, edge_ok=edge_ok)
            if comp is not None:
                log.info("[LoopCloser] Candidate found! -> %s", comp)
                return Composition(size, comp)
        return None

    @staticmethod
    def _validate_verification_profile(cfg: ICPConfig) -> None:
        """Acceptance rejects on max_iter_reached, so a profile whose
        convergence checker can never fire would reject every closure."""
        reason = eps_dead_zone(cfg)
        if reason is not None:
            raise ValueError(
                f"LoopCloser ICP profile can never report convergence "
                f"({reason}); check_icp_result would reject every closure.")
        if eps_margin(cfg) <= 1:
            log.warning("[LoopCloser] verification ICP profile has "
                        "max_iterations=%d with smooth_length=%d: most "
                        "closures will be rejected as max_iter_reached",
                        cfg.max_iterations, max(1, cfg.smooth_length))

    def check_icp_result(self, result: ICPResult, residual: float) -> bool:
        if result.diverged is not None and bool(result.diverged):
            return False
        if bool(result.max_iter_reached):
            return False
        if float(result.overlap) < self.config.overlap_threshold:
            return False
        return not residual > self.config.residual_error_threshold
