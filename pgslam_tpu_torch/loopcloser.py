"""LoopCloser: per new keyframe, find vertices that are geometrically close
but topologically far, assemble a candidate local map by Dijkstra on the
loop-edge-free graph, verify with a second ICP and accept only a
converged, overlapping, low-residual registration. Counterpart of
:mod:`pgslam_tpu.loopcloser`; the verification ICP runs on K2 when the
config is eligible. A verification is dispatched with its result and
fresh residual packed into one vector whose copy to the host starts at
once; the synchronous path commits it right away, the deferred one
(``deferred_verification``) at the next scan's drain.
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
from .ops.icp import (HostFetch, ICPConfig, ICPResult, compute_residual,
                      eps_dead_zone, eps_margin, icp_core, pack_result,
                      reference_chain, reference_index, unpack_result)
from .parallel.batched import batched_register, register_one, use_fused
from .utils import counters, timing

log = logging.getLogger("pgslam_tpu_torch.loopcloser")


@dataclasses.dataclass(frozen=True)
class LoopCloserConfig:
    """Same fields and defaults as ``pgslam_tpu.loopcloser.
    LoopCloserConfig``. With ``deferred_verification`` a spawn's
    verification is committed at the next scan's drain
    (``MapManager.drain_loop_closer``) instead of inside the spawn."""
    topo_dist_threshold: float = 3.0
    geom_dist_threshold: float = 3.0
    overlap_threshold: float = 0.8
    residual_error_threshold: float = 5000.0
    candidate_local_map_size: int = 3
    icp: ICPConfig = ICPConfig()
    deferred_verification: bool = False


def verify(reading: Cloud, ref_cloud: Cloud, T0: torch.Tensor,
           cfg: ICPConfig) -> torch.Tensor:
    """The verification stage: both filter chains, the registration (K2
    where :func:`use_fused` routes it on the device the clouds live on,
    else ``icp_core``, through the filtered reference's grid index under
    ``matcher="grid"``), and the fresh residual at the result (matched
    without the index, as in JAX). Returns the result packed with the
    residual in its extra slot (``pack_result``), on the clouds'
    device."""
    reading = F.apply_chain(cfg.reading_filters, reading)
    ref = F.apply_chain(reference_chain(cfg, ref_cloud), ref_cloud)
    if use_fused(cfg, ref, reading.points.device):
        res = register_one(reading, ref, T0, cfg)
    else:
        res = icp_core(reading, ref, T0, cfg, reference_index(ref, cfg))
    return pack_result(res, compute_residual(reading, ref, res.T, cfg))


def verify_batch(readings: Cloud, refs: Cloud, T0s: torch.Tensor,
                 cfg: ICPConfig) -> torch.Tensor:
    """The verification stage for a stacked batch (``_verify_batch``):
    both filter chains per entry, one batched registration (one K2 launch
    on the card when the config is eligible) and each entry's residual
    computed fresh at its result. Returns the batch packed with each
    entry's residual in its extra slot, ``[B, 59]`` (``pack_result``), on
    the clouds' device."""
    B = readings.points.shape[0]
    rd = [F.apply_chain(cfg.reading_filters, readings.map(lambda a: a[b]))
          for b in range(B)]
    chain = reference_chain(cfg, refs)
    rf = [F.apply_chain(chain, refs.map(lambda a: a[b])) for b in range(B)]
    res = batched_register(stack_clouds(rd), stack_clouds(rf), T0s, cfg)
    residuals = torch.stack([compute_residual(r, m, res.T[b], cfg)
                             for b, (r, m) in enumerate(zip(rd, rf))])
    return pack_result(res, residuals)


def _residual(extra: Optional[float]) -> float:
    """A verification's residual from its packed extra slot: NaN where the
    slot held NaN, never None (which asks for a fresh residual)."""
    return float("nan") if extra is None else extra


class LoopCloser:

    def __init__(self, map_manager: MapManager, optimizer,
                 config: LoopCloserConfig = LoopCloserConfig(), device=None):
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
        # Dispatched verifications not committed yet, oldest first
        # (deferred_verification).
        self._deferred = []

    def _count(self, outcome: str) -> None:
        setattr(self, outcome, getattr(self, outcome) + 1)
        counters[f"loopcloser/{outcome}"] += 1

    def add_new_vertex(self, v: int) -> None:
        if self.queue_mode:
            self._pending.append(int(v))
            return
        # The grid matcher verifies synchronously, as the JAX package does.
        if self.config.deferred_verification \
                and self.config.icp.matcher != "grid":
            rec = self._dispatch_verification(int(v))
            if rec is not None:
                self._deferred.append(rec)
            return
        self.process_vertex(int(v))

    def drain_deferred(self) -> None:
        """Commit every dispatched verification, in order."""
        while self._deferred:
            self._commit_verification(self._deferred.pop(0))

    @timing.spanned("pgslam.loopcloser.verify")
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
        with timing.wait("loopcloser.upload"):
            T0s = torch.as_tensor(np.stack(T0s), device=refs.device)
        vec = HostFetch(verify_batch(stack_clouds(readings), refs, T0s,
                                     self.config.icp)).get()
        accepted_pairs = set()
        for i, ((v, _), lm) in enumerate(zip(reqs, lms)):
            result, residual = unpack_result(vec[i])
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
            elif self.check_icp_result(result, residual=_residual(residual)):
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

    @timing.spanned("pgslam.loopcloser.vertex")
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
        """Candidate search and the verification, whose packed result
        starts on its way to the host; nothing waits for it. Returns the
        record :meth:`_commit_verification` takes, or None when no
        candidate exists."""
        self.input_vertex = input_vertex
        if not self.process_local_map_candidate():
            return None
        with timing.wait("loopcloser.upload"):
            T0 = torch.as_tensor(self._verification_init(),
                                 device=self.device)
        packed = verify(self.input_cloud, self.candidate_local_map.cloud(),
                        T0, self.config.icp)
        rec = {"vertex": input_vertex, "lm": self.candidate_local_map,
               "cloud": self.input_cloud,
               "T_world_kf": self.input_T_world_kf,
               "fetch": HostFetch(packed)}
        # The record keeps the map; the next dispatch takes a fresh one
        # (deferred mode can hold several records).
        self.candidate_local_map = LocalMap(
            self.config.candidate_local_map_size)
        return rec

    def _commit_verification(self, rec) -> None:
        """Fetch one verification, then acceptance and the optimizer."""
        self.input_vertex = rec["vertex"]
        self.input_cloud = rec["cloud"]
        self.input_T_world_kf = rec["T_world_kf"]
        self.candidate_local_map = rec["lm"]
        result, residual = unpack_result(rec["fetch"].get())
        self.last_result = result
        self.T_refkf_kf = np.asarray(result.T)
        self._accept_or_reject(rec["vertex"], rec["lm"], result,
                               _residual(residual))

    def _accept_or_reject(self, input_vertex: int, lm, result,
                          residual) -> None:
        ref_v = lm.reference_vertex()
        if self.mm.get_graph().has_edge(ref_v, input_vertex):
            # Only a deferred commit meets this: another closure inserted
            # the pair between dispatch and drain (the synchronous path
            # searches again after every insertion).
            self._count("rejected_duplicate")
            log.info("[LoopCloser] Loop closure %d -> %d dropped: edge "
                     "already exists", ref_v, input_vertex)
        elif self.check_icp_result(result, residual=residual):
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
        if not self.find_local_map_candidate(self.input_vertex):
            return False
        graph = self.mm.get_graph()
        self.input_cloud = graph.clouds[self.input_vertex]
        self.input_T_world_kf = graph.optimized_poses[self.input_vertex].copy()
        return True

    def find_local_map_candidate(self, input_v: int) -> bool:
        """Candidate search, and the candidate local map built from the
        winner; False when no candidate exists."""
        comp = self.find_candidate_composition(input_v)
        if comp is None:
            return False
        self.candidate_local_map.update_to_new_composition(
            self.mm.get_graph(), comp)
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

    # -- setters -------------------------------------------------------------

    def set_topological_distance_threshold(self, v: float) -> None:
        self.config = dataclasses.replace(self.config, topo_dist_threshold=v)

    def set_geometrical_distance_threshold(self, v: float) -> None:
        self.config = dataclasses.replace(self.config, geom_dist_threshold=v)

    def set_overlap_threshold(self, v: float) -> None:
        self.config = dataclasses.replace(self.config, overlap_threshold=v)

    def set_residual_error_threshold(self, v: float) -> None:
        self.config = dataclasses.replace(self.config,
                                          residual_error_threshold=v)

    def set_candidate_local_map_max_size(self, size: int) -> None:
        self.candidate_local_map = LocalMap(size)

    def set_icp_config(self, path: str) -> None:
        """Load the verification ICP YAML (rejected where its convergence
        checker could never fire)."""
        from .config import load_icp_config
        icp = load_icp_config(path)
        self._validate_verification_profile(icp)
        self.config = dataclasses.replace(self.config, icp=icp)

    def check_icp_result(self, result: ICPResult,
                         residual: Optional[float] = None) -> bool:
        """Acceptance; without ``residual`` it is recomputed
        (:meth:`compute_residual_error`)."""
        if result.diverged is not None and bool(result.diverged):
            return False
        if bool(result.max_iter_reached):
            return False
        if float(result.overlap) < self.config.overlap_threshold:
            return False
        if residual is None:
            residual = self.compute_residual_error()
        return not residual > self.config.residual_error_threshold

    def compute_residual_error(self) -> float:
        """The residual of the input keyframe's cloud against the
        candidate map at ``T_refkf_kf``, matched fresh through both
        filter chains."""
        cfg = self.config.icp
        ref_cloud = self.candidate_local_map.cloud()
        reading = F.apply_chain(cfg.reading_filters, self.input_cloud)
        ref = F.apply_chain(reference_chain(cfg, ref_cloud), ref_cloud)
        with timing.wait("loopcloser.upload"):
            T = torch.as_tensor(np.asarray(self.T_refkf_kf, np.float32),
                                device=ref.device)
        return float(HostFetch(compute_residual(reading, ref, T, cfg)).get())
