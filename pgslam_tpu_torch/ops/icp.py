"""The ICP loop. Counterpart of :mod:`pgslam_tpu.ops.icp`: match ->
outlier-weigh -> minimize -> check, with the iteration cap, the smoothed
differential checker, an optional coarse stage, optional Anderson
acceleration, the bound checker and a NaN guard. Matching goes through
K1, or the voxel-hash grid (``ops/gridknn.py``) under ``matcher="grid"``.

The loop itself is the segmented registration of ``ops/icp_graph.py``,
run two ways with the same bits: on the card point-to-plane runs each
stage to its cap as replays of captured CUDA graphs; everywhere else the
segments run eagerly and the host leaves a stage once it has converged.
This module holds the pieces both share (the minimization, the Anderson
update, the bound check), :func:`icp_core`, which picks the way, and the
one road of a result to the host: :func:`pack_result` on the device,
:class:`HostFetch`, :func:`unpack_result` on the host.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from .. import se3
from ..utils import timing
from ..cloud import Cloud
from . import filters as F
from . import minimizer as M
from . import outlier as O
from .gridknn import GridIndex, build_grid_index, grid_knn
from .knn import Matches, knn

log = logging.getLogger("pgslam_tpu_torch.icp")


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Static ICP pipeline configuration; same fields and defaults as
    ``pgslam_tpu.ops.icp.ICPConfig``."""

    error: str = "point_to_point"          # or "point_to_plane"
    matcher: str = "brute"                  # "brute" | "grid" | "pallas"
    knn: int = 1
    tile_ref: int = 2048
    tile_query: int = 0
    grid_cell_size: float = 0.0
    grid_bucket_cap: int = 8
    # Precision of the TPU matcher's matrix unit. Every mode maps to the
    # one exact fp32 K1 kernel here.
    pallas_precision: str = "highest"
    outlier: Tuple = (O.TrimmedDist(0.85), O.MaxDist(1.0))
    max_iterations: int = 40
    trans_eps: float = 1e-4
    rot_eps: float = 1e-4
    smooth_length: int = 4
    max_correction_trans: float = 0.0
    max_correction_rot: float = 0.0
    coarse_div: int = 0
    coarse_iterations: int = 10
    anderson_m: int = 0
    reading_filters: Tuple = ()
    reference_filters: Tuple = ()


def eps_dead_zone(cfg: ICPConfig) -> Optional[str]:
    """Why the differential checker can never fire for ``cfg``, or None."""
    L = max(1, cfg.smooth_length)
    if cfg.max_iterations < L:
        return (f"max_iterations={cfg.max_iterations} < smooth_length={L}: "
                f"the smoothed eps window never fills, so converged can "
                f"never be reported and max_iter_reached is unconditionally "
                f"True")
    if cfg.trans_eps <= 0 or cfg.rot_eps <= 0:
        return (f"trans_eps={cfg.trans_eps} / rot_eps={cfg.rot_eps}: "
                f"non-positive eps can never be satisfied")
    return None


def eps_margin(cfg: ICPConfig) -> int:
    return cfg.max_iterations - max(1, cfg.smooth_length)


@dataclasses.dataclass
class ICPResult:
    """Registration result; every field is a tensor on the input's
    device (0-d for the scalars)."""
    T: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    max_iter_reached: torch.Tensor
    overlap: torch.Tensor
    residual: torch.Tensor
    cov: torch.Tensor
    diverged: Optional[torch.Tensor] = None


PACKED_WIDTH = 59


def pack_result(result: ICPResult, overlap=None) -> torch.Tensor:
    """A result (and an optional second scalar, the overlap probe's or the
    verification's residual) as one fp32 vector per batch entry, ``[...,
    59]``: T (16), cov (36), iterations, converged, max_iter_reached,
    overlap, residual, diverged, then the extra scalar. NaN marks an
    absent ``diverged`` or extra slot. One vector is one device-to-host
    copy (:class:`HostFetch`) instead of one per field."""
    T = result.T
    lead = T.shape[:-2]
    col = lambda x: torch.as_tensor(x, device=T.device).to(
        torch.float32).reshape(lead)
    nan = torch.full(lead, float("nan"), dtype=torch.float32,
                     device=T.device)
    tail = torch.stack([col(result.iterations), col(result.converged),
                        col(result.max_iter_reached), col(result.overlap),
                        col(result.residual),
                        nan if result.diverged is None
                        else col(result.diverged),
                        nan if overlap is None else col(overlap)], dim=-1)
    return torch.cat([T.to(torch.float32).reshape(*lead, 16),
                      result.cov.to(torch.float32).reshape(*lead, 36),
                      tail], dim=-1)


def unpack_result(vec) -> Tuple[ICPResult, Optional[float]]:
    """The host inverse of :func:`pack_result` for one entry: a result
    with numpy leaves and the extra scalar, or None where its slot is
    NaN."""
    vec = np.asarray(vec)
    div, extra = vec[57], vec[58]
    result = ICPResult(
        T=vec[:16].reshape(4, 4), iterations=np.int32(vec[52]),
        converged=np.bool_(vec[53] != 0.0),
        max_iter_reached=np.bool_(vec[54] != 0.0),
        overlap=np.float32(vec[55]), residual=np.float32(vec[56]),
        cov=vec[16:52].reshape(6, 6),
        diverged=None if np.isnan(div) else np.bool_(div != 0.0))
    return result, (None if np.isnan(extra) else float(extra))


class HostFetch:
    """A device-to-host copy in flight: on the card a non-blocking copy
    into pinned host memory, ordered on the current stream and followed
    by an event; :meth:`get` waits on that event and nothing else. On the
    CPU a plain copy."""

    def __init__(self, vec: torch.Tensor):
        vec = vec.detach()
        if vec.device.type == "cuda":
            self._host = torch.empty(vec.shape, dtype=vec.dtype,
                                     pin_memory=True)
            self._host.copy_(vec, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(vec.device))
            self._source = vec      # alive until the copy has run
        else:
            self._host = vec.clone()
            self._event = self._source = None

    def get(self) -> np.ndarray:
        with timing.wait("fetch.event"):
            if self._event is not None:
                self._event.synchronize()
                self._event = self._source = None
        return self._host.numpy()


def match_clouds(points, mask, reference: Cloud, cfg: ICPConfig,
                 index: Optional[GridIndex] = None) -> Matches:
    """The grid matcher through ``index`` where the config asks for it and
    an index is given; K1 otherwise (every other matcher, and the grid
    matcher without an index, as the JAX package falls back to its exact
    brute force)."""
    if cfg.matcher == "grid" and index is not None:
        return grid_knn(points, mask, index, k=cfg.knn)
    return knn(points, mask, reference.points, reference.mask, k=cfg.knn)


def build_error_elements(points, reference: Cloud, matches: Matches,
                         weights, cfg: ICPConfig) -> M.ErrorElements:
    ids = matches.ids.reshape(-1).long()
    normals = (reference.descriptors["normals"][ids]
               if cfg.error == "point_to_plane" else None)
    k = matches.k
    reading = points.repeat_interleave(k, 0) if k > 1 else points
    return M.ErrorElements(reading=reading, reference=reference.points[ids],
                           weights=weights.reshape(-1), normals=normals)


def _match_and_weigh(points, mask, reference, cfg, index=None):
    matches = match_clouds(points, mask, reference, cfg, index)
    return matches, O.compute_weights(cfg.outlier, matches, mask)


def _minimize(pts, mask, reference: Cloud, matches: Matches, T,
              cfg: ICPConfig):
    """Weigh -> minimize from the matches of ``pts`` (the reading at T):
    (delta @ T, delta)."""
    weights = O.compute_weights(cfg.outlier, matches, mask)
    elems = build_error_elements(pts, reference, matches, weights, cfg)
    if cfg.error == "point_to_plane":
        delta = M.point_to_plane(elems)
    else:
        delta = M.point_to_point(elems)
    return delta @ T, delta


def _anderson(T, T_plain, X, GX, T0, Tinv0, eye, filled):
    """One type-II Anderson update (``pgslam_tpu/ops/icp.py``
    ``body_aa``) on the window ``X``, ``GX`` of the last ``m`` se3-log
    twists taken relative to the stage entry ``T0``: ``x_k = log(T
    T0^-1)``, ``g_k = log(T_plain T0^-1)``, the (m-1)x(m-1) system
    regularized by 1e-10 I, and the extrapolation kept only when it lies
    within twice the plain step of ``g_k`` and the window has filled
    (``filled``, a bool or a 0-d bool tensor). Returns (T, X, GX)."""
    x_k = se3.log(T @ Tinv0)
    g_k = se3.log(T_plain @ Tinv0)
    X = torch.cat([x_k[None], X[:-1]])
    GX = torch.cat([g_k[None], GX[:-1]])
    Fr = GX - X
    dF = Fr[0] - Fr[1:]
    dG = GX[0] - GX[1:]
    # solve_ex: an exactly singular window (the zero-filled warm-up)
    # gives non-finite gamma, which the safeguard below rejects, as
    # the reference's LU solve does.
    gamma = torch.linalg.solve_ex(dF @ dF.T + 1e-10 * eye, dF @ Fr[0])[0]
    x_acc = g_k - gamma @ dG
    plain_sz = torch.linalg.norm(g_k - x_k)
    ok = (torch.linalg.norm(x_acc - g_k) <= 2.0 * plain_sz + 1e-9) & filled
    return se3.exp(torch.where(ok, x_acc, g_k)) @ T0, X, GX


def bound_check(T, T0, cfg: ICPConfig):
    """Bound checker + NaN guard: returns (T or T0, diverged) for a
    single or batched transform."""
    dT = T @ se3.inverse(T0)
    diverged = torch.zeros(T.shape[:-2], dtype=torch.bool, device=T.device)
    if cfg.max_correction_trans > 0:
        diverged |= se3.translation_norm(dT) > cfg.max_correction_trans
    if cfg.max_correction_rot > 0:
        diverged |= se3.rotation_angle(dT) > cfg.max_correction_rot
    diverged |= ~torch.isfinite(T).all(-1).all(-1)
    return torch.where(diverged[..., None, None], T0, T), diverged


def icp_core(reading: Cloud, reference: Cloud, T_init: torch.Tensor,
             cfg: ICPConfig, index: Optional[GridIndex] = None) -> ICPResult:
    """The full ICP loop on pre-filtered clouds; ``index`` is the
    reference's grid index for ``matcher="grid"``. It computes in fp32
    (K1's on the card), or in fp64 where the reading is fp64 (the plain
    matcher on the CPU). Where :func:`.icp_graph.graph_route` takes the
    inputs (point-to-plane on the card), the loop runs as CUDA graph
    replays; elsewhere eagerly, leaving each stage once it has converged
    (:func:`.icp_graph.register_eager`). Both give the same bits."""
    from . import icp_graph
    if icp_graph.graph_route(reading, reference, T_init, cfg):
        return icp_graph.register(reading, reference, T_init, cfg, index)
    return icp_graph.register_eager(reading, reference, T_init, cfg, index)


def compute_overlap(reading: Cloud, reference: Cloud, T: torch.Tensor,
                    cfg: ICPConfig) -> torch.Tensor:
    """Partial-ICP overlap probe: match + weigh at T, no minimization
    (through K1 under every matcher, as the JAX package's probe)."""
    pts = se3.apply(T, reading.points)
    _, weights = _match_and_weigh(pts, reading.mask, reference, cfg)
    return M.overlap(weights, reading.count())


def compute_residual(reading: Cloud, reference: Cloud, T: torch.Tensor,
                     cfg: ICPConfig) -> torch.Tensor:
    """Residual error of the reading matched at T (through K1 under every
    matcher, as the JAX package's residual pass)."""
    pts = se3.apply(T, reading.points)
    matches, weights = _match_and_weigh(pts, reading.mask, reference, cfg)
    elems = build_error_elements(pts, reference, matches, weights, cfg)
    return M.residual_error(elems, cfg.error)


def reference_chain(cfg: ICPConfig, reference: Cloud) -> Tuple:
    """The reference filter chain, plus normals when point-to-plane needs
    them and neither the chain nor the cloud provides them."""
    chain = cfg.reference_filters
    if cfg.error == "point_to_plane" and not any(
            isinstance(f, F.SurfaceNormal) for f in chain) \
            and "normals" not in reference.descriptors:
        chain = chain + (F.SurfaceNormal(),)
    return chain


def reference_index(reference: Cloud, cfg: ICPConfig) -> Optional[GridIndex]:
    """The grid index of a prepared reference under ``matcher="grid"``,
    else None."""
    if cfg.matcher != "grid":
        return None
    return build_grid_index(reference.points, reference.mask,
                            cell_size=cfg.grid_cell_size,
                            bucket_cap=cfg.grid_bucket_cap)


class ICPEngine:
    """Persistent pre-processed reference map across calls."""

    def __init__(self, config: ICPConfig = ICPConfig()):
        reason = eps_dead_zone(config)
        if reason is not None:
            log.warning("[ICP] convergence checker can never fire (%s)",
                        reason)
        self.config = config
        self._reference: Optional[Cloud] = None
        self.index: Optional[GridIndex] = None

    @property
    def has_map(self) -> bool:
        return self._reference is not None

    @property
    def reference(self) -> Optional[Cloud]:
        return self._reference

    def prepare_reference(self, reference: Cloud) -> Cloud:
        return F.apply_chain(reference_chain(self.config, reference),
                             reference)

    def set_map(self, reference: Cloud) -> None:
        """Prepare and hold the reference, with its grid index under
        ``matcher="grid"``."""
        self._reference = ref = self.prepare_reference(reference)
        self.index = reference_index(ref, self.config)

    def prepare_reading(self, reading: Cloud) -> Cloud:
        return F.apply_chain(self.config.reading_filters, reading)

    def __call__(self, reading: Cloud, T_init: torch.Tensor) -> ICPResult:
        if self._reference is None:
            raise RuntimeError("ICPEngine: set_map() must be called first")
        return icp_core(self.prepare_reading(reading), self._reference,
                        T_init, self.config, self.index)


def icp(reading: Cloud, reference: Cloud, T_init: torch.Tensor,
        cfg: ICPConfig = ICPConfig()) -> ICPResult:
    """One-shot registration: both filter chains, then the loop."""
    engine = ICPEngine(cfg)
    engine.set_map(reference)
    return engine(reading, T_init)
