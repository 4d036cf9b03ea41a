"""The ICP loop. Counterpart of :mod:`pgslam_tpu.ops.icp`: match ->
outlier-weigh -> minimize -> check, with the iteration cap, the smoothed
differential checker, an optional coarse stage, optional Anderson
acceleration, the bound checker and a NaN guard. The iterate loop runs on
the host (one device sync per iteration for the convergence test);
matching goes through K1.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import torch

from .. import se3
from ..cloud import Cloud
from . import filters as F
from . import minimizer as M
from . import outlier as O
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


def check_supported(cfg: ICPConfig) -> None:
    """Raise for the settings whose paths are not ported yet."""
    if cfg.matcher == "grid":
        raise NotImplementedError("matcher='grid' is not ported yet")


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


def to_host(result: ICPResult, index=None) -> ICPResult:
    """One host copy of a (batch entry of a) result: numpy arrays for T
    and cov, numpy scalars for the rest."""
    def get(x):
        x = x.detach().cpu().numpy()
        return x if index is None else x[index]
    return ICPResult(T=get(result.T), iterations=get(result.iterations),
                     converged=get(result.converged),
                     max_iter_reached=get(result.max_iter_reached),
                     overlap=get(result.overlap),
                     residual=get(result.residual), cov=get(result.cov),
                     diverged=None if result.diverged is None
                     else get(result.diverged))


def match_clouds(points, mask, reference: Cloud, cfg: ICPConfig) -> Matches:
    check_supported(cfg)
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


def _match_and_weigh(points, mask, reference, cfg):
    matches = match_clouds(points, mask, reference, cfg)
    return matches, O.compute_weights(cfg.outlier, matches, mask)


def _icp_step(pts_in: Cloud, reference: Cloud, T, cfg: ICPConfig):
    """One match -> weigh -> minimize step: (delta @ T, delta)."""
    pts = se3.apply(T, pts_in.points)
    matches, weights = _match_and_weigh(pts, pts_in.mask, reference, cfg)
    elems = build_error_elements(pts, reference, matches, weights, cfg)
    if cfg.error == "point_to_plane":
        delta = M.point_to_plane(elems)
    else:
        delta = M.point_to_point(elems)
    return delta @ T, delta


class _Anderson:
    """Type-II Anderson acceleration on the window of the last ``m``
    se3-log twists taken relative to the stage entry ``T0``
    (``pgslam_tpu/ops/icp.py`` ``body_aa``): ``x_k = log(T T0^-1)``,
    ``g_k = log(T_plain T0^-1)``, the (m-1)x(m-1) system regularized by
    1e-10 I, and the extrapolation kept only when it lies within twice
    the plain step of ``g_k`` and the window has filled."""

    def __init__(self, T0, m: int):
        self.T0, self.m = T0, m
        self.Tinv0 = se3.inverse(T0)
        self.X = torch.zeros((m, 6), dtype=T0.dtype, device=T0.device)
        self.GX = torch.zeros_like(self.X)
        self.eye = torch.eye(m - 1, dtype=T0.dtype, device=T0.device)

    def __call__(self, T, T_plain, it: int):
        x_k = se3.log(T @ self.Tinv0)
        g_k = se3.log(T_plain @ self.Tinv0)
        self.X = torch.cat([x_k[None], self.X[:-1]])
        self.GX = torch.cat([g_k[None], self.GX[:-1]])
        Fr = self.GX - self.X
        dF = Fr[0] - Fr[1:]
        dG = self.GX[0] - self.GX[1:]
        # solve_ex: an exactly singular window (the zero-filled warm-up)
        # gives non-finite gamma, which the safeguard below rejects, as
        # the reference's LU solve does.
        gamma = torch.linalg.solve_ex(dF @ dF.T + 1e-10 * self.eye,
                                      dF @ Fr[0])[0]
        x_acc = g_k - gamma @ dG
        plain_sz = torch.linalg.norm(g_k - x_k)
        ok = (torch.linalg.norm(x_acc - g_k) <= 2.0 * plain_sz + 1e-9) \
            & (it + 1 >= self.m)
        return se3.exp(torch.where(ok, x_acc, g_k)) @ self.T0


def _icp_loop(reading: Cloud, reference: Cloud, T0, cfg: ICPConfig,
              max_iterations: int):
    L = max(1, cfg.smooth_length)
    dts = torch.full((L,), float("inf"), device=T0.device)
    drs = dts.clone()
    aa = (_Anderson(T0, cfg.anderson_m)
          if cfg.anderson_m and cfg.anderson_m > 1 else None)
    T, it, converged = T0, 0, False
    while it < max_iterations and not converged:
        T_plain, delta = _icp_step(reading, reference, T, cfg)
        if aa is not None:
            T_new = aa(T, T_plain, it)
            delta = T_new @ se3.inverse(T)
            T = T_new
        else:
            T = T_plain
        dts = torch.cat([se3.translation_norm(delta)[None], dts[:-1]])
        drs = torch.cat([se3.rotation_angle(delta)[None], drs[:-1]])
        converged = bool((dts.mean() < cfg.trans_eps)
                         & (drs.mean() < cfg.rot_eps))
        it += 1
    return T, it, converged


def decimate(cloud: Cloud, div: int) -> Cloud:
    """Strided decimation over scan order (contiguous copies, as the
    kernels require)."""
    return cloud.map(lambda a: a[::div].contiguous())


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
             cfg: ICPConfig) -> ICPResult:
    """The full ICP loop on pre-filtered clouds."""
    check_supported(cfg)
    T_start = T_init.to(torch.float32)
    T0 = T_start
    if cfg.coarse_div and cfg.coarse_div > 1:
        T0, _, _ = _icp_loop(decimate(reading, cfg.coarse_div), reference,
                             T0, cfg, cfg.coarse_iterations)
    T, iterations, converged = _icp_loop(reading, reference, T0, cfg,
                                         cfg.max_iterations)
    T, diverged = bound_check(T, T_start, cfg)
    converged = torch.tensor(converged, device=T.device) & ~diverged

    pts = se3.apply(T, reading.points)
    matches, weights = _match_and_weigh(pts, reading.mask, reference, cfg)
    elems = build_error_elements(pts, reference, matches, weights, cfg)
    iters = torch.tensor(iterations, dtype=torch.int32, device=T.device)
    return ICPResult(
        T=T, iterations=iters, converged=converged,
        max_iter_reached=(iters >= cfg.max_iterations) & ~converged,
        overlap=M.overlap(weights, reading.count()),
        residual=M.residual_error(elems, cfg.error),
        cov=M.covariance(elems, cfg.error), diverged=diverged)


def compute_overlap(reading: Cloud, reference: Cloud, T: torch.Tensor,
                    cfg: ICPConfig) -> torch.Tensor:
    """Partial-ICP overlap probe: match + weigh at T, no minimization."""
    pts = se3.apply(T, reading.points)
    _, weights = _match_and_weigh(pts, reading.mask, reference, cfg)
    return M.overlap(weights, reading.count())


def compute_residual(reading: Cloud, reference: Cloud, T: torch.Tensor,
                     cfg: ICPConfig) -> torch.Tensor:
    """Residual error of the reading matched at T."""
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


class ICPEngine:
    """Persistent pre-processed reference map across calls."""

    def __init__(self, config: ICPConfig = ICPConfig()):
        check_supported(config)
        reason = eps_dead_zone(config)
        if reason is not None:
            log.warning("[ICP] convergence checker can never fire (%s)",
                        reason)
        self.config = config
        self._reference: Optional[Cloud] = None

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
        self._reference = self.prepare_reference(reference)

    def prepare_reading(self, reading: Cloud) -> Cloud:
        return F.apply_chain(self.config.reading_filters, reading)

    def __call__(self, reading: Cloud, T_init: torch.Tensor) -> ICPResult:
        if self._reference is None:
            raise RuntimeError("ICPEngine: set_map() must be called first")
        return icp_core(self.prepare_reading(reading), self._reference,
                        T_init, self.config)
