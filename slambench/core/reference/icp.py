"""Plain PyTorch ICP of the reference: match (exact k-NN) -> weigh
(trimmed and maximum distance) -> minimize (Kabsch, or one linearized
point-to-plane solve) -> the smoothed differential checker, with an
optional coarse stage on every ``coarse_div``-th reading point, the bound
checker, and the overlap and residual at the result.

A frozen copy of the plain path of ``pgslam_tpu_torch/ops/icp.py``
(``icp_core``), ``ops/outlier.py`` and ``ops/minimizer.py``, trimmed to
the configurations' options; it imports nothing of the program.

``cfg`` is an ICP section of a configuration file (a dict): ``error``,
``outlier`` (``[["TrimmedDist", {"ratio"}], ["MaxDist", {"max_dist"}]]``),
``max_iterations``, ``trans_eps``, ``rot_eps``, ``smooth_length``,
``max_correction_trans``, ``max_correction_rot``, ``coarse_div``,
``coarse_iterations``, ``reading_filters``, ``reference_filters``, and
``route``: ``"k2"`` runs the loop with the semantics of the program's
fused kernel (``k2.py``), which the fleet's batched paths run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import geometry as G
from . import k2 as K2

MIN_SUPPORT = 6.0


@dataclasses.dataclass
class Result:
    T: torch.Tensor
    iterations: int
    converged: bool
    max_iter_reached: bool
    diverged: bool
    overlap: float
    residual: float
    cov: Optional[torch.Tensor] = None   # K2's point-to-plane covariance


def weights(d2, query_mask, outlier):
    valid = torch.isfinite(d2) & query_mask[:, None]
    w = valid.to(d2.dtype)
    for name, p in outlier:
        if name == "TrimmedDist":
            s = torch.sort(torch.where(valid, d2, float("inf")).reshape(-1)
                           ).values
            kth = torch.ceil(torch.tensor(p["ratio"], dtype=d2.dtype,
                                          device=d2.device)
                             * valid.sum().to(d2.dtype)).to(torch.int64) - 1
            keep = d2 <= s[torch.clamp(kth, 0, s.shape[0] - 1)]
        elif name == "MaxDist":
            keep = d2 <= p["max_dist"] * p["max_dist"]
        else:
            raise ValueError(f"the reference has no outlier filter {name!r}")
        w = w * keep.to(w.dtype)
    return w


def _guard(delta, w):
    eye = torch.eye(4, dtype=delta.dtype, device=delta.device)
    return torch.where(w.sum() >= MIN_SUPPORT, delta, eye)


def point_to_point(p_in, q_in, w):
    wsum = torch.clamp(w.sum(), min=1e-12)
    wp = w[:, None]
    mu_p = (wp * p_in).sum(0) / wsum
    mu_q = (wp * q_in).sum(0) / wsum
    p, q = p_in - mu_p, q_in - mu_q
    H = (p * wp).T @ q
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.T @ U.T)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det),
                                det]))
    R = Vt.T @ D @ U.T
    return _guard(G.make(R, mu_q - R @ mu_p), w)


def _p2plane_system(p, q, n, w):
    r = (n * (p - q)).sum(-1)
    J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], -1)
    wJ = w[:, None] * J
    return wJ.T @ J, -(wJ * r[:, None]).sum(0)


def point_to_plane(p, q, n, w):
    A, b = _p2plane_system(p, q, n, w)
    A = A + 1e-6 * torch.eye(6, dtype=A.dtype, device=A.device)
    return _guard(G.exp(torch.linalg.solve(A, b)), w)


def _match(pts, mask, ref: G.Cloud, cfg):
    d2, ids = G.knn(pts, mask, ref.points, ref.mask, k=1)
    w = weights(d2, mask, cfg["outlier"]).reshape(-1)
    ids = ids.reshape(-1).long()
    n = ref.normals[ids] if cfg["error"] == "point_to_plane" else None
    return ref.points[ids], n, w


def _step(reading: G.Cloud, ref: G.Cloud, T, cfg):
    pts = G.apply(T, reading.points)
    q, n, w = _match(pts, reading.mask, ref, cfg)
    if cfg["error"] == "point_to_plane":
        delta = point_to_plane(pts, q, n, w)
    else:
        delta = point_to_point(pts, q, w)
    return delta @ T, delta


def _loop(reading, ref, T0, cfg, max_iterations):
    L = max(1, cfg.get("smooth_length", 4))
    dts = torch.full((L,), float("inf"), dtype=T0.dtype, device=T0.device)
    drs = dts.clone()
    T, it, converged = T0, 0, False
    while it < max_iterations and not converged:
        T, delta = _step(reading, ref, T, cfg)
        dts = torch.cat([G.translation_norm(delta)[None], dts[:-1]])
        drs = torch.cat([G.rotation_angle(delta)[None], drs[:-1]])
        converged = bool((dts.mean() < cfg["trans_eps"])
                         & (drs.mean() < cfg["rot_eps"]))
        it += 1
    return T, it, converged


def bound_check(T, T_start, cfg):
    """The bound checker and NaN guard: (T, or ``T_start`` where the
    correction is too large or not finite, and whether it was)."""
    dT = T @ G.inverse(T_start)
    diverged = bool(~torch.isfinite(T).all())
    if cfg.get("max_correction_trans", 0.0) > 0:
        diverged |= bool(G.translation_norm(dT) > cfg["max_correction_trans"])
    if cfg.get("max_correction_rot", 0.0) > 0:
        diverged |= bool(G.rotation_angle(dT) > cfg["max_correction_rot"])
    return (T_start if diverged else T), diverged


def register(reading: G.Cloud, ref: G.Cloud, T_init, cfg) -> Result:
    """The ICP loop on filtered clouds from ``T_init`` (4x4 tensor)."""
    T_start = T_init.to(reading.points.dtype)
    if cfg.get("route") == "k2":
        T, it, converged = K2.loop(reading, ref, T_start, cfg)
    else:
        T0 = T_start
        div = cfg.get("coarse_div", 0)
        if div and div > 1:
            coarse = G.Cloud(points=reading.points[::div].contiguous(),
                             mask=reading.mask[::div].contiguous())
            T0, _, _ = _loop(coarse, ref, T0, cfg, cfg["coarse_iterations"])
        T, it, converged = _loop(reading, ref, T0, cfg,
                                 cfg["max_iterations"])
    return finish(reading, ref, T, T_start, it, converged, cfg)


def register_batch(readings, refs, T_inits, cfg):
    """Registrations on the K2 route, a batch at once (``T_inits [B, 4,
    4]``): a :class:`Result` each."""
    T, it, conv = K2.loop_batch(readings, refs, T_inits, cfg)
    return [finish(readings[b], refs[b], T[b], T_inits[b], int(it[b]),
                   bool(conv[b]), cfg) for b in range(len(readings))]


def finish(reading, ref, T, T_start, it, converged, cfg) -> Result:
    """The bound checker, then the overlap and residual at the result."""
    T, diverged = bound_check(T, T_start, cfg)
    pts = G.apply(T, reading.points)
    q, n, w = _match(pts, reading.mask, ref, cfg)
    cov = None
    if cfg.get("route") == "k2":
        overlap, cov = K2.final(T, reading, ref, cfg)
    else:
        overlap = float(w.sum() / torch.clamp(reading.count().to(w.dtype),
                                              min=1.0))
    if cfg["error"] == "point_to_plane":
        r = (n * (pts - q)).sum(-1)
        residual = float((w * r * r).sum())
    else:
        residual = float((w * ((pts - q) ** 2).sum(-1)).sum())
    converged = converged and not diverged
    return Result(T=T, iterations=it, converged=converged,
                  max_iter_reached=it >= cfg["max_iterations"]
                  and not converged, diverged=diverged, overlap=overlap,
                  residual=residual, cov=cov)


def prepare_reference(cloud: G.Cloud, cfg) -> G.Cloud:
    """The reference chain, plus normals where point-to-plane needs them
    and the chain makes none."""
    chain = list(cfg.get("reference_filters", []))
    if cfg["error"] == "point_to_plane" and not any(
            name == "SurfaceNormal" for name, _ in chain):
        chain.append(["SurfaceNormal", {"knn": 8}])
    return G.apply_filters(chain, cloud)


def prepare_reading(cloud: G.Cloud, cfg) -> G.Cloud:
    return G.apply_filters(cfg.get("reading_filters", []), cloud)
