"""A whole ICP registration in one kernel launch (K2).

``fused_icp_register`` is the wrapper: CUDA tensors launch the
hand-written kernel in ``csrc/icp_fused.cu`` (one thread block per
registration runs the whole loop, coarse stage included); CPU tensors
take ``fused_icp_register_plain``, the plain PyTorch version of the same
semantics. Both differ from ``icp_core`` in the same places the TPU
kernel does:

* matching averages the matched point and normal over exact ties of the
  expanded squared distance (``icp_core`` takes the lowest id);
* the point-to-plane step solves the 6x6 system by the closed-form Schur
  inverse, and the rotation test reads the twist norm;
* the point-to-point step takes the rotation as the orthogonal polar
  factor of the weighted cross-covariance by Newton's iteration
  ``X <- (X + X^-T) / 2`` (12 steps, as ``ops/rowmath.py::_polar3``),
  not by SVD; a degenerate or reflecting cross-covariance gives the
  identity step.

The TrimmedDist threshold is the exact kth-smallest squared distance (a
binary search on the float bits in the kernel, a sort here), so the
keep-set is a sort's. The bound checker and NaN guard run in the
wrapper, on both paths.

Kernel note. Replaces ``pgslam_tpu/ops/icp_pallas.py::
fused_icp_register_prepped`` (body ``_icp_kernel``). On the H100 a
registration at the verification shape (2048 reading points against an
8192-point map, up to 8 coarse and 24 fine iterations) is bound by the
fp32 instruction issue of the matcher, at most ~0.44 G (reading, map)
pair evaluations, and by the block
barriers of its per-iteration reductions; bytes are negligible (the map
is 229 KB and stays in L2). The simple design runs the registration in
one 512-thread block: map tiles stream through shared memory, each
thread keeps the running best of four reading points in registers,
moments are block reductions in fp32 with a fixed order, and thread 0
does the 6x6 solve and the SE(3) update. One block per registration uses
one SM of 132; batching registrations fills the card.
"""

from __future__ import annotations

import collections

import torch

from .. import se3
from ..cloud import Cloud
from . import outlier as O
from .icp import ICPConfig, ICPResult, bound_check
from .knn import sq_dists, sq_norm
from .minimizer import MIN_SUPPORT

# Kernel output row per registration: T[16], iterations, converged,
# overlap, residual, cov[36].
OUT_WIDTH = 56
# Per reading point: transformed point, matched point, matched normal, d2.
SCRATCH_WIDTH = 10
MAX_SMOOTH = 8
MAX_ANDERSON = 4


def fused_eligible(cfg: ICPConfig) -> bool:
    """Whether K2 covers this config's semantics. As in the JAX package,
    Anderson windows up to ``MAX_ANDERSON`` are eligible. Narrower than
    it: at most one TrimmedDist and one MaxDist, and ``smooth_length``
    at most ``MAX_SMOOTH`` (such configs run ``icp_core``)."""
    n_trim = sum(isinstance(f, O.TrimmedDist) for f in cfg.outlier)
    n_max = sum(isinstance(f, O.MaxDist) for f in cfg.outlier)
    return (cfg.error in ("point_to_plane", "point_to_point")
            and cfg.matcher in ("pallas", "brute")
            and cfg.knn == 1
            and (not cfg.anderson_m or cfg.anderson_m <= MAX_ANDERSON)
            and n_trim + n_max == len(cfg.outlier)
            and n_trim <= 1 and n_max <= 1
            and max(1, cfg.smooth_length) <= MAX_SMOOTH)


def _anderson(cfg: ICPConfig) -> bool:
    return bool(cfg.anderson_m and cfg.anderson_m > 1)


def _outlier_params(cfg: ICPConfig):
    trim = next((f.ratio for f in cfg.outlier
                 if isinstance(f, O.TrimmedDist)), -1.0)
    maxd = next((f.max_dist for f in cfg.outlier
                 if isinstance(f, O.MaxDist)), -1.0)
    return float(trim), float(maxd)


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------

def _transform_points(T, p):
    """R p + t per component, each row an FMA chain plus the translation
    (the kernel's arithmetic)."""
    rows = [torch.addcmul(torch.addcmul(T[i, 0] * p[:, 0], T[i, 1], p[:, 1]),
                          T[i, 2], p[:, 2]) + T[i, 3] for i in range(3)]
    return torch.stack(rows, -1)


def _match(T, pts, mask, ref_pts, ref_nrm, ref_mask):
    """Exact 1-NN with tie averaging. Returns (pp, matched point, matched
    normal, d2, hit)."""
    pp = _transform_points(T, pts)
    d2e = sq_dists(pp, ref_pts)
    d2e = torch.where(ref_mask[None, :], d2e, float("inf"))
    best = d2e.min(1).values
    tie = (d2e == best[:, None]).to(torch.float32)
    cnt = torch.clamp(tie.sum(1, keepdim=True), min=1.0)
    q = (tie @ ref_pts) / cnt
    n = (tie @ ref_nrm) / cnt
    hit = torch.isfinite(best) & mask
    d2 = torch.where(hit, sq_norm(pp - q), float("inf"))
    return pp, q, n, d2, hit


def _weights(d2, hit, trim, maxd):
    w = hit.to(torch.float32)
    if trim >= 0:
        w = w * (d2 <= O.trimmed_threshold(d2, hit, trim)).float()
    if maxd >= 0:
        w = w * (d2 <= maxd * maxd).float()
    return w


def _p2plane_moments(pp, q, n, w):
    r = (n * (pp - q)).sum(-1)
    J = torch.cat([n, torch.linalg.cross(pp, n, dim=-1)], -1)
    wJ = w[:, None] * J
    return wJ.T @ J, -(wJ * r[:, None]).sum(0), (w * r * r).sum(), w.sum()


def polar3(G, iters: int = 12):
    """Orthogonal polar factor by Newton's iteration, scale-initialized."""
    from ..optim.pgo import inv3
    X = G / torch.sqrt((G * G).sum() + 1e-30)
    for _ in range(iters):
        X = 0.5 * (X + inv3(X).T)
    return X


def _p2point_delta(pp, q, w):
    eye = torch.eye(3, dtype=pp.dtype, device=pp.device)
    wsum_raw = w.sum()
    wsum = torch.clamp(wsum_raw, min=1e-12)
    mup = (w[:, None] * pp).sum(0) / wsum
    muq = (w[:, None] * q).sum(0) / wsum
    G = ((w[:, None] * (q - muq)).T @ (pp - mup))
    ok = (wsum_raw >= MIN_SUPPORT) & (torch.linalg.det(G) > 1e-12)
    R = torch.where(ok, polar3(G), eye)
    t = torch.where(ok, muq - R @ mup, torch.zeros_like(mup))
    return se3.make(R, t)


def _step(T, pts, mask, ref, cfg, trim, maxd):
    """One match -> weigh -> minimize step: (delta, twist of delta)."""
    from ..optim.pgo import spd_inverse6
    pp, q, n, d2, hit = _match(T, pts, mask, *ref)
    w = _weights(d2, hit, trim, maxd)
    if cfg.error == "point_to_plane":
        A, b, _, wsum = _p2plane_moments(pp, q, n, w)
        x = spd_inverse6(A + 1e-6 * torch.eye(6, device=T.device)) @ b
        x = torch.where(wsum >= MIN_SUPPORT, x, torch.zeros_like(x))
        return se3.exp(x), x
    delta = _p2point_delta(pp, q, w)
    return delta, se3.log(delta)


def _checker(dts, drs, dt, dr, cfg):
    """Push one step's translation and rotation sizes into the smoothed
    windows; returns (dts, drs, converged)."""
    L = len(dts)
    dts, drs = [dt] + dts[:-1], [dr] + drs[:-1]
    conv = bool((_fsum(dts) / L < cfg.trans_eps)
                & (_fsum(drs) / L < cfg.rot_eps))
    return dts, drs, conv


def _stage(T, pts, mask, ref, cfg, trim, maxd, max_it):
    L = max(1, cfg.smooth_length)
    inf = torch.tensor(float("inf"), device=T.device)
    dts, drs = [inf] * L, [inf] * L
    it, conv = 0, False
    while it < max_it and not conv:
        delta, x = _step(T, pts, mask, ref, cfg, trim, maxd)
        T = delta @ T
        dts, drs, conv = _checker(dts, drs,
                                  torch.sqrt(sq_norm(delta[:3, 3])),
                                  torch.sqrt(sq_norm(x[3:6])), cfg)
        it += 1
    return T, it, conv


def _dot(a, b):
    """Left-to-right sum of the products of the last axis (the kernel's
    order)."""
    acc = a[..., 0] * b[..., 0]
    for d in range(1, a.shape[-1]):
        acc = acc + a[..., d] * b[..., d]
    return acc


def solve_small(A, rhs):
    """Closed-form solve of the (n <= 3) regularized AA system, as
    ``icp_pallas.py::solve_small``: n = 1 divides, n = 2 by Cramer's
    rule, n = 3 by the adjugate inverse."""
    from ..optim.pgo import inv3
    n = rhs.shape[0]
    if n == 1:
        return rhs / A[0, 0]
    if n == 2:
        rdet = 1.0 / (A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0])
        return torch.stack([(A[1, 1] * rhs[0] - A[0, 1] * rhs[1]) * rdet,
                            (A[0, 0] * rhs[1] - A[1, 0] * rhs[0]) * rdet])
    return _dot(inv3(A), rhs[None, :])


def _stage_aa(T, pts, mask, ref, cfg, trim, maxd, max_it):
    """The Anderson-accelerated stage (``anderson_m`` in 2..4), line for
    line as ``icp_pallas.py::run_stage_aa``: type-II AA on the window of
    se3-log twists relative to the stage entry, the (m-1)x(m-1) system
    regularized by 1e-10 I and solved in closed form, the extrapolation
    kept only within twice the plain step of ``g_k`` once the window has
    filled; the checker reads ``dTm = T_new T^-1``."""
    m = cfg.anderson_m
    L = max(1, cfg.smooth_length)
    inf = torch.tensor(float("inf"), device=T.device)
    dts, drs = [inf] * L, [inf] * L
    T0 = T
    Tinv0 = se3.inverse(T0)
    X = torch.zeros((m, 6), device=T.device)
    GX = torch.zeros_like(X)
    reg = 1e-10 * torch.eye(m - 1, device=T.device)
    it, conv = 0, False
    while it < max_it and not conv:
        delta, _ = _step(T, pts, mask, ref, cfg, trim, maxd)
        T_plain = delta @ T
        x_k = se3.log(T @ Tinv0)
        g_k = se3.log(T_plain @ Tinv0)
        X = torch.cat([x_k[None], X[:-1]])
        GX = torch.cat([g_k[None], GX[:-1]])
        Fr = GX - X
        dF = Fr[0] - Fr[1:]
        dG = GX[0] - GX[1:]
        A = _dot(dF[:, None, :], dF[None, :, :]) + reg
        gamma = solve_small(A, _dot(dF, Fr[0][None, :]))
        x_acc = g_k - _dot(gamma[None, :], dG.T)
        plain_sz = torch.sqrt(_dot(g_k - x_k, g_k - x_k))
        acc_sz = torch.sqrt(_dot(x_acc - g_k, x_acc - g_k))
        ok = (acc_sz <= 2.0 * plain_sz + 1e-9) & (it + 1 >= m)
        T_new = se3.exp(torch.where(ok, x_acc, g_k)) @ T0
        dTm = T_new @ se3.inverse(T)
        dlog = se3.log(dTm)
        T = T_new
        dts, drs, conv = _checker(dts, drs, torch.sqrt(sq_norm(dTm[:3, 3])),
                                  torch.sqrt(sq_norm(dlog[3:6])), cfg)
        it += 1
    return T, it, conv


def _fsum(xs):
    """Left-to-right fp32 sum, as the kernel adds its checker window."""
    acc = torch.zeros((), device=xs[0].device)
    for x in xs:
        acc = acc + x
    return acc


def _final(T, pts, mask, ref, cfg, trim, maxd):
    from ..optim.pgo import spd_inverse6
    pp, q, n, d2, hit = _match(T, pts, mask, *ref)
    w = _weights(d2, hit, trim, maxd)
    eye6 = torch.eye(6, device=T.device)
    if cfg.error == "point_to_plane":
        A, _, ssr, wsum = _p2plane_moments(pp, q, n, w)
        dof = torch.clamp(wsum - 6.0, min=1.0)
    else:
        d = pp - q
        ssr = (w * sq_norm(d)).sum()
        wsum = w.sum()
        Sp = (w[:, None] * pp).sum(0)
        Spp = (w[:, None] * pp).T @ pp
        eye3 = torch.eye(3, device=T.device)
        hS = se3.hat(Sp)
        A = torch.cat([torch.cat([wsum * eye3, -hS], 1),
                       torch.cat([-hS.T, torch.trace(Spp) * eye3 - Spp], 1)])
        dof = torch.clamp(3.0 * wsum - 6.0, min=1.0)
    n_valid = mask.sum().to(torch.float32)
    overlap = wsum / torch.clamp(n_valid, min=1.0)
    cov = (ssr / dof) * spd_inverse6(A + 1e-9 * eye6) + 1e-12 * eye6
    return overlap, ssr, cov


def _register_one_plain(rd_pts, rd_mask, ref, T0, cfg):
    trim, maxd = _outlier_params(cfg)
    stage = _stage_aa if _anderson(cfg) else _stage
    T = T0
    if cfg.coarse_div and cfg.coarse_div > 1:
        d = cfg.coarse_div
        T, _, _ = stage(T, rd_pts[::d], rd_mask[::d], ref, cfg, trim, maxd,
                        cfg.coarse_iterations)
    T, it, conv = stage(T, rd_pts, rd_mask, ref, cfg, trim, maxd,
                        cfg.max_iterations)
    overlap, ssr, cov = _final(T, rd_pts, rd_mask, ref, cfg, trim, maxd)
    row = torch.cat([T.reshape(16),
                     torch.tensor([float(it), float(conv)], device=T.device),
                     overlap.reshape(1), ssr.reshape(1), cov.reshape(36)])
    return row


def fused_icp_register_plain(reading: Cloud, reference: Cloud,
                             T_init: torch.Tensor, cfg: ICPConfig
                             ) -> torch.Tensor:
    """Plain PyTorch version of K2; returns the ``[B, 56]`` output rows
    the kernel writes."""
    rows = []
    for b in range(reading.points.shape[0]):
        nrm = reference.descriptors.get("normals")
        nrm = torch.zeros_like(reference.points[b]) if nrm is None \
            else nrm[b]
        ref = (reference.points[b], nrm, reference.mask[b])
        rows.append(_register_one_plain(reading.points[b], reading.mask[b],
                                        ref, T_init[b].float(), cfg))
    return torch.stack(rows)


# --------------------------------------------------------------------------
# Wrapper
# --------------------------------------------------------------------------

def _launch(reading: Cloud, reference: Cloud, T_init, cfg: ICPConfig):
    from .. import _build
    dev = reading.points.device
    B, NQ = reading.points.shape[:2]
    NR = reference.points.shape[1]
    nrm = reference.descriptors.get("normals")
    if nrm is None:
        nrm = torch.zeros_like(reference.points)
    T0 = T_init.to(torch.float32).contiguous()
    args = [(reading.points, "reading", torch.float32, (B, NQ, 3)),
            (reading.mask, "reading_mask", torch.bool, (B, NQ)),
            (reference.points, "reference", torch.float32, (B, NR, 3)),
            (nrm, "normals", torch.float32, (B, NR, 3)),
            (reference.mask, "reference_mask", torch.bool, (B, NR)),
            (T0, "T_init", torch.float32, (B, 4, 4))]
    for t, name, dtype, shape in args:
        _build.require(t, name, dtype, shape, dev)
    trim, maxd = _outlier_params(cfg)
    coarse = cfg.coarse_div if (cfg.coarse_div and cfg.coarse_div > 1) \
        else 0
    # MaxDist compares with maxd * maxd rounded once to fp32, as the
    # plain version does.
    params = torch.tensor([cfg.trans_eps, cfg.rot_eps, trim,
                           maxd * maxd if maxd >= 0 else -1.0],
                          dtype=torch.float32, device=dev)
    iparams = torch.tensor(
        [1 if cfg.error == "point_to_plane" else 0, cfg.max_iterations,
         cfg.coarse_iterations if coarse else 0,
         max(1, cfg.smooth_length),
         cfg.anderson_m if _anderson(cfg) else 0],
        dtype=torch.int32, device=dev)
    scratch = torch.empty((B, NQ, SCRATCH_WIDTH), dtype=torch.float32,
                          device=dev)
    out = torch.empty((B, OUT_WIDTH), dtype=torch.float32, device=dev)
    err = _build.lib().pgs_icp_fused(
        reading.points.data_ptr(), reading.mask.data_ptr(), NQ, coarse,
        reference.points.data_ptr(), nrm.data_ptr(),
        reference.mask.data_ptr(), NR, T0.data_ptr(), params.data_ptr(),
        iparams.data_ptr(), scratch.data_ptr(), out.data_ptr(), B,
        _build.stream_of(T0))
    _build.check(err, "pgs_icp_fused")
    fused_icp_register.launches += 1
    fused_icp_register.batch_sizes[B] += 1
    return out


def fused_icp_register(reading: Cloud, reference: Cloud,
                       T_init: torch.Tensor, cfg: ICPConfig) -> ICPResult:
    """K2 wrapper over stacked clouds (``[B, N, 3]`` points, ``[B, N]``
    masks, reference ``normals`` for point-to-plane) and ``T_init
    [B, 4, 4]``. Returns a batched :class:`ICPResult`."""
    if not fused_eligible(cfg):
        raise ValueError("config is not covered by the fused ICP kernel")
    dev = reading.points.device
    if dev.type == "cpu":
        out = fused_icp_register_plain(reading, reference, T_init, cfg)
    elif dev.type == "cuda":
        out = _launch(reading, reference, T_init, cfg)
    else:
        raise ValueError(f"fused_icp_register: unsupported device {dev}")
    return result_from_rows(out, T_init, cfg)


fused_icp_register.launches = 0
# Launches per batch size (the fleet's registrations and verifications
# run at its agent count and above).
fused_icp_register.batch_sizes = collections.Counter()


def result_from_rows(out: torch.Tensor, T_init, cfg) -> ICPResult:
    """Kernel output rows -> ICPResult, with the bound checker and NaN
    guard."""
    B = out.shape[0]
    T, diverged = bound_check(out[:, :16].reshape(B, 4, 4),
                              T_init.to(torch.float32), cfg)
    iters = out[:, 16].to(torch.int32)
    converged = (out[:, 17] > 0.5) & ~diverged
    return ICPResult(T=T, iterations=iters, converged=converged,
                     max_iter_reached=(iters >= cfg.max_iterations)
                     & ~converged,
                     overlap=out[:, 18], residual=out[:, 19],
                     cov=out[:, 20:56].reshape(B, 6, 6), diverged=diverged)
