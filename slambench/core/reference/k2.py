"""Plain PyTorch ICP with the semantics of the program's fused
registration kernel (K2), which the fleet's batched registration and
batched verification, and every eligible loop-closure verification, run
on the card. It differs from the classic loop of ``icp.py`` where K2
does:

* matching averages the matched point, and its normal, over exact ties
  of the expanded squared distance (the classic loop takes the lowest
  id);
* the point-to-plane step solves the 6x6 system (regularized by 1e-6 I)
  by the closed-form Schur inverse, and its checker reads the norm of
  the twist's rotation;
* the point-to-point step takes the rotation as the orthogonal polar
  factor of the weighted cross-covariance by Newton's iteration
  ``X <- (X + X^-T) / 2`` (12 steps), not by SVD; too little support or
  a degenerate or reflecting cross-covariance gives the identity step;
  its checker reads the norm of the step's rotation log;
* the checker's sizes are summed left to right over the smoothing
  window;
* the overlap at the result is the kept weight over the valid reading
  points, and point-to-plane's covariance the residual's variance times
  the inverse of the final system (``final``).

A frozen copy of ``fused_icp_register_plain`` in
``pgslam_tpu_torch/ops/icp_fused.py`` without Anderson acceleration
(``_stage_aa``; no benchmarked configuration enables it); it imports
nothing of the program. It runs a batch of registrations at once, each
padded with masked points: every registration stops at its own
convergence, as one at a time would. The bound checker and the residual
stay with ``icp.register``.
"""

from __future__ import annotations

from typing import List

import torch

from . import geometry as G

MIN_SUPPORT = 6.0
POLAR_STEPS = 12
ERRORS = ("point_to_point", "point_to_plane")


def outlier_params(outlier):
    """A TrimmedDist / MaxDist chain as one ratio and one distance (-1
    where the chain has none): the smallest of each decides, since the
    masks multiply."""
    ratios = [p["ratio"] for n, p in outlier if n == "TrimmedDist"]
    dists = [abs(p["max_dist"]) for n, p in outlier if n == "MaxDist"]
    if len(ratios) + len(dists) != len(outlier):
        raise ValueError(f"K2 has no outlier filter among {outlier!r}")
    return (float(min(ratios)) if ratios else -1.0,
            float(min(dists)) if dists else -1.0)


def stack(clouds: List[G.Cloud]):
    """Clouds padded with masked points to one ``[B, N, 3]`` batch."""
    n = max(c.points.shape[0] for c in clouds)
    pts = torch.stack([torch.nn.functional.pad(c.points,
                                               (0, 0, 0, n - len(c.points)))
                       for c in clouds])
    mask = torch.stack([torch.nn.functional.pad(c.mask, (0, n - len(c.mask)))
                        for c in clouds])
    return pts, mask


def stack_normals(clouds: List[G.Cloud]):
    """The clouds' normals padded as :func:`stack` pads the points
    (zeros where a cloud has none)."""
    n = max(c.points.shape[0] for c in clouds)
    return torch.stack([torch.nn.functional.pad(
        torch.zeros_like(c.points) if c.normals is None else c.normals,
        (0, 0, 0, n - len(c.points))) for c in clouds])


def transform(T, p):
    """``R p + t`` per component, each row an FMA chain plus the
    translation (``T [B, 4, 4]``, ``p [B, N, 3]``)."""
    t = lambda i, j: T[:, i, j, None]
    rows = [torch.addcmul(torch.addcmul(t(i, 0) * p[..., 0], t(i, 1),
                                        p[..., 1]), t(i, 2), p[..., 2])
            + t(i, 3) for i in range(3)]
    return torch.stack(rows, -1)


def sq_dists(q, r):
    """All-pairs expanded squared distances ``[B, Nq, Nr]``."""
    cross = torch.addcmul(
        torch.addcmul(q[:, :, None, 0] * r[:, None, :, 0], q[:, :, None, 1],
                      r[:, None, :, 1]), q[:, :, None, 2], r[:, None, :, 2])
    return (G.sq_norm(q)[:, :, None] - 2.0 * cross) + G.sq_norm(r)[:, None, :]


def match(T, pts, mask, ref_pts, ref_mask, ref_nrm=None):
    """Exact 1-NN with tie averaging: (transformed points, matched
    points, squared distances, hits), and the matched normals where
    ``ref_nrm`` is given."""
    pp = transform(T, pts)
    d2e = torch.where(ref_mask[:, None, :], sq_dists(pp, ref_pts),
                      float("inf"))
    best = d2e.min(-1).values
    tie = (d2e == best[..., None]).to(torch.float32)
    cnt = torch.clamp(tie.sum(-1, keepdim=True), min=1.0)
    q = (tie @ ref_pts) / cnt
    hit = torch.isfinite(best) & mask
    d2 = torch.where(hit, G.sq_norm(pp - q), float("inf"))
    if ref_nrm is None:
        return pp, q, d2, hit
    return pp, q, d2, hit, (tie @ ref_nrm) / cnt


def weights(d2, hit, trim, maxd):
    w = hit.to(torch.float32)
    if trim >= 0:
        s = torch.sort(torch.where(hit, d2, float("inf")), -1).values
        kth = torch.ceil(torch.tensor(trim, dtype=d2.dtype, device=d2.device)
                         * hit.sum(-1).to(d2.dtype)).to(torch.int64) - 1
        thr = s.gather(-1, torch.clamp(kth, 0, s.shape[-1] - 1)[:, None])
        w = w * (d2 <= thr).float()
    if maxd >= 0:
        w = w * (d2 <= maxd * maxd).float()
    return w


def inv3(A):
    """Adjugate inverse of 3x3 matrices ``[B, 3, 3]``."""
    c1 = torch.linalg.cross(A[:, 1], A[:, 2], dim=-1)
    c2 = torch.linalg.cross(A[:, 2], A[:, 0], dim=-1)
    c3 = torch.linalg.cross(A[:, 0], A[:, 1], dim=-1)
    det = (A[:, 0] * c1).sum(-1)[:, None, None]
    return torch.stack([c1, c2, c3], -1) / det


def spd_inverse6(M):
    """Closed-form inverse of SPD 6x6 blocks via the Schur complement of
    the leading 3x3 block."""
    A, B, C = M[..., :3, :3], M[..., :3, 3:], M[..., 3:, 3:]
    Ai = inv3(A)
    AiB = Ai @ B
    Si = inv3(C - B.transpose(-1, -2) @ AiB)
    AiBSi = AiB @ Si
    TL = Ai + AiBSi @ AiB.transpose(-1, -2)
    TR = -AiBSi
    return torch.cat([torch.cat([TL, TR], -1),
                      torch.cat([TR.transpose(-1, -2), Si], -1)], -2)


def polar3(M):
    """Orthogonal polar factor by Newton's iteration, scale-initialized."""
    X = M / torch.sqrt((M * M).sum((-1, -2)) + 1e-30)[:, None, None]
    for _ in range(POLAR_STEPS):
        X = 0.5 * (X + inv3(X).transpose(-1, -2))
    return X


def point_to_point(pp, q, w):
    wsum_raw = w.sum(-1)
    wsum = torch.clamp(wsum_raw, min=1e-12)[:, None]
    mup = (w[..., None] * pp).sum(-2) / wsum
    muq = (w[..., None] * q).sum(-2) / wsum
    M = (w[..., None] * (q - muq[:, None])).transpose(-1, -2) \
        @ (pp - mup[:, None])
    ok = ((wsum_raw >= MIN_SUPPORT) & (torch.linalg.det(M) > 1e-12))
    eye = torch.eye(3, dtype=pp.dtype, device=pp.device).expand_as(M)
    R = torch.where(ok[:, None, None], polar3(M), eye)
    t = torch.where(ok[:, None], muq - (R @ mup[..., None])[..., 0],
                    torch.zeros_like(mup))
    return G.make(R, t)


def p2plane_moments(pp, q, n, w):
    """The weighted point-to-plane system ``(A [B, 6, 6], b [B, 6])``,
    the squared residuals' sum and the kept weight."""
    r = (n * (pp - q)).sum(-1)
    J = torch.cat([n, torch.linalg.cross(pp, n, dim=-1)], -1)
    wJ = w[..., None] * J
    return (wJ.transpose(-1, -2) @ J, -(wJ * r[..., None]).sum(-2),
            (w * r * r).sum(-1), w.sum(-1))


def point_to_plane(pp, q, n, w):
    """(step, twist): the regularized system solved by the Schur inverse,
    the zero twist with too little support."""
    A, b, _, wsum = p2plane_moments(pp, q, n, w)
    eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
    x = (spd_inverse6(A + 1e-6 * eye6) @ b[..., None])[..., 0]
    x = torch.where((wsum >= MIN_SUPPORT)[:, None], x, torch.zeros_like(x))
    return G.exp(x), x


def _fsum(xs):
    acc = torch.zeros_like(xs[0])
    for x in xs:
        acc = acc + x
    return acc


def _stage(T, pts, mask, ref_pts, ref_mask, ref_nrm, cfg, trim, maxd,
           max_it):
    L = max(1, cfg.get("smooth_length", 4))
    inf = torch.full((T.shape[0],), float("inf"), device=T.device)
    dts, drs = [inf] * L, [inf] * L
    it = torch.zeros(T.shape[0], dtype=torch.int64, device=T.device)
    conv = torch.zeros(T.shape[0], dtype=torch.bool, device=T.device)
    for _ in range(max_it):
        live = ~conv
        if not bool(live.any()):
            break
        if ref_nrm is None:
            pp, q, d2, hit = match(T, pts, mask, ref_pts, ref_mask)
            delta = point_to_point(pp, q, weights(d2, hit, trim, maxd))
            x = G.log(delta)
        else:
            pp, q, d2, hit, n = match(T, pts, mask, ref_pts, ref_mask,
                                      ref_nrm)
            delta, x = point_to_plane(pp, q, n,
                                      weights(d2, hit, trim, maxd))
        T = torch.where(live[:, None, None], delta @ T, T)
        dt = torch.sqrt(G.sq_norm(delta[:, :3, 3]))
        dr = torch.sqrt(G.sq_norm(x[:, 3:6]))
        dts = [torch.where(live, a, b) for a, b in zip([dt] + dts[:-1], dts)]
        drs = [torch.where(live, a, b) for a, b in zip([dr] + drs[:-1], drs)]
        it = it + live.to(it.dtype)
        conv = conv | (live & (_fsum(dts) / L < cfg["trans_eps"])
                       & (_fsum(drs) / L < cfg["rot_eps"]))
    return T, it, conv


def loop_batch(readings: List[G.Cloud], refs: List[G.Cloud], T0, cfg):
    """K2's loop, coarse stage included, over a batch (``T0 [B, 4,
    4]``): (T, iterations, converged), each with the batch axis."""
    if cfg["error"] not in ERRORS or (cfg.get("anderson_m") or 0) > 1:
        raise ValueError("the K2 reference covers point-to-point and "
                         "point-to-plane without Anderson acceleration")
    trim, maxd = outlier_params(cfg["outlier"])
    pts, mask = stack(readings)
    ref_pts, ref_mask = stack(refs)
    ref_nrm = (stack_normals(refs) if cfg["error"] == "point_to_plane"
               else None)
    T = T0.to(torch.float32)
    div = cfg.get("coarse_div", 0)
    if div and div > 1:
        T, _, _ = _stage(T, pts[:, ::div], mask[:, ::div], ref_pts,
                         ref_mask, ref_nrm, cfg, trim, maxd,
                         cfg["coarse_iterations"])
    return _stage(T, pts, mask, ref_pts, ref_mask, ref_nrm, cfg, trim, maxd,
                  cfg["max_iterations"])


def loop(reading: G.Cloud, ref: G.Cloud, T0, cfg):
    """One registration: (T, iterations, converged)."""
    T, it, conv = loop_batch([reading], [ref], T0[None], cfg)
    return T[0], int(it[0]), bool(conv[0])


def final(T, reading: G.Cloud, ref: G.Cloud, cfg):
    """K2's closing pass at ``T``: (the kept weight over the valid
    reading points, and for point-to-plane the covariance ``[6, 6]``, the
    residual's variance times the inverse of the final system; None for
    point-to-point)."""
    trim, maxd = outlier_params(cfg["outlier"])
    lift = (T[None], reading.points[None], reading.mask[None],
            ref.points[None], ref.mask[None])
    if cfg["error"] != "point_to_plane":
        _, _, d2, hit = match(*lift)
        w = weights(d2, hit, trim, maxd)
        return float(w.sum() / torch.clamp(reading.mask.sum().float(),
                                           min=1.0)), None
    pp, q, d2, hit, n = match(*lift, stack_normals([ref]))
    w = weights(d2, hit, trim, maxd)
    A, _, ssr, wsum = p2plane_moments(pp, q, n, w)
    eye6 = torch.eye(6, device=T.device)
    cov = ((ssr / torch.clamp(wsum - 6.0, min=1.0))[:, None, None]
           * spd_inverse6(A + 1e-9 * eye6) + 1e-12 * eye6)
    overlap = w.sum() / torch.clamp(reading.mask.sum().float(), min=1.0)
    return float(overlap), cov[0]
