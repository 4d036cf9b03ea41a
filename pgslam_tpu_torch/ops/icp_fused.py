"""A whole ICP registration in one kernel launch (K2).

``fused_icp_register`` is the wrapper: CUDA tensors launch the
hand-written kernel in ``csrc/icp_fused.cu`` (one thread-block cluster
per registration runs the whole loop, coarse stage included); CPU
tensors take ``fused_icp_register_plain``, the plain PyTorch version of
the same semantics. Both differ from ``icp_core`` in the same places the
TPU kernel does:

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
radix select on the float bits in the kernel, :func:`radix_threshold`
mirrors it; a sort here), so the keep-set is a sort's. The bound checker
and NaN guard run in the wrapper, on both paths.

Kernel note. Replaces ``pgslam_tpu/ops/icp_pallas.py::
fused_icp_register_prepped`` (body ``_icp_kernel``). On the H100 a
registration is bound by the fp32 instruction issue of its matcher
(NQ x NR pair evaluations per iteration: 16.8 M at the verification
shape of 2048 reading points against an 8192-point map, 1.07 G for the
headline batch of 128 x 1024 against 8192) and, at small batches, by the
latency of each iteration's reductions; bytes are negligible (the map is
read once per launch). The kernel runs one registration per
thread-block cluster of C CTAs, :func:`k2_layout` choosing C so that
batch x C fills the card, and the map slices S so that every warp of a
CTA has work: each CTA keeps the map and its own reading points' state
in shared memory, and every moment is summed in a fixed tree over the
point index (slot ``i mod TREE`` sums its points in order, ``TREE /
CHUNK`` warp trees over the slots are added in order) read across the
cluster, so the bits do not depend on C, S or the batch.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

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
MAX_ANDERSON = 4
# The kernel's fixed shape (csrc/icp_fused.cu): threads per CTA, points
# per chunk (one per lane), slots of the moment tree (slot i mod TREE,
# summed in TREE / CHUNK warp trees), chunks a warp matches at once, the
# widest moment vector, the threshold histogram and the CTA's other
# scalars (words).
THREADS = 512
CHUNK = 32
TREE = 512
KMAX = 8
NSUM = 29
HIST = 256
MISC_WORDS = 128
NFIELD = 10               # per point: pp[3], q[3], n[3], d2
# Cluster sizes: divisors of TREE / CHUNK, so that each slot chunk's
# points lie in one CTA.
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# NVIDIA H100 80GB HBM3: the shared memory a CTA may hold, and how many
# clusters of each size with one CTA per SM it holds at once
# (``pgs_icp_fused_limits`` on the card; GPCs of 16-18 SMs leave clusters
# of 8 and 16 fewer than 132 / C).
H100_SMEM_BYTES = 232448
H100_ACTIVE_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
# A map slice of fewer points leaves a warp more loop overhead than work.
MIN_SLICE = 256
# Shared memory above half an H100 SM's 228 KB (less 1 KB per CTA) keeps
# one CTA per SM: a batch whose CTAs fit the card then takes every SM
# rather than two CTAs on each of half of them.
ONE_CTA_PER_SM_BYTES = 118784


def fused_eligible(cfg: ICPConfig) -> bool:
    """Whether K2 covers this config's semantics: the gate of
    ``pgslam_tpu.ops.icp_pallas.fused_eligible``. Any chain of
    TrimmedDist and MaxDist filters, any ``smooth_length``, Anderson
    windows up to ``MAX_ANDERSON``."""
    return (cfg.error in ("point_to_plane", "point_to_point")
            and cfg.matcher in ("pallas", "brute")
            and cfg.knn == 1
            and (not cfg.anderson_m or cfg.anderson_m <= MAX_ANDERSON)
            and all(isinstance(f, (O.TrimmedDist, O.MaxDist))
                    for f in cfg.outlier))


def _anderson(cfg: ICPConfig) -> bool:
    return bool(cfg.anderson_m and cfg.anderson_m > 1)


def _outlier_params(cfg: ICPConfig):
    """The chain reduced to one TrimmedDist ratio and one MaxDist
    distance (-1 where the chain has none). Exact: every TrimmedDist
    thresholds the same hit set at its ``ceil(ratio * n)``-th smallest
    distance, which grows with the ratio, every MaxDist compares with
    its distance squared, and the masks multiply
    (``icp_pallas.py::weights_of``), so the smallest ratio and the
    smallest squared distance decide."""
    ratios = [f.ratio for f in cfg.outlier if isinstance(f, O.TrimmedDist)]
    dists = [abs(f.max_dist) for f in cfg.outlier
             if isinstance(f, O.MaxDist)]
    return (float(min(ratios)) if ratios else -1.0,
            float(min(dists)) if dists else -1.0)


# --------------------------------------------------------------------------
# Kernel layout
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class K2Layout:
    """How one registration is spread over a thread-block cluster.

    ``clusters`` CTAs (C) of ``threads`` threads; chunk ``c`` of CHUNK
    consecutive reading points belongs to CTA ``c % C``; a warp matches
    up to ``points_per_thread`` chunks at once against one of ``slices``
    (S) contiguous map slices; ``map_cap`` map points sit in each CTA's
    shared memory (the whole map when it is at least the map's size, else
    the map streams through in passes). ``local_chunks`` sizes the CTA's
    arrays. ``chunk`` and ``tree`` set the reduction order and depend on
    nothing."""
    clusters: int
    slices: int
    threads: int
    points_per_thread: int
    map_cap: int
    local_chunks: int
    smem_bytes: int
    chunk: int = CHUNK
    tree: int = TREE


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cta_bytes(map_cap: int, local_chunks: int, slices: int) -> int:
    """Shared memory of one CTA (``csrc/icp_fused.cu::cta_words``): the
    map (float4), per local point its state and each slice's best match,
    two exchange buffers (the slot-chunk sums or a histogram), the
    histogram totals and the scalars."""
    pmax = local_chunks * CHUNK
    xbuf = max(NSUM * TREE // CHUNK, HIST)
    return 4 * (4 * map_cap + (NFIELD + 3 * slices) * pmax + 2 * xbuf
                + HIST + MISC_WORDS)


def k2_layout(nq: int, nr: int, batch: int, budget: int = H100_SMEM_BYTES,
              active: dict = None, clusters: int = None,
              slices: int = None) -> K2Layout:
    """The layout for ``batch`` registrations of ``nq`` reading points
    against ``nr`` map points on a card whose CTAs may hold ``budget``
    bytes of shared memory and which holds ``active[C]`` clusters of C
    CTAs at once (H100_ACTIVE_CLUSTERS by default). C is the largest of
    CLUSTER_SIZES whose ``batch`` clusters the card holds at once (a
    registration's time falls with C, and a second wave would double it)
    and that gives every CTA a chunk of the reading, raised where the
    CTA's share of the reading leaves too little room for the whole map
    (the map then streams, at the smallest C that fits); S fills the CTA's
    warps with slices of at least MIN_SLICE map points. In one wave each
    CTA asks for at least ONE_CTA_PER_SM_BYTES, so that the clusters
    spread over the SMs as the occupancy counts assume. ``clusters`` and
    ``slices`` force C and S (layout timings and tests; the bits do not
    depend on them). Raises when no cluster holds the reading."""
    active = H100_ACTIVE_CLUSTERS if active is None else active
    nchunks = max(1, _cdiv(nq, CHUNK))
    sizes = [c for c in CLUSTER_SIZES if active.get(c, 0) >= 1]
    if not sizes:
        raise RuntimeError("K2: no thread-block cluster schedules")
    one_wave = [c for c in sizes if c <= nchunks and batch <= active[c]]
    first = max(one_wave) if one_wave else sizes[0]
    candidates = [clusters] if clusters else [c for c in sizes if c >= first]
    fits = []
    for C in candidates:
        if C not in sizes:
            break
        lc = _cdiv(nchunks, C)
        units = _cdiv(lc, KMAX)
        S = slices or max(1, min(THREADS // 32 // units,
                                 _cdiv(nr, MIN_SLICE)))
        map_cap = min(max(nr, 1), (budget - cta_bytes(0, lc, S)) // 16)
        if map_cap >= min(max(nr, 1), MIN_SLICE):
            smem = cta_bytes(map_cap, lc, S)
            if batch <= active[C]:
                smem = max(smem, min(budget, ONE_CTA_PER_SM_BYTES))
            fits.append(K2Layout(C, S, THREADS, min(KMAX, lc), map_cap, lc,
                                 smem))
            if map_cap >= nr:        # the whole map stays in the CTA
                return fits[-1]
    if fits:
        return fits[0]
    raise ValueError(f"K2: {nq} reading points do not fit a cluster of at "
                     f"most {sizes[-1]} CTAs with {budget} bytes each"
                     + (f" (forced C = {clusters}, S = {slices})"
                        if clusters or slices else ""))


def stage_slices(layout: K2Layout, n: int, nr: int, coarse: bool,
                 rank: int = 0) -> int:
    """Map slices of CTA ``rank`` in a stage of ``n`` points: the
    layout's S in the fine stage; in the coarse stage, with fewer chunks,
    as many as fill the warps and the staging rows hold
    (``csrc/icp_fused.cu::make_stage``)."""
    nchunks = _cdiv(n, CHUNK)
    lc = _cdiv(nchunks - rank, layout.clusters) if nchunks > rank else 0
    if not coarse:
        return layout.slices
    ss = max(1, lc) * CHUNK
    units = max(1, _cdiv(lc, KMAX))
    return max(1, min(THREADS // 32 // units,
                      layout.slices * layout.local_chunks * CHUNK // ss,
                      _cdiv(nr, MIN_SLICE)))


def k2_items(layout: K2Layout, n: int, nr: int, rank: int,
             coarse: bool = False):
    """The matcher's work in CTA ``rank`` for a stage of ``n`` points, as
    the kernel walks it: per map pass and warp item, (stage indices of the
    item's points, map range). Chunks past the stage's last are not
    visited; points past ``n`` in its last chunk are."""
    C = layout.clusters
    S = stage_slices(layout, n, nr, coarse, rank)
    nchunks = _cdiv(n, CHUNK)
    lc = _cdiv(nchunks - rank, C) if nchunks > rank else 0
    passes = max(1, _cdiv(nr, layout.map_cap))
    for p in range(passes):
        p0 = p * layout.map_cap
        m = min(layout.map_cap, nr - p0)
        for item in range(_cdiv(lc, KMAX) * S):
            u, sl = divmod(item, S)
            chunks = range(u * KMAX, min(lc, u * KMAX + KMAX))
            idx = [(rank + c * C) * CHUNK + lane for c in chunks
                   for lane in range(CHUNK)]
            yield idx, (p0 + sl * m // S, p0 + (sl + 1) * m // S)


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple:
    """(shared memory a CTA may hold, {C: clusters of C CTAs held at once})
    on CUDA device ``index``, from the kernel's occupancy queries."""
    from .. import _build
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(index):
        _build.check(_build.lib().pgs_icp_fused_limits(out),
                     "pgs_icp_fused_limits")
    return out[0], dict(zip(CLUSTER_SIZES, out[1:]))


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


def radix_threshold(d2, hit, ratio: float):
    """The kernel's TrimmedDist threshold, step for step: the
    ``ceil(ratio * n_hit)``-th smallest hit d2 (inf when that rank is
    below 1 or above the hit count) found by a radix select on the bit
    patterns, four passes of 8 bits from the top, each a 256-bin count of
    the hits that share the bits found so far. Non-negative floats order
    as their bits, so it is the sort's value, bit for bit. For tests: the
    plain version sorts (``outlier.trimmed_threshold``)."""
    inf = torch.tensor(float("inf"))
    live = (hit & torch.isfinite(d2)).reshape(-1)
    bits = d2.reshape(-1).to(torch.float32).view(torch.int32).to(
        torch.int64)[live]
    total = int(live.sum())
    k_keep = float(torch.ceil(torch.tensor(ratio, dtype=torch.float32)
                              * torch.tensor(float(total))))
    if k_keep < 1 or k_keep > total:
        return inf
    kk, prefix = int(k_keep), 0
    for shift in (24, 16, 8, 0):
        if shift < 24:
            bits = bits[(bits >> (shift + 8)) == (prefix >> (shift + 8))]
        hist = torch.bincount((bits >> shift) & 255, minlength=256)
        cum = torch.cumsum(hist, 0)
        b = int(torch.searchsorted(cum, torch.tensor(kk)))
        kk -= int(cum[b - 1]) if b else 0
        prefix |= b << shift
    return torch.tensor(prefix, dtype=torch.int32).view(torch.float32)


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

def _launch(reading: Cloud, reference: Cloud, T_init, cfg: ICPConfig,
            layout: K2Layout = None):
    from .. import _build
    dev = reading.points.device
    B, NQ = reading.points.shape[:2]
    NR = reference.points.shape[1]
    nrm = reference.descriptors.get("normals")
    if nrm is None:
        nrm = torch.zeros_like(reference.points)
    T0 = T_init.contiguous()
    args = [(reading.points, "reading", torch.float32, (B, NQ, 3)),
            (reading.mask, "reading_mask", torch.bool, (B, NQ)),
            (reference.points, "reference", torch.float32, (B, NR, 3)),
            (nrm, "normals", torch.float32, (B, NR, 3)),
            (reference.mask, "reference_mask", torch.bool, (B, NR)),
            (T0, "T_init", torch.float32, (B, 4, 4))]
    for t, name, dtype, shape in args:
        _build.require(t, name, dtype, shape, dev, "K2")
    if layout is None:
        budget, active = device_limits(
            dev.index if dev.index is not None
            else torch.cuda.current_device())
        layout = k2_layout(NQ, NR, B, budget, active)
    trim, maxd = _outlier_params(cfg)
    coarse = cfg.coarse_div if (cfg.coarse_div and cfg.coarse_div > 1) \
        else 0
    L = max(1, cfg.smooth_length)
    # MaxDist compares with maxd * maxd rounded once to fp32, as the
    # plain version does.
    params = (ctypes.c_float * 4)(cfg.trans_eps, cfg.rot_eps, trim,
                                  maxd * maxd if maxd >= 0 else -1.0)
    iparams = (ctypes.c_int * 5)(
        1 if cfg.error == "point_to_plane" else 0, cfg.max_iterations,
        cfg.coarse_iterations if coarse else 0, L,
        cfg.anderson_m if _anderson(cfg) else 0)
    window = torch.empty((B * layout.clusters, 2 * L), dtype=torch.float32,
                         device=dev)
    out = torch.empty((B, OUT_WIDTH), dtype=torch.float32, device=dev)
    # The launch goes to the current device: make it the tensors' (a
    # mesh's dp chunks may lie on several cards).
    with torch.cuda.device(dev):
        err = _build.lib().pgs_icp_fused(
            reading.points.data_ptr(), reading.mask.data_ptr(), NQ, coarse,
            reference.points.data_ptr(), nrm.data_ptr(),
            reference.mask.data_ptr(), NR, T0.data_ptr(), params, iparams,
            window.data_ptr(), out.data_ptr(), B, layout.clusters,
            layout.slices, layout.map_cap, layout.local_chunks,
            layout.smem_bytes, _build.stream_of(T0))
    if err == -2:
        raise RuntimeError(f"K2: no cluster of {layout.clusters} CTAs with "
                           f"{layout.smem_bytes} bytes of shared memory "
                           "each schedules")
    if err == -3:
        raise RuntimeError(f"K2: layout {layout} does not cover {NQ} "
                           "reading points in its shared memory")
    _build.check(err, "pgs_icp_fused")
    _build.count_launch(fused_icp_register, "k2", batch_sizes=B)
    fused_icp_register.layout = layout
    return out


def fused_icp_register(reading: Cloud, reference: Cloud,
                       T_init: torch.Tensor, cfg: ICPConfig,
                       layout: K2Layout = None) -> ICPResult:
    """K2 wrapper over stacked clouds (``[B, N, 3]`` points, ``[B, N]``
    masks, reference ``normals`` for point-to-plane) and ``T_init
    [B, 4, 4]``. Returns a batched :class:`ICPResult`. ``layout``
    overrides :func:`k2_layout`'s choice on the card (the result's bits
    do not depend on it); the CPU path has none."""
    if not fused_eligible(cfg):
        raise ValueError("config is not covered by the fused ICP kernel")
    dev = reading.points.device
    if dev.type == "cpu":
        out = fused_icp_register_plain(reading, reference, T_init, cfg)
    elif dev.type == "cuda":
        out = _launch(reading, reference, T_init, cfg, layout)
    else:
        raise ValueError(f"fused_icp_register: unsupported device {dev}")
    return result_from_rows(out, T_init, cfg)


fused_icp_register.launches = 0
# Launches per batch size (the fleet's registrations and verifications
# run at its agent count and above).
fused_icp_register.batch_sizes = collections.Counter()
# The K2Layout of the last launch.
fused_icp_register.layout = None


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
