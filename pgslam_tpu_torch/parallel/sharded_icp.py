"""Full ICP registration sharded over a (dp, tp) device mesh.
Counterpart of :mod:`pgslam_tpu.parallel.sharded_icp`.

The fleet's agents split over dp and each agent's reference cloud over
tp along its point axis. Per iteration every agent's reading is matched
against each reference shard on the shard's device (K1 on the card, its
plain version on the CPU), the candidate sets come back to the dp
group's first device and merge into the global k nearest
(:func:`.multichip.shard_match`), and the weights, the minimizer and the
checker run there, from the same helpers as ``ops/icp.py::icp_core``.

It keeps the reference's semantics, which differ from ``icp_core`` run
agent by agent:

* one loop per dp group of ``b = B / dp`` agents, run while the group's
  iteration count is below ``max_iterations`` and not every agent has
  converged. Every agent of the group takes ``delta @ T`` on every
  iteration, converged or not, its convergence is recomputed from its
  smoothed windows each time, and the group shares one iteration count.
  Results therefore depend on dp;
* no coarse stage, no Anderson acceleration, no grid index and no filter
  chains: callers pass prepared clouds (normals present for
  point-to-plane, else zeros are used), and every matcher is the exact
  one.

Where a group holds one agent, each step is ``icp_core``'s, so the result
equals ``icp_core`` on the same device bit for bit: the merged match is
K1's over the whole reference (ties by ``(d2, id)``), and the unmatched
slots of a query come from the first shard, whose id 0 is the whole
reference's.
"""

from __future__ import annotations

import torch

from .. import se3
from ..cloud import Cloud
from ..ops import minimizer as M
from ..ops import outlier as O
from ..ops.icp import ICPConfig, ICPResult, bound_check
from .batched import concat_results, stack_results
from .multichip import Mesh, check_divisible, shard_match, split_reference


def _elements(pts, cand_p, cand_n, weights, k: int) -> M.ErrorElements:
    """``build_error_elements`` from gathered candidates: the reading
    repeated k times, the candidates flattened in (query, slot) order."""
    return M.ErrorElements(
        reading=pts.repeat_interleave(k, 0) if k > 1 else pts,
        reference=cand_p.reshape(-1, 3), weights=weights.reshape(-1),
        normals=None if cand_n is None else cand_n.reshape(-1, 3))


def _register_group(cfg: ICPConfig, r_pts, r_mask, shards, T0, home):
    """One dp group: ``r_pts [b, N, 3]``, ``r_mask [b, N]`` and ``T0 [b,
    4, 4]`` on ``home``, ``shards[a]`` agent a's reference shards.
    Returns a batched ICPResult on ``home``."""
    b, k = r_pts.shape[0], cfg.knn
    p2plane = cfg.error == "point_to_plane"

    def match(a, T):
        pts = se3.apply(T, r_pts[a])
        mt, cand_p, cand_n = shard_match(pts, r_mask[a], shards[a], k, home,
                                         normals=p2plane)
        w = O.compute_weights(cfg.outlier, mt, r_mask[a])
        return _elements(pts, cand_p, cand_n, w, k), w

    T_start = T0.to(r_pts.dtype)
    Ts = [T_start[a] for a in range(b)]
    L = max(1, cfg.smooth_length)
    inf = torch.full((L,), float("inf"), dtype=T_start.dtype, device=home)
    dts, drs = [inf] * b, [inf] * b
    conv = torch.zeros(b, dtype=torch.bool, device=home)
    it = 0
    # One host read a group iteration: the group's all(converged).
    while it < cfg.max_iterations and not bool(conv.all()):
        flags = []
        for a in range(b):
            elems, _ = match(a, Ts[a])
            delta = (M.point_to_plane(elems) if p2plane
                     else M.point_to_point(elems))
            Ts[a] = delta @ Ts[a]
            dts[a] = torch.cat([se3.translation_norm(delta)[None],
                                dts[a][:-1]])
            drs[a] = torch.cat([se3.rotation_angle(delta)[None],
                                drs[a][:-1]])
            flags.append((dts[a].mean() < cfg.trans_eps)
                         & (drs[a].mean() < cfg.rot_eps))
        conv = torch.stack(flags)
        it += 1

    results = []
    for a in range(b):
        T, diverged = bound_check(Ts[a], T_start[a], cfg)
        converged = conv[a] & ~diverged
        elems, w = match(a, T)
        iters = torch.tensor(it, dtype=torch.int32, device=home)
        results.append(ICPResult(
            T=T, iterations=iters, converged=converged,
            max_iter_reached=(iters >= cfg.max_iterations) & ~converged,
            overlap=M.overlap(w, r_mask[a].sum(-1)),
            residual=M.residual_error(elems, cfg.error),
            cov=M.covariance(elems, cfg.error), diverged=diverged))
    return stack_results(results)


def make_sharded_register(mesh: Mesh, cfg: ICPConfig):
    """Build ``register(reading: Cloud[B, ...], reference: Cloud[B, ...],
    T0 [B, 4, 4]) -> ICPResult`` over the mesh, results on its first
    device.

    ``reading`` splits over dp (each group's rows on its first device);
    ``reference`` over dp and, along its points, into tp equal shards,
    shard j of group g on ``mesh.devices[g, j]``. ``B % dp`` or a
    reference capacity ``% tp`` other than 0 raises ``ValueError``.
    Reference clouds must be prepared, as for ``icp_core``."""
    dp = mesh.shape["dp"]
    p2plane = cfg.error == "point_to_plane"

    def register(reading: Cloud, reference: Cloud, T0: torch.Tensor
                 ) -> ICPResult:
        B = reading.points.shape[0]
        check_divisible(mesh, B, reference.points.shape[1])
        b = B // dp
        normals = reference.descriptors.get("normals") if p2plane else None
        parts = []
        for g in range(dp):
            home = mesh.devices[g, 0]
            rows = slice(g * b, (g + 1) * b)
            shards = split_reference(mesh, g, rows, reference.points,
                                     reference.mask, normals)
            parts.append(_register_group(
                cfg, reading.points[rows].to(home),
                reading.mask[rows].to(home), shards, T0[rows].to(home),
                home))
        return concat_results(parts, mesh.first)

    return register
