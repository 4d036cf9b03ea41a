"""The whole Levenberg-Marquardt optimize in one kernel launch (K3).

``lm_optimize`` is the wrapper: CUDA tensors launch the hand-written
kernel in ``csrc/lm.cu``; CPU tensors take ``pgo.lm_optimize_plain``, the
plain PyTorch version with the same contract as
``pgslam_tpu.optim.pgo._optimize_xla``.

Kernel note. Replaces ``pgslam_tpu/optim/lm_pallas.py::
lm_optimize_pallas`` (body ``_lm_kernel``). On the H100 a pose-graph LM
at SLAM sizes (hundreds of poses) is bound by latency, not by FLOPs or
bytes: each LM iteration is a chain of dependent phases (per-edge
residuals and 6x6 Jacobian blocks, per-vertex accumulation, up to
``cg_iterations`` PCG steps of two dot products each, retraction, cost),
and between launches of small kernels the device would idle. The simple
design runs the whole loop in one 512-thread block: per-edge blocks go
to global scratch that the wrapper allocates, vertices gather their
edges through a CSR order the wrapper builds once per call (no float
atomics, so sums and accept/reject decisions repeat exactly), and every
reduction is a fixed-order block reduction. Scalars live in registers,
uniform across the block.
"""

from __future__ import annotations

import torch

from .pgo import PGOConfig, finish_poses, lm_optimize_plain

ROBUST_CODES = {"none": 0, "huber": 1, "cauchy": 2, "gm": 3}
# Scratch floats: per edge info[36] Zinv[16] Hff/Htt/Hft[3*36] bf/bt[12]
# yf/yt[12]; per vertex cur/cand[32] b[6] D[36] Pinv[36] x/r/z/p/Ap[30].
EDGE_SCRATCH = 36 + 16 + 108 + 12 + 12
VERTEX_SCRATCH = 32 + 6 + 36 + 36 + 30


def edge_csr(edge_from, edge_to, V: int, emask=None):
    """Per-vertex incidence lists in a fixed order: for each vertex its
    'from' ends, then its 'to' ends, each in edge order. Entries encode
    ``2 * edge + side``. Returns (ptr [V+1], entries [2E]) as int32.

    Edges off in ``emask`` contribute exact zeros and are left out of the
    lists (their entries follow ``ptr[V]``): ``Optimizer`` pads graphs
    with such edges, all at vertex 0, where one thread would otherwise
    walk them in every sum."""
    E = edge_from.shape[0]
    dev = edge_from.device
    ends = torch.cat([torch.clamp(edge_from.long(), 0, V - 1),
                      torch.clamp(edge_to.long(), 0, V - 1)])
    if emask is not None:
        ends = torch.where(emask.repeat(2), ends, V)
    side = torch.cat([torch.zeros(E, dtype=torch.long, device=dev),
                      torch.ones(E, dtype=torch.long, device=dev)])
    eidx = torch.arange(E, device=dev).repeat(2)
    order = torch.argsort((ends * 2 + side) * max(E, 1) + eidx)
    entries = (eidx * 2 + side)[order].to(torch.int32)
    counts = torch.bincount(ends, minlength=V + 1)[:V]
    ptr = torch.zeros(V + 1, dtype=torch.int32, device=dev)
    ptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return ptr, entries


def _launch(poses, vmask, edge_from, edge_to, edge_T, edge_cov, emask,
            fixed_id, robust_emask, config: PGOConfig):
    from .. import _build
    dev = poses.device
    V, E = poses.shape[0], edge_from.shape[0]
    poses = poses.to(torch.float32).contiguous()
    ef = edge_from.to(torch.int32).contiguous()
    et = edge_to.to(torch.int32).contiguous()
    eT = edge_T.to(torch.float32).contiguous()
    ec = edge_cov.to(torch.float32).contiguous()
    rmask = (torch.ones(E, dtype=torch.bool, device=dev)
             if robust_emask is None else robust_emask.contiguous())
    for t, name, dtype, shape in (
            (poses, "poses", torch.float32, (V, 4, 4)),
            (vmask, "vmask", torch.bool, (V,)),
            (ef, "edge_from", torch.int32, (E,)),
            (et, "edge_to", torch.int32, (E,)),
            (eT, "edge_T", torch.float32, (E, 4, 4)),
            (ec, "edge_cov", torch.float32, (E, 6, 6)),
            (emask, "emask", torch.bool, (E,)),
            (rmask, "robust_emask", torch.bool, (E,))):
        _build.require(t, name, dtype, shape, dev)
    fixed = int(fixed_id)
    if not 0 <= fixed < V:
        raise ValueError(f"fixed_id {fixed} outside 0..{V - 1}")
    ptr, entries = edge_csr(ef, et, V, emask)
    params = torch.tensor(
        [config.lambda_init, config.lambda_up, config.lambda_down,
         1.0 / config.prior_sigma ** 2, config.min_step_norm,
         config.min_cost_decrease, config.cg_tol, config.robust_delta],
        dtype=torch.float32, device=dev)
    iparams = torch.tensor(
        [config.max_iterations, config.cg_iterations,
         ROBUST_CODES[config.robust]], dtype=torch.int32, device=dev)
    scratch = torch.empty(E * EDGE_SCRATCH + V * VERTEX_SCRATCH,
                          dtype=torch.float32, device=dev)
    out = torch.empty((V, 4, 4), dtype=torch.float32, device=dev)
    stats = torch.empty(4, dtype=torch.float32, device=dev)
    err = _build.lib().pgs_lm(
        poses.data_ptr(), vmask.data_ptr(), V, ef.data_ptr(), et.data_ptr(),
        eT.data_ptr(), ec.data_ptr(), emask.data_ptr(), rmask.data_ptr(),
        E, fixed, ptr.data_ptr(), entries.data_ptr(), params.data_ptr(),
        iparams.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        stats.data_ptr(), _build.stream_of(poses))
    _build.check(err, "pgs_lm")
    lm_optimize.launches += 1
    return finish_poses(out, poses, vmask), {
        "initial_cost": stats[0], "final_cost": stats[1],
        "iterations": stats[2].to(torch.int32), "lambda": stats[3]}


def lm_optimize(poses, vmask, edge_from, edge_to, edge_T, edge_cov, emask,
                fixed_id, robust_emask=None, *,
                config: PGOConfig = PGOConfig()):
    """K3 wrapper: same contract as ``pgo.lm_optimize_plain``."""
    dev = poses.device
    if dev.type == "cpu":
        return lm_optimize_plain(poses, vmask, edge_from, edge_to, edge_T,
                                 edge_cov, emask, fixed_id, robust_emask,
                                 config=config)
    if dev.type != "cuda":
        raise ValueError(f"lm_optimize: unsupported device {dev}")
    return _launch(poses, vmask, edge_from, edge_to, edge_T, edge_cov,
                   emask, fixed_id, robust_emask, config)


lm_optimize.launches = 0
