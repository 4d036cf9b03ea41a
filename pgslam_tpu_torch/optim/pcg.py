"""The block-Jacobi PCG solve of one LM step in one kernel launch (K4).

``pcg_solve`` is the wrapper: CUDA tensors launch the hand-written kernel
in ``csrc/pcg.cu``; CPU tensors take ``pgo.pcg_solve_plain``, its plain
version.

Kernel note. Replaces ``pgslam_tpu/optim/pcg_pallas.py::
pcg_solve_pallas``, the route for graphs too large for the whole-LM
kernel K3, which runs in one thread block. One CG step at V=1024 / E=2048
reads about 1.3 MB (three 6x6 blocks per edge and the vertex vectors),
about 0.4 us at 3.35 TB/s; what sets its time is the dependence between
its phases. The kernel is one cooperative launch over as many blocks as
the card holds at once (at most one thread per edge): grid-stride loops
over edges (the 6x6 block products) and over vertices (the CSR-ordered
sums, the preconditioner and the vector updates), three grid barriers
per CG step. There are no float atomics: vertices sum their edges in the
order of ``lm.edge_csr``, and each dot product is a per-block partial
summed by every block in the same fixed order, so a solve repeats bit
for bit and every block takes the same stop decision.
"""

from __future__ import annotations

import ctypes

import torch

from .pgo import pcg_solve_plain

MAX_GRID = 4096   # partial-sum slots; must match csrc/pcg.cu


def _launch(blocks, P_inv, damp_diag, b, prior_info, fixed_id, edge_from,
            edge_to, cg_iterations, cg_tol, csr):
    from .. import _build
    from .lm import edge_csr
    dev = b.device
    V, E = b.shape[0], blocks[0].shape[0]
    for t, name, shape in (
            (blocks[0], "H_ff", (E, 6, 6)), (blocks[1], "H_tt", (E, 6, 6)),
            (blocks[2], "H_ft", (E, 6, 6)), (P_inv, "P_inv", (V, 6, 6)),
            (damp_diag, "damp_diag", (V, 6)), (b, "b", (V, 6))):
        _build.require(t, name, torch.float32, shape, dev)
    ef = edge_from.to(torch.int32).contiguous()
    et = edge_to.to(torch.int32).contiguous()
    _build.require(ef, "edge_from", torch.int32, (E,), dev)
    _build.require(et, "edge_to", torch.int32, (E,), dev)
    fixed = int(fixed_id)
    if not 0 <= fixed < V:
        raise ValueError(f"fixed_id {fixed} outside 0..{V - 1}")
    prior = torch.as_tensor(prior_info, dtype=torch.float32,
                            device=dev).reshape(1)
    ptr, entries = edge_csr(ef, et, V) if csr is None else csr
    _build.require(ptr, "csr ptr", torch.int32, (V + 1,), dev)
    _build.require(entries, "csr entries", torch.int32, (2 * E,), dev)
    # Scratch floats: r, z, p, Ap [V, 6] each, per-edge yf / yt [E, 12],
    # partial sums [3 * MAX_GRID]; then the step count (int32).
    scratch = torch.empty(24 * V + 12 * E + 3 * MAX_GRID + 1,
                          dtype=torch.float32, device=dev)
    x = torch.empty((V, 6), dtype=torch.float32, device=dev)
    grid = ctypes.c_int(0)
    err = _build.lib().pgs_pcg(
        blocks[0].data_ptr(), blocks[1].data_ptr(), blocks[2].data_ptr(),
        P_inv.data_ptr(), damp_diag.data_ptr(), b.data_ptr(),
        prior.data_ptr(), ef.data_ptr(), et.data_ptr(), ptr.data_ptr(),
        entries.data_ptr(), V, E, fixed, int(cg_iterations), float(cg_tol),
        x.data_ptr(), scratch.data_ptr(), ctypes.addressof(grid),
        _build.stream_of(b))
    _build.check(err, "pgs_pcg")
    pcg_solve.launches += 1
    pcg_solve.grid = grid.value
    return x, scratch[-1:].view(torch.int32)[0]


def pcg_solve(blocks, P_inv, damp_diag, b, prior_info, fixed_id, edge_from,
              edge_to, *, cg_iterations: int, cg_tol: float, csr=None,
              return_iterations: bool = False):
    """K4 wrapper: same contract as ``pgo.pcg_solve_plain``. ``csr`` is
    ``lm.edge_csr(edge_from, edge_to, V, emask)``, built here (with every
    edge) when not given;
    the step count it returns with ``return_iterations`` is a device
    tensor on the card."""
    dev = b.device
    if dev.type == "cpu":
        return pcg_solve_plain(blocks, P_inv, damp_diag, b, prior_info,
                               fixed_id, edge_from, edge_to,
                               cg_iterations=cg_iterations, cg_tol=cg_tol,
                               return_iterations=return_iterations)
    if dev.type != "cuda":
        raise ValueError(f"pcg_solve: unsupported device {dev}")
    x, steps = _launch(blocks, P_inv, damp_diag, b, prior_info, fixed_id,
                       edge_from, edge_to, cg_iterations, cg_tol, csr)
    return (x, steps) if return_iterations else x


pcg_solve.launches = 0
pcg_solve.grid = 0      # blocks of the last launch
