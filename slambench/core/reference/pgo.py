"""Plain PyTorch pose-graph least squares of the reference.

The cost is the program's (``pgslam_tpu_torch/optim/pgo.py``): per edge
``e = log(Z^-1 X_from^-1 X_to)`` weighted by the inverse of the edge's
covariance ([t; r] order), and a prior ``log(X0^-1 X_fixed)`` of
information ``1 / prior_sigma^2`` on the anchor. :func:`gauss_newton_step`
assembles the dense normal equations (right perturbations ``X exp(d)``,
the Jacobians ``Jr^-1(e)`` and ``-Jr^-1(e) Ad(M^-1)``) and solves them
with a ridge of 1e-6 of the median diagonal entry, which leaves the
free gauge of a component without an anchor where it is (its gradient
is zero). From poses at the optimum the step is zero; its size is how
far the poses lie from it, in metres (:func:`displacement`) or in the
graph's standard deviations (:func:`sigma`). :func:`solve` iterates the
step.
"""

from __future__ import annotations

import torch

from . import geometry as G


def _ad(xi):
    hw, hv = G.hat(xi[..., 3:]), G.hat(xi[..., :3])
    top = torch.cat([hw, hv], -1)
    return torch.cat([top, torch.cat([torch.zeros_like(hw), hw], -1)], -2)


def _jr_inv(e):
    a = _ad(e)
    eye = torch.eye(6, dtype=e.dtype, device=e.device)
    return eye + 0.5 * a + (1.0 / 12.0) * (a @ a)


def _adjoint(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    top = torch.cat([R, G.hat(t) @ R], -1)
    return torch.cat([top, torch.cat([torch.zeros_like(R), R], -1)], -2)


def gauss_newton_step(poses, edge_from, edge_to, edge_T, edge_cov, fixed,
                      anchor, prior_sigma: float = 1e-6):
    """The step ``[V, 6]`` from ``poses`` ``[V, 4, 4]``, and the gradient;
    ``anchor`` is the fixed vertex's prior pose. Everything in the dtype
    of ``poses``."""
    V = poses.shape[0]
    dt, dev = poses.dtype, poses.device
    ef, et = edge_from.long(), edge_to.long()
    M = G.inverse(poses[ef]) @ poses[et]
    e = G.log(G.inverse(edge_T) @ M)
    info = torch.linalg.inv(edge_cov)
    info = 0.5 * (info + info.transpose(-1, -2))
    Jt = _jr_inv(e)
    Jf = -Jt @ _adjoint(G.inverse(M))
    H = torch.zeros((V, V, 6, 6), dtype=dt, device=dev)
    g = torch.zeros((V, 6), dtype=dt, device=dev)
    for (a, Ja) in ((ef, Jf), (et, Jt)):
        JaT_O = Ja.transpose(-1, -2) @ info
        g.index_add_(0, a, (JaT_O @ e[..., None])[..., 0])
        for (b, Jb) in ((ef, Jf), (et, Jt)):
            H.index_put_((a, b), JaT_O @ Jb, accumulate=True)
    eye4 = torch.eye(4, dtype=dt, device=dev)
    x0 = anchor.to(dt)
    rp = G.log(eye4 + G.inverse(x0) @ (poses[fixed] - x0))
    w = 1.0 / prior_sigma ** 2
    H[fixed, fixed] += w * _jr_inv(rp)
    g[fixed] += w * rp
    Hd = H.permute(0, 2, 1, 3).reshape(6 * V, 6 * V)
    diag = torch.diagonal(Hd)
    ridge = 1e-6 * torch.median(diag[diag > 0]) if bool((diag > 0).any()) \
        else torch.ones((), dtype=dt, device=dev)
    Hd = Hd + ridge * torch.eye(6 * V, dtype=dt, device=dev)
    return torch.linalg.solve(Hd, -g.reshape(-1)).reshape(V, 6), g


def sigma(step, g) -> float:
    """``sqrt(d^T H d)`` of a step ``d`` (``= sqrt(-g^T d)``): how many
    standard deviations of the graph's own information the poses lie
    from the optimum, all vertices together."""
    return float(torch.sqrt(torch.clamp(-(g * step).sum(), min=0.0)))


def displacement(step, reach: float):
    """Per vertex, the farthest a point within ``reach`` metres moves
    under the step: ``|t| + reach * |r|``."""
    return (torch.linalg.norm(step[:, :3], dim=-1)
            + reach * torch.linalg.norm(step[:, 3:], dim=-1))


def solve(poses, edge_from, edge_to, edge_T, edge_cov, fixed, anchor,
          iterations: int = 10):
    """Gauss-Newton from ``poses`` for ``iterations`` steps."""
    for _ in range(iterations):
        d, _ = gauss_newton_step(poses, edge_from, edge_to, edge_T,
                                 edge_cov, fixed, anchor)
        poses = poses @ G.exp(d)
    return poses
