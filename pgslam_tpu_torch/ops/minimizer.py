"""Rigid-transform error minimizers and the statistics the framework reads
(overlap, residual, covariance). Counterpart of
:mod:`pgslam_tpu.ops.minimizer`; covariances are in [t; r] order."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import se3

# Below this weighted support a rigid fit is garbage: the step becomes
# the identity and the overlap statistic reports the failure.
MIN_SUPPORT = 6.0


@dataclasses.dataclass
class ErrorElements:
    reading: torch.Tensor                  # [N, 3] transformed reading
    reference: torch.Tensor                # [N, 3] matched reference
    weights: torch.Tensor                  # [N]
    normals: Optional[torch.Tensor] = None  # [N, 3] reference normals


def overlap(weights: torch.Tensor, n_valid_reading) -> torch.Tensor:
    """Weighted point-used ratio."""
    n = torch.as_tensor(n_valid_reading, device=weights.device)
    return weights.sum() / torch.clamp(n.to(weights.dtype), min=1.0)


def _degenerate_guard(delta, weights):
    ok = weights.sum() >= MIN_SUPPORT
    eye = torch.eye(4, dtype=delta.dtype, device=delta.device)
    return torch.where(ok, delta, eye)


def point_to_point(elems: ErrorElements) -> torch.Tensor:
    """Weighted Umeyama/Kabsch by SVD; returns the 4x4 delta."""
    w = elems.weights
    wsum = torch.clamp(w.sum(), min=1e-12)
    wp = w[:, None]
    mu_p = (wp * elems.reading).sum(0) / wsum
    mu_q = (wp * elems.reference).sum(0) / wsum
    p = elems.reading - mu_p
    q = elems.reference - mu_q
    H = (p * wp).T @ q
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.T @ U.T)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det),
                                det]))
    R = Vt.T @ D @ U.T
    t = mu_q - R @ mu_p
    return _degenerate_guard(se3.make(R, t), w)


def p2plane_system(elems: ErrorElements):
    """A = sum w J J^T (6x6), b = -sum w r J, r; J = [n; p x n]."""
    n, p = elems.normals, elems.reading
    r = (n * (p - elems.reference)).sum(-1)
    J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], -1)
    wJ = elems.weights[:, None] * J
    A = wJ.T @ J
    b = -(wJ * r[:, None]).sum(0)
    return A, b, r


def point_to_plane(elems: ErrorElements) -> torch.Tensor:
    """One linearized point-to-plane solve; returns the 4x4 delta."""
    A, b, _ = p2plane_system(elems)
    A = A + 1e-6 * torch.eye(6, dtype=A.dtype, device=A.device)
    # solve_ex: linalg.solve checks its factorization on the host. A
    # failed solve gives a non-finite step, which the bound check's NaN
    # guard rejects.
    x = torch.linalg.solve_ex(A, b)[0]
    return _degenerate_guard(se3.exp(x), elems.weights)


def residual_error(elems: ErrorElements, error: str) -> torch.Tensor:
    """Sum of weighted squared errors at the current pose."""
    if error == "point_to_plane" and elems.normals is not None:
        r = (elems.normals * (elems.reading - elems.reference)).sum(-1)
        return (elems.weights * r * r).sum()
    d2 = ((elems.reading - elems.reference) ** 2).sum(-1)
    return (elems.weights * d2).sum()


def covariance(elems: ErrorElements, error: str) -> torch.Tensor:
    """sigma^2 (J^T W J)^-1 with the dof-corrected residual variance."""
    w = elems.weights
    wsum = w.sum()
    eye6 = torch.eye(6, dtype=w.dtype, device=w.device)
    if error == "point_to_plane" and elems.normals is not None:
        A, _, r = p2plane_system(elems)
        ssr = (w * r * r).sum()
        n_res = wsum
    else:
        p = elems.reading
        diff = p - elems.reference
        hp = se3.hat(p)
        wI = w.sum() * torch.eye(3, dtype=p.dtype, device=p.device)
        w_hp = w[:, None, None] * hp
        A_tr = -w_hp.sum(0)
        A_rr = torch.einsum("nij,nik->jk", w_hp, hp)
        A = torch.cat([torch.cat([wI, A_tr], 1),
                       torch.cat([A_tr.T, A_rr], 1)], 0)
        ssr = (w * (diff * diff).sum(-1)).sum()
        n_res = 3.0 * wsum
    dof = torch.clamp(n_res - 6.0, min=1.0)
    inv = torch.linalg.inv_ex(A + 1e-9 * eye6)[0]
    cov = (ssr / dof) * inv
    return cov + 1e-12 * eye6
