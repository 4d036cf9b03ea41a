"""SE(3) Lie-group utilities on torch tensors, batched over leading dims.

Counterpart of :mod:`pgslam_tpu.se3`. Conventions are the same:
homogeneous ``[..., 4, 4]`` transforms and twists ordered
``[tx, ty, tz, rx, ry, rz]`` (translation first). Small-angle branches
use Taylor expansions below ``theta^2 < 1e-3``: in fp32, ``1 - cos(t)``
cancels catastrophically well before that.
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector: ``hat(w) @ v == cross(w, v)``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1)], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _sinc_coeffs(theta: torch.Tensor):
    """(A, B, C) = (sin t / t, (1 - cos t) / t^2, (1 - A) / t^2), with the
    Taylor branch below t^2 < 1e-3."""
    t2 = theta * theta
    small = t2 < 1e-3
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    ts = torch.sqrt(safe_t2)
    t4 = t2 * t2
    A = torch.where(small, 1.0 - t2 / 6.0 + t4 / 120.0, torch.sin(ts) / ts)
    B = torch.where(small, 0.5 - t2 / 24.0 + t4 / 720.0,
                    (1.0 - torch.cos(ts)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t4 / 5040.0,
                    (1.0 - A) / safe_t2)
    return A, B, C


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.norm(w, dim=-1)
    A, B, _ = _sinc_coeffs(theta)
    W = hat(w)
    return _eye3_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def quaternion_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), Shepperd's method
    with the largest pivot; canonical sign w >= 0."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    r01, r02, r10 = R[..., 0, 1], R[..., 0, 2], R[..., 1, 0]
    r12, r20, r21 = R[..., 1, 2], R[..., 2, 0], R[..., 2, 1]

    def S(p):
        return 2.0 * torch.sqrt(torch.clamp(p, min=1e-12))

    s_w = S(1.0 + tr)
    q_w = torch.stack([0.25 * s_w, (r21 - r12) / s_w, (r02 - r20) / s_w,
                       (r10 - r01) / s_w], -1)
    s_x = S(1.0 + m00 - m11 - m22)
    q_x = torch.stack([(r21 - r12) / s_x, 0.25 * s_x, (r01 + r10) / s_x,
                       (r02 + r20) / s_x], -1)
    s_y = S(1.0 - m00 + m11 - m22)
    q_y = torch.stack([(r02 - r20) / s_y, (r01 + r10) / s_y, 0.25 * s_y,
                       (r12 + r21) / s_y], -1)
    s_z = S(1.0 - m00 - m11 + m22)
    q_z = torch.stack([(r10 - r01) / s_z, (r02 + r20) / s_z,
                       (r12 + r21) / s_z, 0.25 * s_z], -1)
    pivots = torch.stack([tr, m00, m11, m22], -1)
    best = torch.argmax(pivots, dim=-1)          # first max on ties
    cands = torch.stack([q_w, q_x, q_y, q_z], -2)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    q = quaternion_from_matrix(R)
    qw, qv = q[..., 0], q[..., 1:]
    n = torch.linalg.norm(qv, dim=-1)
    angle = 2.0 * torch.atan2(n, qw)
    small = n < 1e-8
    factor = torch.where(small, 2.0 / torch.clamp(qw, min=1e-12),
                         angle / torch.where(small, torch.ones_like(n), n))
    return factor[..., None] * qv


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], -2)


def exp(twist: torch.Tensor) -> torch.Tensor:
    """Twist ``[..., 6]`` ([t; r] order) -> ``[..., 4, 4]``."""
    v, w = twist[..., :3], twist[..., 3:]
    theta = torch.linalg.norm(w, dim=-1)
    A, B, C = _sinc_coeffs(theta)
    W = hat(w)
    WW = W @ W
    I = _eye3_like(W)
    R = I + A[..., None, None] * W + B[..., None, None] * WW
    V = I + B[..., None, None] * W + C[..., None, None] * WW
    return make(R, (V @ v[..., None])[..., 0])


def log(T: torch.Tensor) -> torch.Tensor:
    """``[..., 4, 4]`` -> twist ``[..., 6]`` ([t; r] order)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = log_so3(R)
    theta = torch.linalg.norm(w, dim=-1)
    A, B, _ = _sinc_coeffs(theta)
    W = hat(w)
    WW = W @ W
    t2 = theta * theta
    small = t2 < 1e-3
    one = torch.ones_like(t2)
    safe_t2 = torch.where(small, one, t2)
    safe_B = torch.where(small, one, B)
    coef = torch.where(small, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
                       (1.0 - A / (2.0 * safe_B)) / safe_t2)
    Vinv = _eye3_like(W) - 0.5 * W + coef[..., None, None] * WW
    return torch.cat([(Vinv @ t[..., None])[..., 0], w], -1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def apply(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply ``[..., 4, 4]`` to points ``[..., N, 3]``."""
    return points @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def rotate(T: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    return vectors @ T[..., :3, :3].transpose(-1, -2)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """Ad(T) = [[R, hat(t) R], [0, R]] for [t; r]-ordered twists."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    top = torch.cat([R, hat(t) @ R], -1)
    bottom = torch.cat([torch.zeros_like(R), R], -1)
    return torch.cat([top, bottom], -2)


def normalize_rotation_fast(T: torch.Tensor, iterations: int = 2):
    """Newton-Schulz polar step ``R <- R (3I - R^T R) / 2`` for
    near-orthonormal rotations."""
    R = T[..., :3, :3]
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(iterations):
        R = 0.5 * R @ (3.0 * eye - R.transpose(-1, -2) @ R)
    return make(R, T[..., :3, 3])


def rotation_angle(T: torch.Tensor) -> torch.Tensor:
    """Rotation angle as ``atan2(|vee(R - R^T)| / 2, (tr R - 1) / 2)``.
    ``arccos((tr R - 1) / 2)`` (the JAX package's form) is quantized in
    fp32 to ~3.4e-4 rad near zero, above the ICP checkers' usual
    ``rot_eps`` of 1e-4, so whether a converged ICP stops would depend on
    how its last step's trace happened to round."""
    R = T[..., :3, :3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    s = 0.5 * torch.linalg.norm(vee(R - R.transpose(-1, -2)), dim=-1)
    return torch.atan2(s, (trace - 1.0) * 0.5)


def translation_norm(T: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(T[..., :3, 3], dim=-1)
