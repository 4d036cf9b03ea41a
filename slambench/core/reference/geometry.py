"""Plain PyTorch geometry of the reference: SE(3) and the point-cloud
filters the benchmark's configurations use (voxel grid, compaction,
PCA normals) and an exact k-nearest-neighbour search.

A frozen copy of the plain paths of ``pgslam_tpu_torch`` (``se3.py``,
``ops/filters.py``, ``ops/knn.py::knn_plain``), trimmed to what the
configurations need; it imports nothing of the program. Everything runs
in the dtype of its inputs, on their device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

INF = float("inf")


# -- SE(3), [t; r] twists ----------------------------------------------------

def hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def vee(W):
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _sinc_coeffs(theta):
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


def _eye3(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def make(R, t):
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], -1)
    bottom = R.new_zeros(batch + (1, 4))
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], -2)


def exp(twist):
    v, w = twist[..., :3], twist[..., 3:]
    A, B, C = _sinc_coeffs(torch.linalg.norm(w, dim=-1))
    W = hat(w)
    WW = W @ W
    I = _eye3(W)
    R = I + A[..., None, None] * W + B[..., None, None] * WW
    V = I + B[..., None, None] * W + C[..., None, None] * WW
    return make(R, (V @ v[..., None])[..., 0])


def _quaternion(R):
    """Unit quaternion (w, x, y, z) by Shepperd's method with the largest
    pivot, the first on ties; canonical sign w >= 0."""
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
    best = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)
    cands = torch.stack([q_w, q_x, q_y, q_z], -2)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def log_so3(R):
    q = _quaternion(R)
    qw, qv = q[..., 0], q[..., 1:]
    n = torch.linalg.norm(qv, dim=-1)
    angle = 2.0 * torch.atan2(n, qw)
    small = n < 1e-8
    factor = torch.where(small, 2.0 / torch.clamp(qw, min=1e-12),
                         angle / torch.where(small, torch.ones_like(n), n))
    return factor[..., None] * qv


def log(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = log_so3(R)
    theta = torch.linalg.norm(w, dim=-1)
    A, B, _ = _sinc_coeffs(theta)
    W = hat(w)
    WW = W @ W
    t2 = theta * theta
    small = t2 < 1e-3
    one = torch.ones_like(t2)
    coef = torch.where(small, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
                       (1.0 - A / (2.0 * torch.where(small, one, B)))
                       / torch.where(small, one, t2))
    Vinv = _eye3(W) - 0.5 * W + coef[..., None, None] * WW
    return torch.cat([(Vinv @ t[..., None])[..., 0], w], -1)


def inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def apply(T, points):
    return points @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def rotation_angle(T):
    R = T[..., :3, :3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    s = 0.5 * torch.linalg.norm(vee(R - R.transpose(-1, -2)), dim=-1)
    return torch.atan2(s, (trace - 1.0) * 0.5)


def translation_norm(T):
    return torch.linalg.norm(T[..., :3, 3], dim=-1)


# -- clouds ------------------------------------------------------------------

@dataclasses.dataclass
class Cloud:
    """Points ``[N, 3]``, validity ``[N]`` and, after the normals
    filter, unit normals ``[N, 3]``."""
    points: torch.Tensor
    mask: torch.Tensor
    normals: Optional[torch.Tensor] = None

    def count(self):
        return self.mask.sum()


def cloud_from_points(points, device, capacity: Optional[int] = None,
                      dtype=torch.float32) -> Cloud:
    """A cloud of ``points`` (numpy ``[N, 3]``), compacted to
    ``capacity`` points when it holds more (the first ones)."""
    pts = torch.as_tensor(points, device=device).to(dtype)
    if capacity is not None:
        pts = pts[:capacity]
    return Cloud(points=pts, mask=torch.ones(pts.shape[0], dtype=torch.bool,
                                             device=device))


def voxel_grid(cloud: Cloud, voxel_size: float, hash_size: int) -> Cloud:
    """One point per hash bucket of the voxel index: the smallest valid
    index wins. The hash is int32 products that wrap, xor, abs and a
    floor modulo."""
    cell = torch.floor(cloud.points / voxel_size).to(torch.int32)
    h = (cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663) \
        ^ (cell[:, 2] * 83492791)
    h = torch.remainder(torch.abs(h), hash_size).long()
    n = cloud.points.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=cloud.points.device)
    contender = torch.where(cloud.mask, idx, n)
    table = torch.full((hash_size,), n, dtype=torch.int64,
                       device=cloud.points.device)
    table.scatter_reduce_(0, h, contender, reduce="amin")
    return dataclasses.replace(cloud, mask=cloud.mask & (table[h] == idx))


def compact(cloud: Cloud, capacity: int) -> Cloud:
    """Valid points to the front, in order; at most ``capacity``."""
    n = cloud.points.shape[0]
    cap = min(capacity, n)
    rank = torch.cumsum(cloud.mask.to(torch.int64), 0) - 1
    dest = torch.where(cloud.mask & (rank < cap), rank, cap)

    def put(a):
        if a is None:
            return None
        out = a.new_zeros((cap + 1,) + tuple(a.shape[1:]))
        out[dest] = a
        return out[:cap]

    n_valid = torch.clamp(cloud.mask.sum(), max=cap)
    return Cloud(points=put(cloud.points),
                 mask=torch.arange(cap, device=cloud.points.device) < n_valid,
                 normals=put(cloud.normals))


def sq_norm(p):
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
            + p[..., 2] * p[..., 2])


def knn(query, query_mask, reference, reference_mask, k: int = 1,
        tile: int = 1024):
    """Exact masked k-NN: (squared distances ``[Nq, k]`` ascending, ids);
    the distance by the expanded formula clamped at 0, ties to the lowest
    id, masked pairs ``+inf`` with id 0."""
    r_sq = sq_norm(reference)
    out_d, out_i = [], []
    for s in range(0, query.shape[0], tile):
        q = query[s:s + tile]
        qm = query_mask[s:s + tile]
        cross = torch.addcmul(torch.addcmul(
            q[:, None, 0] * reference[None, :, 0], q[:, None, 1],
            reference[None, :, 1]), q[:, None, 2], reference[None, :, 2])
        d2 = torch.clamp((sq_norm(q)[:, None] - 2.0 * cross)
                         + r_sq[None, :], min=0.0)
        d2 = torch.where(reference_mask[None, :] & qm[:, None], d2, INF)
        if k == 1:
            i = torch.argmin(d2, dim=1, keepdim=True)
            d = torch.gather(d2, 1, i)
        else:
            d, i = torch.sort(d2, dim=1, stable=True)
            d, i = d[:, :k], i[:, :k]
        out_d.append(d)
        out_i.append(i)
    d, i = torch.cat(out_d), torch.cat(out_i)
    return d, torch.where(torch.isfinite(d), i, 0)


def normals(cloud: Cloud, k: int = 8) -> Cloud:
    """Each point's normal: the least eigenvector of the covariance of
    its ``k`` nearest valid neighbours (itself included); zero where the
    point is masked. The sensor direction is not known here, so normals
    are not oriented (the configurations carry no observation
    directions)."""
    pts = cloud.points
    d2, ids = knn(pts, cloud.mask, pts, cloud.mask, k=k)
    neigh = pts[ids.long()]
    w = torch.isfinite(d2).to(pts.dtype)
    cnt = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    mean = (neigh * w[..., None]).sum(-2) / cnt
    centered = (neigh - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", centered, centered) / cnt[..., None]
    cov = cov + 1e-9 * torch.eye(3, dtype=pts.dtype, device=pts.device)
    _, vecs = torch.linalg.eigh(cov)
    n = torch.where(cloud.mask[:, None], vecs[..., 0], 0.0)
    return dataclasses.replace(cloud, normals=n)


def apply_filters(chain, cloud: Cloud) -> Cloud:
    """A filter chain of ``[name, params]`` pairs, in order."""
    for name, p in chain:
        if name == "VoxelGrid":
            cloud = voxel_grid(cloud, p["voxel_size"], p["hash_size"])
        elif name == "Compact":
            cloud = compact(cloud, p["capacity"])
        elif name == "SurfaceNormal":
            cloud = normals(cloud, p.get("knn", 8))
        else:
            raise ValueError(f"the reference has no filter {name!r}")
    return cloud
