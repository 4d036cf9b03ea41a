"""Data-point filter chains. Counterpart of :mod:`pgslam_tpu.ops.filters`
for ``VoxelGrid``, ``Compact`` and ``SurfaceNormal``.

Every filter except ``Compact`` is mask-only: it clears validity bits
and/or adds descriptor channels, and never changes shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..cloud import Cloud
from .knn import knn


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Keep one point per occupied voxel: the smallest index wins a
    scatter-min race over a hash table of ``hash_size`` buckets."""
    voxel_size: float = 0.2
    hash_size: int = 1 << 16
    method: str = "auto"


@dataclasses.dataclass(frozen=True)
class Compact:
    """Push valid points to the front and shrink to ``capacity``."""
    capacity: int = 16384


@dataclasses.dataclass(frozen=True)
class SurfaceNormal:
    """Normals from the ``knn`` nearest neighbours by 3x3 PCA."""
    knn: int = 8
    orient: bool = True
    tile_query: int = 4096


Chain = Tuple


def voxel_hash(points: torch.Tensor, voxel_size: float,
               hash_size: int) -> torch.Tensor:
    """The JAX package's voxel hash: int32 products that wrap on
    overflow, xor, abs (which leaves INT_MIN as is), then a floor
    modulo."""
    cell = torch.floor(points / voxel_size).to(torch.int32)
    h = (cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663) \
        ^ (cell[:, 2] * 83492791)
    return torch.remainder(torch.abs(h), hash_size)


def voxel_grid(cfg: VoxelGrid, cloud: Cloud) -> Cloud:
    if cfg.method not in ("auto", "scatter"):
        raise NotImplementedError(f"VoxelGrid method {cfg.method!r}")
    h = voxel_hash(cloud.points, cfg.voxel_size, cfg.hash_size).long()
    n = cloud.capacity
    idx = torch.arange(n, dtype=torch.int64, device=cloud.device)
    contender = torch.where(cloud.mask, idx, n)
    table = torch.full((cfg.hash_size,), n, dtype=torch.int64,
                       device=cloud.device)
    table.scatter_reduce_(0, h, contender, reduce="amin")
    return cloud.replace(mask=cloud.mask & (table[h] == idx))


def compact(cloud: Cloud, capacity=None) -> Cloud:
    """Stable push of valid points to the front; extra valid points past
    ``capacity`` are dropped."""
    cap = cloud.capacity if capacity is None else min(capacity,
                                                      cloud.capacity)
    rank = torch.cumsum(cloud.mask.to(torch.int64), 0) - 1
    # Rows that do not survive all land in the spare row ``cap``.
    dest = torch.where(cloud.mask & (rank < cap), rank, cap)

    def put(a):
        out = a.new_zeros((cap + 1,) + tuple(a.shape[1:]))
        out[dest] = a
        return out[:cap]

    n_valid = torch.clamp(cloud.mask.sum(), max=cap)
    mask = torch.arange(cap, device=cloud.device) < n_valid
    return Cloud(points=put(cloud.points), mask=mask,
                 descriptors={k: put(v) for k, v in cloud.descriptors.items()})


def compute_normals(cloud: Cloud, *, knn_k: int = 8,
                    orient: bool = True) -> Cloud:
    """Per-point normal = the smallest-eigenvalue eigenvector of the
    neighbourhood covariance (neighbours by K1); invalid points get a
    zero normal. Also adds the ``surfaceCurvature`` descriptor."""
    pts = cloud.points
    m = knn(pts, cloud.mask, pts, cloud.mask, k=knn_k)
    neigh = pts[m.ids.long()]                                  # [N, k, 3]
    w = torch.isfinite(m.dists2).to(pts.dtype)
    cnt = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    mean = (neigh * w[..., None]).sum(-2) / cnt
    centered = (neigh - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", centered, centered) / cnt[..., None]
    cov = cov + 1e-9 * torch.eye(3, dtype=pts.dtype, device=pts.device)
    eigvals, eigvecs = torch.linalg.eigh(cov)                  # ascending
    normal = eigvecs[..., 0]
    if orient and "observationDirections" in cloud.descriptors:
        obs = cloud.descriptors["observationDirections"]
        flip = (normal * obs).sum(-1, keepdim=True) < 0.0
        normal = torch.where(flip, -normal, normal)
    normal = torch.where(cloud.mask[:, None], normal, 0.0)
    curv = eigvals[..., 0] / torch.clamp(eigvals.sum(-1), min=1e-12)
    return cloud.with_descriptor("normals", normal).with_descriptor(
        "surfaceCurvature", torch.where(cloud.mask, curv, 0.0)[:, None])


def apply_one(cfg, cloud: Cloud) -> Cloud:
    if isinstance(cfg, VoxelGrid):
        return voxel_grid(cfg, cloud)
    if isinstance(cfg, Compact):
        return compact(cloud, cfg.capacity)
    if isinstance(cfg, SurfaceNormal):
        return compute_normals(cloud, knn_k=cfg.knn, orient=cfg.orient)
    raise NotImplementedError(
        f"filter {type(cfg).__name__} is not ported yet")


def apply_chain(chain: Chain, cloud: Cloud) -> Cloud:
    for cfg in chain:
        cloud = apply_one(cfg, cloud)
    return cloud
