"""Data-point filter chains. Counterpart of :mod:`pgslam_tpu.ops.filters`:
the same thirteen filters with the same fields and defaults.

Every filter except ``Compact`` is mask-only: it clears validity bits
and/or adds descriptor channels, and never changes shapes.

Random draws. The JAX package seeds ``RandomSampling`` with
``fold_in(key, i)`` for chain element ``i``, the key being
``PRNGKey(scan count)`` for the localizer's input chain and
``PRNGKey(0)`` elsewhere. Here element ``i`` of a chain applied under
``seed`` draws from its own ``torch.Generator`` on the cloud's device,
seeded from ``(seed, i)`` (:func:`element_generator`). The structure is
the same; the bits are not (Threefry is not reproduced), so a chain with
``RandomSampling`` keeps other points than the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..cloud import Cloud
from ..utils import timing
from .knn import knn, sq_norm


@dataclasses.dataclass(frozen=True)
class Identity:
    """No-op."""


@dataclasses.dataclass(frozen=True)
class RandomSampling:
    """Keep each point independently with probability ``prob``."""
    prob: float = 0.75


@dataclasses.dataclass(frozen=True)
class MaxPointCount:
    """Keep at most ``count`` valid points (first ones win)."""
    count: int = 10000


@dataclasses.dataclass(frozen=True)
class MaxDist:
    """Drop points farther than ``dist`` from the origin along ``dim``
    (-1 = radial)."""
    dist: float = 100.0
    dim: int = -1


@dataclasses.dataclass(frozen=True)
class MinDist:
    """Drop points closer than ``dist`` to the origin along ``dim``."""
    dist: float = 0.5
    dim: int = -1


@dataclasses.dataclass(frozen=True)
class BoundingBox:
    """Drop points inside (or, with ``remove_inside=False``, outside) an
    axis-aligned box."""
    xmin: float = -1.0
    xmax: float = 1.0
    ymin: float = -1.0
    ymax: float = 1.0
    zmin: float = -1.0
    zmax: float = 1.0
    remove_inside: bool = True


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Keep one point per occupied voxel: the smallest index of each of
    ``hash_size`` hash buckets wins. ``method`` "sort" finds the winners
    by two stable sorts, any other value by a scatter-min race; both keep
    the same points."""
    voxel_size: float = 0.2
    hash_size: int = 1 << 16
    method: str = "auto"


@dataclasses.dataclass(frozen=True)
class Compact:
    """Push valid points to the front and shrink to ``capacity``."""
    capacity: int = 16384


@dataclasses.dataclass(frozen=True)
class ObservationDirection:
    """Add unit vectors from each point toward the sensor center (run in
    the sensor frame)."""
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclasses.dataclass(frozen=True)
class SurfaceNormal:
    """Normals from the ``knn`` nearest neighbours by 3x3 PCA."""
    knn: int = 8
    orient: bool = True
    tile_query: int = 4096


@dataclasses.dataclass(frozen=True)
class Shadow:
    """Drop points whose normal is nearly perpendicular to the
    observation direction (keep ``|cos| >= eps``); passes through unless
    both descriptors are present."""
    eps: float = 0.1


@dataclasses.dataclass(frozen=True)
class MaxDensity:
    """Within each voxel of size ``radius`` keep at most ``max_count``
    points (the smallest indices), by ``max_count`` scatter-min rounds."""
    radius: float = 0.5
    max_count: int = 4
    hash_size: int = 1 << 16


@dataclasses.dataclass(frozen=True)
class FixStepSampling:
    """Keep every ``step``-th valid point."""
    step: int = 2


FILTERS = (Identity, RandomSampling, MaxPointCount, MaxDist, MinDist,
           BoundingBox, VoxelGrid, ObservationDirection, SurfaceNormal,
           Shadow, MaxDensity, FixStepSampling, Compact)
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


def _scatter_min_winners(h: torch.Tensor, contender: torch.Tensor,
                         hash_size: int) -> torch.Tensor:
    """Each bucket's smallest contender, looked up per point."""
    table = torch.full((hash_size,), contender.shape[0], dtype=torch.int64,
                       device=h.device)
    table.scatter_reduce_(0, h, contender, reduce="amin")
    return table[h]


def first_in_bucket_sort(h: torch.Tensor, contender: torch.Tensor,
                         n: int) -> torch.Tensor:
    """``keep[i]``: i is the smallest valid index of its bucket, found by
    sorting (bucket major, contender minor: two stable sorts, minor key
    first) and marking the head of each bucket's run."""
    minor = torch.argsort(contender, stable=True)
    order = minor[torch.argsort(h[minor], stable=True)]
    hs, cs = h[order], contender[order]
    head = torch.ones_like(hs, dtype=torch.bool)
    head[1:] = hs[1:] != hs[:-1]
    keep = torch.empty_like(head)
    keep[order] = head & (cs < n)
    return keep


def voxel_grid(cfg: VoxelGrid, cloud: Cloud) -> Cloud:
    h = voxel_hash(cloud.points, cfg.voxel_size, cfg.hash_size).long()
    n = cloud.capacity
    idx = torch.arange(n, dtype=torch.int64, device=cloud.device)
    contender = torch.where(cloud.mask, idx, n)   # an invalid point never wins
    if cfg.method == "sort":
        keep = first_in_bucket_sort(h, contender, n)
    else:
        keep = _scatter_min_winners(h, contender, cfg.hash_size) == idx
    return cloud.replace(mask=cloud.mask & keep)


def max_density(cfg: MaxDensity, cloud: Cloud) -> Cloud:
    h = voxel_hash(cloud.points, cfg.radius, cfg.hash_size).long()
    n = cloud.capacity
    idx = torch.arange(n, dtype=torch.int64, device=cloud.device)
    keep = torch.zeros(n, dtype=torch.bool, device=cloud.device)
    for _ in range(cfg.max_count):
        # This round's winner per bucket: its smallest index not kept yet.
        contender = torch.where(cloud.mask & ~keep, idx, n)
        keep = keep | (_scatter_min_winners(h, contender, cfg.hash_size)
                       == idx)
    return cloud.replace(mask=cloud.mask & keep)


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


def compact_batched(cloud: Cloud, capacity=None) -> Cloud:
    """:func:`compact` of each cloud of a ``[B, N]`` batch: one cumsum
    along the point axis, then one scatter per tensor over the batch (the
    mask's scatter is the compacted mask)."""
    B, n = cloud.mask.shape
    cap = n if capacity is None else min(capacity, n)
    rank1 = torch.cumsum(cloud.mask, -1)            # 1-based, int64
    # Row b's survivors go to b * cap + rank; the rest to the spare row
    # ``B * cap``.
    base = torch.arange(-1, B * cap - 1, cap, device=cloud.device)
    dest = torch.where(cloud.mask & (rank1 <= cap), rank1 + base[:, None],
                       B * cap).reshape(-1)

    def put(a):
        tail = tuple(a.shape[2:])
        out = a.new_zeros((B * cap + 1,) + tail)
        out[dest] = a.reshape((B * n,) + tail)
        return out[:B * cap].view((B, cap) + tail)

    return Cloud(points=put(cloud.points), mask=put(cloud.mask),
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
    with timing.wait("filters.normals"):     # eigh checks on the host
        eigvals, eigvecs = torch.linalg.eigh(cov)              # ascending
    normal = eigvecs[..., 0]
    if orient and "observationDirections" in cloud.descriptors:
        obs = cloud.descriptors["observationDirections"]
        flip = (normal * obs).sum(-1, keepdim=True) < 0.0
        normal = torch.where(flip, -normal, normal)
    normal = torch.where(cloud.mask[:, None], normal, 0.0)
    curv = eigvals[..., 0] / torch.clamp(eigvals.sum(-1), min=1e-12)
    return cloud.with_descriptor("normals", normal).with_descriptor(
        "surfaceCurvature", torch.where(cloud.mask, curv, 0.0)[:, None])


def _dist_along(points: torch.Tensor, dim: int) -> torch.Tensor:
    if dim < 0:
        return torch.sqrt(sq_norm(points))
    return torch.abs(points[:, dim])


def _rank(mask: torch.Tensor) -> torch.Tensor:
    """Each point's index among the valid points (-1 before the first)."""
    return torch.cumsum(mask.to(torch.int32), 0) - 1


def element_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of chain element ``index`` under ``seed`` (the JAX
    package's ``fold_in(PRNGKey(seed), index)``)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * 1_000_003 + int(index))
    return g


def random_sampling(cloud: Cloud, prob: float,
                    generator: Optional[torch.Generator] = None,
                    keep: Optional[torch.Tensor] = None) -> Cloud:
    """Keep each point with probability ``prob``: ``keep`` (bool, one per
    point) when given, else a uniform draw from ``generator`` below
    ``prob``."""
    if keep is None:
        if generator is None:
            generator = element_generator(0, 0, cloud.device)
        keep = torch.rand(cloud.capacity, generator=generator,
                          device=cloud.device) < prob
    return cloud.replace(mask=cloud.mask & keep)


def apply_one(cfg, cloud: Cloud,
              generator: Optional[torch.Generator] = None) -> Cloud:
    """One filter; ``generator`` feeds ``RandomSampling``'s draw."""
    if isinstance(cfg, Identity):
        return cloud
    if isinstance(cfg, RandomSampling):
        return random_sampling(cloud, cfg.prob, generator)
    if isinstance(cfg, MaxPointCount):
        return cloud.replace(mask=cloud.mask & (_rank(cloud.mask)
                                                < cfg.count))
    if isinstance(cfg, MaxDist):
        return cloud.replace(mask=cloud.mask & (
            _dist_along(cloud.points, cfg.dim) <= cfg.dist))
    if isinstance(cfg, MinDist):
        return cloud.replace(mask=cloud.mask & (
            _dist_along(cloud.points, cfg.dim) >= cfg.dist))
    if isinstance(cfg, BoundingBox):
        p = cloud.points
        inside = ((p[:, 0] >= cfg.xmin) & (p[:, 0] <= cfg.xmax)
                  & (p[:, 1] >= cfg.ymin) & (p[:, 1] <= cfg.ymax)
                  & (p[:, 2] >= cfg.zmin) & (p[:, 2] <= cfg.zmax))
        drop = inside if cfg.remove_inside else ~inside
        return cloud.replace(mask=cloud.mask & ~drop)
    if isinstance(cfg, VoxelGrid):
        return voxel_grid(cfg, cloud)
    if isinstance(cfg, Compact):
        return compact(cloud, cfg.capacity)
    if isinstance(cfg, ObservationDirection):
        with timing.wait("filters.upload"):
            center = torch.tensor([cfg.x, cfg.y, cfg.z],
                                  dtype=cloud.points.dtype,
                                  device=cloud.device)
        vec = center[None, :] - cloud.points
        norm = torch.sqrt(sq_norm(vec))[:, None]
        return cloud.with_descriptor("observationDirections",
                                     vec / torch.clamp(norm, min=1e-12))
    if isinstance(cfg, SurfaceNormal):
        return compute_normals(cloud, knn_k=cfg.knn, orient=cfg.orient)
    if isinstance(cfg, Shadow):
        if "normals" not in cloud.descriptors or \
                "observationDirections" not in cloud.descriptors:
            return cloud
        n = cloud.descriptors["normals"]
        o = cloud.descriptors["observationDirections"]
        cos = torch.abs(n[:, 0] * o[:, 0] + n[:, 1] * o[:, 1]
                        + n[:, 2] * o[:, 2])
        return cloud.replace(mask=cloud.mask & (cos >= cfg.eps))
    if isinstance(cfg, MaxDensity):
        return max_density(cfg, cloud)
    if isinstance(cfg, FixStepSampling):
        return cloud.replace(mask=cloud.mask & (_rank(cloud.mask) % cfg.step
                                                == 0))
    raise TypeError(f"unknown filter config {type(cfg)}")


def apply_chain(chain: Chain, cloud: Cloud, seed: int = 0) -> Cloud:
    """The chain in order; element ``i`` draws from
    ``element_generator(seed, i)``."""
    for i, cfg in enumerate(chain):
        gen = (element_generator(seed, i, cloud.device)
               if isinstance(cfg, RandomSampling) else None)
        cloud = apply_one(cfg, cloud, gen)
    return cloud
