"""Voxel-hash candidate k-NN: the ``"grid"`` matcher. Counterpart of
:mod:`pgslam_tpu.ops.gridknn`, which is XLA code there (no Pallas
kernel), so plain PyTorch ops are the port on either device.

* build (once per ``ICPEngine.set_map``): reference points are bucketed
  into voxel cells of ``cell_size``, whose coordinates hash into a table
  ``[table_size, bucket_cap]`` of point ids (-1 empty), filled by a
  stable sort and each point's rank in its bucket's run; points past a
  full bucket are dropped and counted in ``overflow_count``;
* query (per ICP iteration): each query gathers the 27 neighbour cells'
  buckets and keeps the k least squared distances, taken directly from
  the difference as the FMA chain ``fma(dz, dz, fma(dy, dy, dx * dx))``
  (how the JAX CPU backend rounds its fused sum; not K1's expanded form)
  and capped at ``cell_size``: a match farther than that is +inf
  (unmatched).

The index and the matches equal the JAX package's bit for bit: the same
wrapping int32 hash, a stable argsort, ``searchsorted`` ranks, a
max-scatter of the ids, the first minimum at k = 1 and a stable sort (not
``topk``, whose order of ties is unspecified) at k > 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .knn import INF, Matches

_P1, _P2, _P3 = 73856093, 19349663, 83492791
_OFFSETS = [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


@dataclasses.dataclass
class GridIndex:
    """A voxel-hash index over a reference cloud."""
    table: torch.Tensor          # [table_size, bucket_cap] int32 ids, -1 empty
    points: torch.Tensor         # [Nr, 3] reference points (original order)
    mask: torch.Tensor           # [Nr] validity
    cell_size: torch.Tensor      # 0-d float32
    overflow_count: torch.Tensor  # 0-d: points dropped by full buckets

    @property
    def table_size(self) -> int:
        return self.table.shape[0]

    @property
    def bucket_cap(self) -> int:
        return self.table.shape[1]


def cell_hash(cell: torch.Tensor, table_size: int) -> torch.Tensor:
    """int32 products that wrap, xor, abs, floor modulo."""
    h = (cell[..., 0] * _P1) ^ (cell[..., 1] * _P2) ^ (cell[..., 2] * _P3)
    return torch.remainder(torch.abs(h), table_size)


def auto_cell_size(points, mask) -> float:
    """Three typical point spacings, the spacing estimated from the two
    largest bounding-box extents as for a near-2D lidar manifold:
    ``sqrt(e1 * e2 / n)`` (host-side, at index build)."""
    p = np.asarray(torch.as_tensor(points).cpu())[
        np.asarray(torch.as_tensor(mask).cpu())]
    if len(p) < 2:
        return 1.0
    e = np.sort(p.max(axis=0) - p.min(axis=0))
    spacing = float(np.sqrt(max(e[-1] * e[-2], 1e-12) / len(p)))
    return max(3.0 * spacing, 1e-3)


def build_grid_index(points: torch.Tensor, mask: torch.Tensor, *,
                     cell_size: float = 0.0, bucket_cap: int = 8,
                     table_size: int = 0) -> GridIndex:
    """The index. ``cell_size`` 0 sizes the cells by
    :func:`auto_cell_size`; ``table_size`` 0 takes 2 * Nr rounded up to a
    power of two, at least 4096."""
    n = points.shape[0]
    if table_size <= 0:
        table_size = max(1 << 12, 1 << (int(n * 2 - 1).bit_length()))
    if cell_size <= 0:
        cell_size = auto_cell_size(points, mask)
    cs = torch.tensor(cell_size, dtype=torch.float32, device=points.device)
    cell = torch.floor(points / cs).to(torch.int32)
    h = torch.where(mask, cell_hash(cell, table_size), table_size)
    order = torch.argsort(h, stable=True)   # invalid points sort last
    h_sorted = h[order]
    first = torch.searchsorted(h_sorted, h_sorted, side="left")
    rank = torch.arange(n, device=points.device) - first
    used = h_sorted < table_size
    valid = used & (rank < bucket_cap)
    # Dropped entries write -1 into slot (0, 0); the max keeps any id.
    slot = torch.where(valid, h_sorted * bucket_cap + rank, 0)
    vals = torch.where(valid, order, -1).to(torch.int32)
    table = torch.full((table_size * bucket_cap,), -1, dtype=torch.int32,
                       device=points.device)
    table.scatter_reduce_(0, slot.long(), vals, reduce="amax")
    return GridIndex(table=table.reshape(table_size, bucket_cap),
                     points=points, mask=mask, cell_size=cs,
                     overflow_count=(used & (rank >= bucket_cap)).sum())


_OFFSETS_ON = {}


def _offsets(device) -> torch.Tensor:
    """The 27 neighbour offsets on ``device``, uploaded once per device
    (an upload from pageable memory waits for the device)."""
    t = _OFFSETS_ON.get(device)
    if t is None:
        t = _OFFSETS_ON[device] = torch.tensor(_OFFSETS, dtype=torch.int32,
                                               device=device)
    return t


def grid_knn(query: torch.Tensor, query_mask: torch.Tensor,
             index: GridIndex, *, k: int = 1) -> Matches:
    """k-NN through the index: squared distances (+inf without a
    candidate within ``cell_size``) and reference ids."""
    offsets = _offsets(query.device)
    cell = torch.floor(query / index.cell_size).to(torch.int32)
    h = cell_hash(cell[:, None, :] + offsets[None], index.table_size)
    nq = query.shape[0]
    cand = index.table[h.long()].reshape(nq, -1)              # [Nq, 27*cap]
    cand_valid = cand >= 0
    safe = torch.where(cand_valid, cand, 0).long()
    diff = index.points[safe] - query[:, None, :]
    dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]
    d2 = torch.addcmul(torch.addcmul(dx * dx, dy, dy), dz, dz)
    radius2 = index.cell_size * index.cell_size
    d2 = torch.where(cand_valid & index.mask[safe] & (d2 <= radius2), d2,
                     INF)
    if k == 1:
        arg = torch.argmin(d2, dim=-1, keepdim=True)          # first minimum
        best = torch.gather(d2, 1, arg)
    else:
        best, arg = torch.sort(d2, dim=-1, stable=True)
        best, arg = best[:, :k], arg[:, :k]
    ids = torch.gather(cand, 1, arg)
    best = torch.where(query_mask[:, None], best, INF)
    ids = torch.where(torch.isfinite(best), torch.clamp(ids, min=0), 0)
    return Matches(dists2=best, ids=ids.to(torch.int32))
