"""Outlier filters: per-match weights in [0, 1]. Counterpart of
:mod:`pgslam_tpu.ops.outlier`: the same five filters, fields and
defaults. Every filter keeps or drops a match (weight 1 or 0); a chain
multiplies them, and invalid matches get 0."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .knn import Matches


@dataclasses.dataclass(frozen=True)
class TrimmedDist:
    """Keep the ``ratio`` fraction of matches with smallest distance."""
    ratio: float = 0.85


@dataclasses.dataclass(frozen=True)
class MaxDist:
    """Binary weight: distance <= ``max_dist`` (metres, not squared)."""
    max_dist: float = 1.0


@dataclasses.dataclass(frozen=True)
class MedianDist:
    """Binary weight: distance <= ``factor`` * median distance."""
    factor: float = 3.0


@dataclasses.dataclass(frozen=True)
class SurfaceNormalOutlier:
    """Keep a match whose reading and reference normals agree:
    ``|cos angle| >= cos(max_angle)``. Passes everything through unless
    both normals are given (the ICP loop gives none, as the JAX
    package's)."""
    max_angle: float = 1.0  # radians


@dataclasses.dataclass(frozen=True)
class VarTrimmedDist:
    """Trimmed distance with the trim ratio chosen per call by
    minimizing Chetverikov's FTMP criterion ``psi(r) = e(r) / r^lam``
    over ``r`` in ``[min_ratio, max_ratio]``, ``e(r)`` the mean squared
    distance of the closest ``r`` fraction."""
    min_ratio: float = 0.2
    max_ratio: float = 0.99
    lam: float = 2.0


OUTLIERS = (TrimmedDist, MaxDist, MedianDist, SurfaceNormalOutlier,
            VarTrimmedDist)
OutlierChain = Tuple


def kth_keep(ratio: float, n_valid: torch.Tensor,
             dtype=torch.float32) -> torch.Tensor:
    """``ceil(ratio * n_valid)`` in ``dtype`` (the distances' dtype; fp32
    on the main path), as the JAX package computes it. The ratio is a
    scalar operand, rounded to ``dtype`` as a constant of that dtype is,
    so nothing is uploaded."""
    return torch.ceil(n_valid.to(dtype) * ratio)


def _sorted_valid(d2: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The distances flattened and sorted, invalid ones as +inf last."""
    return torch.sort(torch.where(valid, d2, float("inf")).reshape(-1)
                      ).values


def _entry(s: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``s[index]`` for a 0-d device index, gathered on the device
    (indexing with a 0-d tensor reads it on the host)."""
    return s.index_select(0, index.reshape(1)).reshape(())


def trimmed_threshold(d2: torch.Tensor, valid: torch.Tensor,
                      ratio: float) -> torch.Tensor:
    """Exact value of the ``ceil(ratio * n_valid)``-th smallest valid
    distance (the first one when no distance is valid)."""
    s = _sorted_valid(d2, valid)
    kth = kth_keep(ratio, valid.sum(), d2.dtype).to(torch.int64) - 1
    return _entry(s, torch.clamp(kth, 0, s.shape[0] - 1))


def median_threshold(d2: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The valid distances' median: the sorted entry at
    ``int(0.5 * max(n_valid, 1))``."""
    s = _sorted_valid(d2, valid)
    n_valid = torch.clamp(valid.sum(), min=1).to(d2.dtype)
    idx = (0.5 * n_valid).to(torch.int64)
    return _entry(s, torch.clamp(idx, 0, s.shape[0] - 1))


def var_trimmed_threshold(d2: torch.Tensor, valid: torch.Tensor,
                          cfg: VarTrimmedDist) -> torch.Tensor:
    """The distance of the FTMP-optimal trim: psi evaluated at every
    count k of the sorted distances inside the ratio band, and the k-th
    smallest distance at its (first) minimum."""
    s = _sorted_valid(d2, valid)
    n = s.shape[0]
    n_valid = torch.clamp(valid.sum(), min=1).to(d2.dtype)
    ks = torch.arange(1, n + 1, dtype=d2.dtype, device=d2.device)
    r = ks / n_valid
    e = torch.cumsum(torch.where(torch.isfinite(s), s, 0.0), 0) / ks
    psi = e / torch.clamp(r, min=1e-9) ** cfg.lam
    in_band = (r >= cfg.min_ratio) & (r <= cfg.max_ratio)
    psi = torch.where(in_band, psi, float("inf"))
    return _entry(s, torch.argmin(psi))


def compute_weights(chain: OutlierChain, matches: Matches,
                    query_mask: torch.Tensor, reading_normals=None,
                    reference_normals=None) -> torch.Tensor:
    """Compose the filters multiplicatively; invalid matches get 0.
    ``reference_normals`` are those of the matched references
    (``[Nq, k, 3]``), for ``SurfaceNormalOutlier``."""
    d2 = matches.dists2
    valid = torch.isfinite(d2) & query_mask[:, None]
    w = valid.to(d2.dtype)
    for cfg in chain:
        if isinstance(cfg, TrimmedDist):
            keep = d2 <= trimmed_threshold(d2, valid, cfg.ratio)
        elif isinstance(cfg, MaxDist):
            keep = d2 <= cfg.max_dist * cfg.max_dist
        elif isinstance(cfg, VarTrimmedDist):
            keep = d2 <= var_trimmed_threshold(d2, valid, cfg)
        elif isinstance(cfg, MedianDist):
            keep = d2 <= cfg.factor * cfg.factor * median_threshold(d2,
                                                                    valid)
        elif isinstance(cfg, SurfaceNormalOutlier):
            if reading_normals is None or reference_normals is None:
                continue
            cos = torch.abs((reading_normals[:, None, :]
                             * reference_normals).sum(-1))
            # Filled on the device: an upload would wait for it.
            max_angle = torch.full((), cfg.max_angle, dtype=cos.dtype,
                                   device=cos.device)
            keep = cos >= torch.cos(max_angle)
        else:
            raise TypeError(f"unknown outlier filter {type(cfg)}")
        w = w * keep.to(w.dtype)
    return w
