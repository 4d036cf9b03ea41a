"""Outlier filters: per-match weights in [0, 1]. Counterpart of
:mod:`pgslam_tpu.ops.outlier` for ``TrimmedDist`` and ``MaxDist``."""

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


OutlierChain = Tuple


def kth_keep(ratio: float, n_valid: torch.Tensor) -> torch.Tensor:
    """``ceil(ratio * n_valid)`` in fp32, as the JAX package computes it."""
    return torch.ceil(torch.tensor(ratio, dtype=torch.float32,
                                   device=n_valid.device)
                      * n_valid.to(torch.float32))


def trimmed_threshold(d2: torch.Tensor, valid: torch.Tensor,
                      ratio: float) -> torch.Tensor:
    """Exact value of the ``ceil(ratio * n_valid)``-th smallest valid
    distance (the first one when no distance is valid)."""
    flat = torch.where(valid, d2, float("inf")).reshape(-1)
    kth = kth_keep(ratio, valid.sum()).to(torch.int64) - 1
    kth = torch.clamp(kth, 0, flat.shape[0] - 1)
    return torch.sort(flat).values[kth]


def compute_weights(chain: OutlierChain, matches: Matches,
                    query_mask: torch.Tensor) -> torch.Tensor:
    """Compose the filters multiplicatively; invalid matches get 0."""
    d2 = matches.dists2
    valid = torch.isfinite(d2) & query_mask[:, None]
    w = valid.to(torch.float32)
    for cfg in chain:
        if isinstance(cfg, TrimmedDist):
            w = w * (d2 <= trimmed_threshold(d2, valid, cfg.ratio)).float()
        elif isinstance(cfg, MaxDist):
            w = w * (d2 <= cfg.max_dist * cfg.max_dist).float()
        else:
            raise NotImplementedError(
                f"outlier filter {type(cfg).__name__} is not ported yet")
    return w
