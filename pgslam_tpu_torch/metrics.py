"""Pose metrics: translation only, as in :mod:`pgslam_tpu.metrics`."""

from __future__ import annotations

import torch


def distance(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """Euclidean distance between translation columns (broadcasts)."""
    return torch.linalg.norm(T2[..., :3, 3] - T1[..., :3, 3], dim=-1)


def weight(T_meas: torch.Tensor, cov_meas=None) -> torch.Tensor:
    """Edge weight = translation norm of the measurement; the covariance
    is accepted for signature parity and unused."""
    del cov_meas
    return torch.linalg.norm(T_meas[..., :3, 3], dim=-1)
