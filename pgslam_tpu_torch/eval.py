"""Trajectory evaluation: ATE and RPE. A copy of :mod:`pgslam_tpu.eval`
(numpy only, the TUM RGB-D benchmark's definitions): the absolute
trajectory error after the optimal rigid alignment, and the relative
pose error over a fixed frame delta."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def align_umeyama(est_t: np.ndarray, gt_t: np.ndarray,
                  with_scale: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Optimal rigid (optionally similarity) alignment est -> gt over
    [N, 3] translation tracks. Returns (R, t, s)."""
    mu_e = est_t.mean(axis=0)
    mu_g = gt_t.mean(axis=0)
    X = est_t - mu_e
    Y = gt_t - mu_g
    C = Y.T @ X / len(est_t)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var = (X * X).sum() / len(est_t)
        s = float(np.trace(np.diag(D) @ S) / max(var, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (RMSE over translations) of ``est``
    vs ``gt``, both ``[N, 4, 4]`` pose arrays, after optimal rigid
    alignment (``align=False`` compares in the shared world frame)."""
    est_t = np.asarray(est)[:, :3, 3].astype(np.float64)
    gt_t = np.asarray(gt)[:, :3, 3].astype(np.float64)
    if align:
        R, t, s = align_umeyama(est_t, gt_t)
        est_t = (s * (R @ est_t.T)).T + t
    d = est_t - gt_t
    return float(np.sqrt((d * d).sum(axis=1).mean()))


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1
        ) -> Tuple[float, float]:
    """Relative pose error over frame pairs ``(i, i+delta)``.

    Returns (translational RMSE in meters, rotational RMSE in radians).
    Drift metric — insensitive to global alignment.
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    n = len(est) - delta
    if n <= 0:
        raise ValueError("trajectory shorter than delta")
    terr2, rerr2 = 0.0, 0.0
    for i in range(n):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        err = np.linalg.inv(dg) @ de
        terr2 += float((err[:3, 3] ** 2).sum())
        c = (np.trace(err[:3, :3]) - 1.0) / 2.0
        rerr2 += float(np.arccos(np.clip(c, -1.0, 1.0)) ** 2)
    return float(np.sqrt(terr2 / n)), float(np.sqrt(rerr2 / n))
