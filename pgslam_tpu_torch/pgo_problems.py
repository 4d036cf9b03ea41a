"""Pose-graph problems at the sizes users run, made from a seed.

* ``pgo_1k``: ``bench.py::bench_pgo_1k``'s problem, a ring of 1024 poses
  with 2048 edges (the odometry chain and 1025 random loop edges), every
  pose but the anchor perturbed by a twist of sigma 0.05.
* ``pgo_16k``: the same construction at 16384 poses with 4096 loop edges
  (20479 edges), the size of a long run or a fleet's merged map; the ring's
  radius grows with V so consecutive poses stay as far apart as in
  ``pgo_1k``.

Measurements are the true relative poses, so the optimum has zero cost.
:func:`bucketed_problem` pads a problem to the power-of-two shapes that
``Optimizer`` sends to ``optimize_pose_graph``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import se3
from .devices import resolve_device

PROBLEMS = {"pgo_1k": (1024, 1025), "pgo_16k": (16384, 4096)}


def _numpy_problem(V: int, n_loop: int, seed: int, noise: float):
    """(poses, vmask, edge_from, edge_to, edge_T, edge_cov, emask) as numpy
    arrays, and the true poses."""
    rng = np.random.default_rng(seed)
    E = V - 1 + n_loop
    radius = 10.0 * max(1.0, V / 1024)
    ang = 2 * np.pi * np.arange(V) / V
    R = se3.exp_so3(torch.as_tensor(
        np.stack([np.zeros(V), np.zeros(V), ang], -1), dtype=torch.float32))
    t = torch.as_tensor(np.stack([radius * np.cos(ang), radius * np.sin(ang),
                                  np.zeros(V)], -1), dtype=torch.float32)
    poses = se3.make(R, t).numpy()
    ef = np.concatenate([np.arange(V - 1), rng.integers(0, V, n_loop)])
    et = np.concatenate([np.arange(1, V), rng.integers(0, V, n_loop)])
    dup = ef == et
    et[dup] = (et[dup] + 1) % V
    Ts = np.einsum("eij,ejk->eik", np.linalg.inv(poses[ef]),
                   poses[et]).astype(np.float32)
    covs = np.tile((np.eye(6) * 0.01).astype(np.float32), (E, 1, 1))
    init = poses.copy()
    init[1:] = init[1:] @ se3.exp(torch.as_tensor(
        rng.normal(size=(V - 1, 6)) * noise, dtype=torch.float32)).numpy()
    arrays = (init, np.ones(V, bool), ef.astype(np.int32),
              et.astype(np.int32), Ts, covs, np.ones(E, bool))
    return arrays, poses


def _to(arrays, device: torch.device):
    return tuple(torch.as_tensor(a, device=device) for a in arrays) + (0,)


def pose_graph_problem(V: int, n_loop: int, seed: int = 1,
                       noise: float = 0.05, device=None):
    """Returns (args, true poses): ``args`` = (poses, vmask, edge_from,
    edge_to, edge_T, edge_cov, emask, fixed_id) as
    ``optimize_pose_graph`` takes them, on ``device`` (the card unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    arrays, poses = _numpy_problem(V, n_loop, seed, noise)
    return _to(arrays, dev), poses


def bucketed_problem(n_vertices: int, n_loop: int, seed: int = 1,
                     noise: float = 0.05, bucket: int = 64, device=None):
    """:func:`pose_graph_problem` padded as ``Optimizer`` pads a graph
    (``optimizer.pad_graph``)."""
    from .optimizer import pad_graph
    dev = resolve_device(device)
    arrays, poses = _numpy_problem(n_vertices, n_loop, seed, noise)
    graph = (arrays[0],) + arrays[2:6]
    return _to(pad_graph(*graph, bucket), dev), poses


def named_problem(name: str, device=None):
    V, n_loop = PROBLEMS[name]
    return pose_graph_problem(V, n_loop, device=device)
