"""Synthetic scan-sequence generators (numpy only).

A copy of the generators of :mod:`pgslam_tpu.datasets` that the port's
replays use. It exists because the port must run where the JAX package
cannot be imported; the CPU tests hold every array here bit-equal to the
original for the same seed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _se3(x=0.0, y=0.0, z=0.0, yaw=0.0) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[:3, 3] = [x, y, z]
    return T


def corridor_world(rng, n_points: int = 20000, length: float = 60.0,
                   width: float = 4.0, height: float = 3.0) -> np.ndarray:
    """Two walls, floor and ceiling, with wall-mounted boxes for
    longitudinal texture."""
    counts = np.floor(n_points * np.array([0.3, 0.3, 0.2, 0.2])).astype(int)
    pts = []
    x = rng.uniform(0, length, counts[0])
    pts.append(np.stack([x, np.full_like(x, -width / 2),
                         rng.uniform(0, height, counts[0])], -1))
    x = rng.uniform(0, length, counts[1])
    pts.append(np.stack([x, np.full_like(x, width / 2),
                         rng.uniform(0, height, counts[1])], -1))
    x = rng.uniform(0, length, counts[2])
    pts.append(np.stack([x, rng.uniform(-width / 2, width / 2, counts[2]),
                         np.zeros(counts[2])], -1))
    x = rng.uniform(0, length, counts[3])
    pts.append(np.stack([x, rng.uniform(-width / 2, width / 2, counts[3]),
                         np.full(counts[3], height)], -1))
    world = np.concatenate(pts, 0)
    n_box = max(1, n_points // 20)
    for i, bx in enumerate(np.arange(2.5, length, 5.0)):
        side = -1 if i % 2 == 0 else 1
        c = np.array([bx, side * (width / 2 - 0.4), 0.6])
        box = rng.uniform(-0.4, 0.4, (n_box, 3)) + c
        world = np.concatenate([world, box], 0)
    return world.astype(np.float32)


def render_scan(world: np.ndarray, T_world_sensor: np.ndarray, rng,
                n_points: int = 1000, max_range: float = 15.0,
                noise: float = 0.0) -> np.ndarray:
    """Sample world points within range, expressed in the sensor frame."""
    rel = world - T_world_sensor[:3, 3]
    d = np.linalg.norm(rel, axis=-1)
    visible = np.nonzero(d <= max_range)[0]
    if len(visible) == 0:
        raise ValueError("no world points in range")
    take = rng.choice(visible, size=min(n_points, len(visible)),
                      replace=len(visible) < n_points)
    R = T_world_sensor[:3, :3]
    local = (world[take] - T_world_sensor[:3, 3]) @ R
    if noise:
        local = local + rng.normal(size=local.shape) * noise
    return local.astype(np.float32)


def corridor_sequence(rng, n_scans: int = 200, scan_points: int = 1000,
                      step: float = 0.25, noise: float = 0.005,
                      odom_noise: float = 0.01, length: float = 60.0
                      ) -> Tuple[List[np.ndarray], List[np.ndarray],
                                 List[np.ndarray]]:
    """Straight corridor run (BASELINE config 2). Returns (scans, odometry
    poses with drift, true poses)."""
    world = corridor_world(rng, length=length)
    scans, odom, truth = [], [], []
    T_odom = _se3(1.0, 0.0, 1.2)
    for i in range(n_scans):
        T_true = _se3(1.0 + i * step, 0.0, 1.2)
        scans.append(render_scan(world, T_true, rng, scan_points,
                                 noise=noise))
        if i > 0:
            d = np.array([step, 0, 0]) + rng.normal(size=3) * odom_noise
            T_odom = T_odom @ _se3(*d)
        truth.append(T_true)
        odom.append(T_odom.copy())
    return scans, odom, truth


def loop_world(rng, n_points: int = 40000, radius: float = 12.0,
               width: float = 4.0, height: float = 3.0) -> np.ndarray:
    """An annular corridor with aperiodic boxes and pillars."""
    n_wall = n_points // 4
    pts = []
    for r in (radius - width / 2, radius + width / 2):
        a = rng.uniform(0, 2 * np.pi, n_wall)
        pts.append(np.stack([r * np.cos(a), r * np.sin(a),
                             rng.uniform(0, height, n_wall)], -1))
    for z in (0.0, height):
        a = rng.uniform(0, 2 * np.pi, n_wall)
        rr = rng.uniform(radius - width / 2, radius + width / 2, n_wall)
        pts.append(np.stack([rr * np.cos(a), rr * np.sin(a),
                             np.full(n_wall, z)], -1))
    world = np.concatenate(pts, 0)
    n_box = max(1, n_points // 25)
    n_structures = max(8, int(2 * np.pi * radius / 1.0))
    for _ in range(n_structures):
        ang = rng.uniform(0, 2 * np.pi)
        side = 1 if rng.uniform() < 0.5 else -1
        inset = rng.uniform(0.3, 0.9)
        rp = radius + side * (width / 2 - inset)
        if rng.uniform() < 0.5:
            half = rng.uniform(0.15, 0.5, 3)
            c = np.array([rp * np.cos(ang), rp * np.sin(ang),
                          rng.uniform(0.2, height - 0.5)])
            box = rng.uniform(-1, 1, (n_box, 3)) * half + c
            world = np.concatenate([world, box], 0)
        else:
            pr = rng.uniform(0.08, 0.3)
            c = np.array([rp * np.cos(ang), rp * np.sin(ang)])
            theta = rng.uniform(0, 2 * np.pi, n_box)
            pillar = np.stack([pr * np.cos(theta) + c[0],
                               pr * np.sin(theta) + c[1],
                               rng.uniform(0, height, n_box)], -1)
            world = np.concatenate([world, pillar], 0)
    return world.astype(np.float32)


def loop_sequence(rng, n_scans: int = 120, scan_points: int = 1000,
                  radius: float = 12.0, noise: float = 0.005,
                  odom_drift: float = 0.002,
                  revolutions: float = 1.08, max_range: float = 7.0
                  ) -> Tuple[List[np.ndarray], List[np.ndarray],
                             List[np.ndarray]]:
    """Loop trajectory with odometric drift that revisits its start.
    Returns (scans, odometry poses, true poses)."""
    world = loop_world(rng, radius=radius)
    scans, odom, truth = [], [], []
    T_odom = None
    prev_true = None
    for i in range(n_scans):
        ang = 2 * np.pi * revolutions * i / n_scans
        T_true = _se3(radius * np.cos(ang), radius * np.sin(ang), 1.2,
                      yaw=ang + np.pi / 2)
        scans.append(render_scan(world, T_true, rng, scan_points,
                                 max_range=max_range, noise=noise))
        if T_odom is None:
            T_odom = T_true.copy()
        else:
            dT = np.linalg.inv(prev_true) @ T_true
            drift = _se3(odom_drift * rng.normal(),
                         odom_drift * rng.normal(), 0.0,
                         yaw=odom_drift * rng.normal())
            T_odom = T_odom @ dT @ drift
        truth.append(T_true)
        odom.append(T_odom.copy())
        prev_true = T_true
    return scans, odom, truth
