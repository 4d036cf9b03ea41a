"""The traffic generator: sensor sessions made from a mix file and a seed.

``corridor_world`` and ``render_scan`` are frozen copies of the
generators in ``pgslam_tpu_torch/datasets.py``; ``corridor_sequence`` is
the same function with the world's size, the start pose and the sensor's
range as parameters (its defaults reproduce the original draw for draw).
They live here so that no later change to the program moves the traffic.

A mix file (``slambench/mixes/<traffic>.json``) holds::

    {"world": {"n_points", "length", "width", "height", "seed"},
     "sequence": {"n_scans", "scan_points", "step", "x0", "z", "noise",
                  "odom_noise", "max_range"},
     "agents": {"stagger", "offset"},
     "steps": <steps a session>}

The world (the building) is drawn from the mix's own ``world.seed``, the
same for every run; ``--seed`` draws the sensor's samples and noise and
the odometry's drift through it, so that every seed maps the same
building with the same amount of work, in another sensor stream.
A session is ``steps`` steps; at step ``i`` agent ``b`` of ``n_agents``
takes scan ``i + b % stagger`` of the sequence (``stagger`` 1: every
agent the same scan), with its odometry translated by
``b * offset`` in the world frame. Every session of a run replays the
same rendered sequence.
"""

from __future__ import annotations

import dataclasses
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
                      odom_noise: float = 0.01, length: float = 60.0,
                      world_points: int = 20000, width: float = 4.0,
                      height: float = 3.0, x0: float = 1.0, z: float = 1.2,
                      max_range: float = 15.0, world=None
                      ) -> Tuple[List[np.ndarray], List[np.ndarray],
                                 List[np.ndarray]]:
    """Straight corridor run. Returns (scans, odometry poses with drift,
    true poses). ``world`` given, the corridor is not drawn from
    ``rng``."""
    if world is None:
        world = corridor_world(rng, n_points=world_points, length=length,
                               width=width, height=height)
    scans, odom, truth = [], [], []
    T_odom = _se3(x0, 0.0, z)
    for i in range(n_scans):
        T_true = _se3(x0 + i * step, 0.0, z)
        scans.append(render_scan(world, T_true, rng, scan_points,
                                 max_range=max_range, noise=noise))
        if i > 0:
            d = np.array([step, 0, 0]) + rng.normal(size=3) * odom_noise
            T_odom = T_odom @ _se3(*d)
        truth.append(T_true)
        odom.append(T_odom.copy())
    return scans, odom, truth


@dataclasses.dataclass
class Session:
    """One session's inputs. ``scans[j]`` is sequence scan ``j``;
    ``index[i, b]`` the scan agent ``b`` takes at step ``i``, with
    odometry ``odom[i, b]`` (``[steps, B, 4, 4]``)."""
    scans: List[np.ndarray]
    index: np.ndarray
    odom: np.ndarray
    max_range: float

    @property
    def steps(self) -> int:
        return self.index.shape[0]

    def step_clouds(self, i: int) -> List[np.ndarray]:
        return [self.scans[j] for j in self.index[i]]


def make_session(mix: dict, n_agents: int, seed: int) -> Session:
    """Render a mix's sequence from ``seed`` and lay it out for
    ``n_agents`` agents."""
    w, s = mix["world"], mix["sequence"]
    world = corridor_world(np.random.default_rng(int(w["seed"])),
                           n_points=w["n_points"], length=w["length"],
                           width=w["width"], height=w["height"])
    scans, odom, _ = corridor_sequence(
        np.random.default_rng(int(seed)), n_scans=s["n_scans"],
        scan_points=s["scan_points"], step=s["step"], noise=s["noise"],
        odom_noise=s["odom_noise"], x0=s["x0"], z=s["z"],
        max_range=s["max_range"], world=world)
    steps = int(mix["steps"])
    stagger = int(mix["agents"]["stagger"])
    offset = np.asarray(mix["agents"]["offset"], np.float32)
    index = np.array([[i + b % stagger for b in range(n_agents)]
                      for i in range(steps)])
    if index.max() >= len(scans):
        raise ValueError(f"mix needs scan {index.max()}, the sequence has "
                         f"{len(scans)}")
    shift = np.tile(np.eye(4, dtype=np.float32), (n_agents, 1, 1))
    shift[:, :3, 3] = np.arange(n_agents)[:, None] * offset
    odom_a = np.stack([shift @ np.stack([odom[j] for j in row])
                       for row in index]).astype(np.float32)
    return Session(scans=scans, index=index, odom=odom_a,
                   max_range=float(s["max_range"]))
