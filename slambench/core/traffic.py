"""The traffic generator: sensor sessions made from a mix file and a seed.

``corridor_world``, ``render_scan``, ``loop_world`` and
``clover_sequence`` are frozen copies of the generators in
``pgslam_tpu_torch/datasets.py``; ``corridor_sequence`` is the same
function with the world's size, the start pose and the sensor's range as
parameters, ``loop_world`` takes the corridor's width and height and the
points of a structure, and ``clover_sequence`` the sensor's height and a
world drawn apart (``clover_world``). Their defaults reproduce the
originals draw for draw. They live here so that no later change to the
program moves the traffic.

A mix file (``slambench/mixes/<traffic>.json``) holds::

    {"world": {"kind", "seed", ...},
     "sequence": {...},
     "agents": {"stagger", "offset"},
     "steps": <steps a session>}

``world.kind`` chooses the route, ``"corridor"`` where it is absent:

* ``"corridor"``, a straight corridor: ``world`` {``n_points``,
  ``length``, ``width``, ``height``}, ``sequence`` {``n_scans``,
  ``scan_points``, ``step``, ``x0``, ``z``, ``noise``, ``odom_noise``,
  ``max_range``};
* ``"clover"``, ``petals`` ring corridors of ``radius`` that share one
  centre, driven petal by petal, every return to the centre a revisit
  far along the graph: ``world`` {``petals``, ``radius``, ``n_points``
  and ``structure_points`` a petal, ``width``, ``height``}, ``sequence``
  {``n_scans``, ``scan_points``, ``z``, ``noise``, ``odom_drift``,
  ``max_range``}; a petal takes ``n_scans // petals`` scans, so a step
  is ``2 pi radius`` over that.

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


def loop_world(rng, n_points: int = 40000, radius: float = 12.0,
               width: float = 4.0, height: float = 3.0,
               structure_points=None) -> np.ndarray:
    """An annular corridor with aperiodic boxes and pillars, one
    structure a metre of the ring, ``structure_points`` points each
    (``n_points // 25`` where None)."""
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
    n_box = (max(1, n_points // 25) if structure_points is None
             else int(structure_points))
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


def clover_world(rng, petals: int = 3, radius: float = 8.0,
                 n_points: int = 30000, width: float = 4.0,
                 height: float = 3.0, structure_points=None) -> np.ndarray:
    """``petals`` ring corridors (``loop_world``) whose rings all pass
    through the origin."""
    worlds = []
    for i in range(petals):
        phi = 2 * np.pi * i / petals
        w = loop_world(rng, n_points=n_points, radius=radius, width=width,
                       height=height, structure_points=structure_points)
        c = radius * np.array([np.cos(phi), np.sin(phi), 0.0])
        worlds.append(w + c)
    return np.concatenate(worlds, 0)


def clover_sequence(rng, n_scans: int = 300, scan_points: int = 512,
                    petals: int = 3, radius: float = 8.0,
                    noise: float = 0.002, odom_drift: float = 0.002,
                    max_range: float = 7.0, z: float = 1.2, world=None,
                    render=render_scan
                    ) -> Tuple[List[np.ndarray], List[np.ndarray],
                               List[np.ndarray]]:
    """Clover trajectory: the robot drives each petal in turn and returns
    to the centre between petals, so every petal return is a revisit far
    along the graph. Returns (scans, odometry poses with drift, true
    poses). ``world`` given, the clover is not drawn from ``rng``;
    ``render`` makes each scan (``render_scan``'s arguments)."""
    if world is None:
        world = clover_world(rng, petals=petals, radius=radius)
    per = n_scans // petals
    scans, odom, truth = [], [], []
    T_odom = None
    prev_true = None
    for i in range(n_scans):
        petal = min(i // per, petals - 1)
        theta = 2 * np.pi * (i - petal * per) / per
        phi = 2 * np.pi * petal / petals
        c = radius * np.array([np.cos(phi), np.sin(phi)])
        ang = phi + np.pi + theta
        pos = c + radius * np.array([np.cos(ang), np.sin(ang)])
        T_true = _se3(pos[0], pos[1], z, yaw=ang + np.pi / 2)
        scans.append(render(world, T_true, rng, scan_points,
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


def render_on_device(world: np.ndarray, poses, seed: int, scan_points: int,
                     max_range: float, noise: float, device="cpu"
                     ) -> List[np.ndarray]:
    """Scans of ``world`` from the sensor poses ``poses``, drawn on
    ``device`` by a ``torch.Generator`` seeded with ``seed``: each takes
    ``scan_points`` of the world points within ``max_range`` of the
    sensor, uniformly without replacement (the first visible ones of a
    random permutation), in the sensor frame, plus Gaussian noise. The
    same seed on the same kind of device gives the same scans.
    ``render_scan`` spends most of a spin on its distances to every world
    point, on the host; here they are a few launches."""
    import torch
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    W = torch.as_tensor(np.asarray(world, np.float32), device=dev)
    out = []
    for T in poses:
        T = torch.as_tensor(np.asarray(T, np.float32), device=dev)
        rel = W - T[:3, 3]
        visible = (rel * rel).sum(-1) <= max_range * max_range
        perm = torch.randperm(W.shape[0], generator=gen, device=dev)
        take = perm[visible[perm]][:scan_points]
        if take.shape[0] < scan_points:
            raise ValueError(f"{take.shape[0]} world points in range, "
                             f"a scan takes {scan_points}")
        # R^T (p - t) row by row, as an elementwise product: no matmul
        # whose precision a setting could change.
        local = (rel[take][:, :, None] * T[:3, :3][None]).sum(1)
        out.append(local + noise * torch.randn(
            (scan_points, 3), generator=gen, device=dev))
    host = torch.stack(out).cpu().numpy()
    return list(host)


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


def render(mix: dict, seed: int, device="cpu"):
    """A mix's sequence rendered from ``seed``: (scans, odometry, true
    poses). The clover's scans are drawn on ``device``."""
    w, s = mix["world"], mix["sequence"]
    kind = w.get("kind", "corridor")
    rng_world = np.random.default_rng(int(w["seed"]))
    if kind == "corridor":
        world = corridor_world(rng_world, n_points=w["n_points"],
                               length=w["length"], width=w["width"],
                               height=w["height"])
        return corridor_sequence(
            np.random.default_rng(int(seed)), n_scans=s["n_scans"],
            scan_points=s["scan_points"], step=s["step"], noise=s["noise"],
            odom_noise=s["odom_noise"], x0=s["x0"], z=s["z"],
            max_range=s["max_range"], world=world)
    if kind == "clover":
        world = clover_world(rng_world, petals=w["petals"],
                             radius=w["radius"], n_points=w["n_points"],
                             width=w["width"], height=w["height"],
                             structure_points=w.get("structure_points"))
        _, odom, truth = clover_sequence(
            np.random.default_rng(int(seed)), n_scans=s["n_scans"],
            petals=w["petals"], radius=w["radius"],
            odom_drift=s["odom_drift"], z=s["z"], world=world,
            render=lambda *a, **kw: None)
        scans = render_on_device(world, truth, seed, s["scan_points"],
                                 s["max_range"], s["noise"], device)
        return scans, odom, truth
    raise ValueError(f"unknown world kind {kind!r}")


def make_session(mix: dict, n_agents: int, seed: int,
                 device="cpu") -> Session:
    """Render a mix's sequence from ``seed`` (the clover's scans on
    ``device``) and lay it out for ``n_agents`` agents."""
    scans, odom, _ = render(mix, seed, device)
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
                   max_range=float(mix["sequence"]["max_range"]))
