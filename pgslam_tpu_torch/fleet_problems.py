"""The fleet's configurations and fixtures, copied from the JAX package's
benchmarks so that the port can drive them where JAX is not installed.
The CPU tests hold each copy to its original.

* :func:`fleet_config`: ``tests/test_slam_e2e.py::small_config``, the
  configuration of BASELINE config 5 (``scripts/bench_configs.py::
  config5_multi_agent``), and :func:`config5_sequence`, its 72-scan
  corridor; agent ``b`` runs scan ``i + b % 3`` at step ``i``.
* :func:`batched_icp_config` and the headline fixtures
  (``bench.py::generate_stage_a`` and the stage-B maps): B agents, each
  registering a 1024-point int16 packet (1 mm fixed point) decimated from
  a 65536-point render against its own 8192-point reference map.
"""

from __future__ import annotations

import numpy as np

from .datasets import corridor_sequence, corridor_world, render_scan
from .localizer import LocalizerConfig
from .loopcloser import LoopCloserConfig
from .ops import filters as F
from .ops import outlier as O
from .ops.icp import ICPConfig
from .slam import SlamConfig

# bench.py's FIXTURE_PARAMS, the parts the headline fixtures bake in.
HEADLINE = {
    "world": {"seed": 0, "n_points": 300000, "length": 120.0,
              "width": 8.0, "height": 5.0},
    "scan": {"max_range": 30.0, "noise": 0.01},
    "agent": {"x0": 5.0, "dx": 0.85, "z": 1.8},
    "twist_scales": [0.15, 0.15, 0.03, 0.005, 0.005, 0.02],
    "block_seed": 1000,
    "map_seed": 142,
}
QSCALE = 1000.0          # 1 mm fixed point
HEADLINE_POINTS = 65536  # points per rendered scan
PACKET_POINTS = 1024     # points per sensor packet
HEADLINE_BATCH = 128     # agents
POSE_ERR_GATE = 0.2      # bench.py's accuracy gate (max twist error)


def fleet_config(sensor_cap: int = 768, kf_cap: int = 512) -> SlamConfig:
    """``tests/test_slam_e2e.py::small_config``, field for field."""
    icp = ICPConfig(error="point_to_point", max_iterations=30,
                    outlier=(O.TrimmedDist(0.9), O.MaxDist(0.5)),
                    trans_eps=1e-3, rot_eps=1e-3,
                    max_correction_trans=2.0, max_correction_rot=0.5)
    return SlamConfig(
        localizer=LocalizerConfig(icp=icp, keyframe_cloud_capacity=kf_cap,
                                  overlap_threshold=0.8),
        loop_closer=LoopCloserConfig(
            icp=icp, topo_dist_threshold=6.0, geom_dist_threshold=3.0,
            overlap_threshold=0.7, residual_error_threshold=5000.0),
        sensor_cloud_capacity=sensor_cap)


def config5_sequence(n_scans: int = 72):
    """BASELINE config 5's corridor: (scans, odometry, truth)."""
    return corridor_sequence(np.random.default_rng(7), n_scans=n_scans,
                             scan_points=512, step=0.25, noise=0.003,
                             odom_noise=0.005, length=60.0)


def batched_icp_config() -> ICPConfig:
    """``bench.py::batched_icp_config``: point-to-plane, TrimmedDist 0.9 +
    MaxDist 1.0, a coarse stage on every 8th point for 8 iterations, then
    5 fine iterations; references voxelized to 0.2 m, compacted to 8192
    points, with 8-NN normals."""
    return ICPConfig(
        error="point_to_plane", matcher="pallas", pallas_precision="high",
        reference_filters=(F.VoxelGrid(voxel_size=0.2, hash_size=1 << 18),
                           F.Compact(8192),
                           F.SurfaceNormal(knn=8, tile_query=4096)),
        outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)),
        coarse_div=8, coarse_iterations=8, max_iterations=5,
        trans_eps=1e-4, rot_eps=1e-4)


def headline_world() -> np.ndarray:
    w = HEADLINE["world"]
    return corridor_world(np.random.default_rng(w["seed"]),
                          n_points=w["n_points"], length=w["length"],
                          width=w["width"], height=w["height"])


def agent_pose(b: int) -> np.ndarray:
    a = HEADLINE["agent"]
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [a["x0"] + b * a["dx"], 0.0, a["z"]]
    return T


def np_se3_exp(twists) -> np.ndarray:
    """Batched SE(3) exp in numpy ([t; r] twists), ``bench.py::
    _np_se3_exp``."""
    tw = np.asarray(twists, np.float64)
    v, w = tw[..., :3], tw[..., 3:]
    th = np.linalg.norm(w, axis=-1)
    th2 = th * th
    small = th < 1e-4
    A = np.where(small, 1.0 - th2 / 6.0, np.sin(th) / np.where(small, 1, th))
    B = np.where(small, 0.5 - th2 / 24.0,
                 (1 - np.cos(th)) / np.where(small, 1, th2))
    C = np.where(small, 1.0 / 6.0 - th2 / 120.0,
                 (1 - A) / np.where(small, 1, th2))
    W = np.zeros(tw.shape[:-1] + (3, 3))
    W[..., 0, 1], W[..., 0, 2] = -w[..., 2], w[..., 1]
    W[..., 1, 0], W[..., 1, 2] = w[..., 2], -w[..., 0]
    W[..., 2, 0], W[..., 2, 1] = -w[..., 1], w[..., 0]
    WW = W @ W
    I = np.broadcast_to(np.eye(3), W.shape)
    R = I + A[..., None, None] * W + B[..., None, None] * WW
    V = I + B[..., None, None] * W + C[..., None, None] * WW
    T = np.tile(np.eye(4, dtype=np.float32), tw.shape[:-1] + (1, 1))
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    return T


def headline_packets(world: np.ndarray, n_blocks: int,
                     batch: int = HEADLINE_BATCH,
                     n_points: int = HEADLINE_POINTS,
                     packet_points: int = PACKET_POINTS):
    """The headline's sensor packets (``bench.py::generate_stage_a``'s
    ``lean_packets`` and ``offsets``): per block, each agent's scan
    rendered at its pose, moved by the inverse of a random offset, then
    every ``n_points // packet_points``-th point quantized to 1 mm int16.
    Returns (packets ``[n_blocks, batch, packet_points, 3]`` int16,
    offsets ``[n_blocks, batch, 4, 4]``): registering a packet against
    its agent's map should recover the offset."""
    stride = n_points // packet_points
    packets, offsets = [], []
    for bi in range(n_blocks):
        brng = np.random.default_rng(HEADLINE["block_seed"] + bi)
        raw = np.stack([render_scan(world, agent_pose(b), brng, n_points,
                                    **HEADLINE["scan"])
                        for b in range(batch)])
        offs = np_se3_exp(brng.normal(size=(batch, 6))
                          * HEADLINE["twist_scales"]).astype(np.float32)
        inv = np.linalg.inv(offs)
        rr = (np.einsum("bij,bnj->bni", inv[:, :3, :3], raw)
              + inv[:, None, :3, 3]).astype(np.float32)
        q = np.clip(np.round(rr[:, ::stride] * QSCALE), -32767, 32767)
        packets.append(np.ascontiguousarray(q.astype(np.int16)))
        offsets.append(offs)
    return np.stack(packets), np.stack(offsets)


def headline_maps(world: np.ndarray, batch: int = HEADLINE_BATCH,
                  n_points: int = HEADLINE_POINTS) -> np.ndarray:
    """Each agent's raw map scan (the stage-B render before the reference
    chain), ``[batch, n_points, 3]``, seed ``142 + b``."""
    return np.stack([render_scan(world, agent_pose(b),
                                 np.random.default_rng(HEADLINE["map_seed"]
                                                       + b),
                                 n_points, **HEADLINE["scan"])
                     for b in range(batch)])
