"""The two replays the port is held against, with their configurations.

Both reproduce, seed for seed, the runs that recorded the JAX package's
single-threaded trajectories in ``tests/fixtures/``:

* ``loop``: 70 scans of 512 points around a 10 m ring with odometric
  drift; point-to-point ICP; 20 keyframes and one accepted loop closure
  (``golden_replay.npz``).
* ``corridor_64k``: 16 Velodyne-scale 65536-point scans down a corridor,
  1 m apart, with the production point-to-plane profile at a 2k/8k voxel
  working set; 4 keyframes (``golden_replay_64k.npz``).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from .datasets import corridor_world, loop_sequence, render_scan
from .localizer import LocalizerConfig
from .loopcloser import LoopCloserConfig
from .ops import filters as F
from .ops import outlier as O
from .ops.icp import ICPConfig
from .slam import PoseGraphSlam, SlamConfig

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures")


def loop_sequence_golden():
    rng = np.random.default_rng(3)
    return loop_sequence(rng, n_scans=70, scan_points=512, radius=10.0,
                         max_range=8.0, noise=0.002, odom_drift=0.002)


def loop_config() -> SlamConfig:
    """``tests/golden_replay.py::golden_config``, field for field."""
    icp = ICPConfig(error="point_to_point", max_iterations=40,
                    outlier=(O.TrimmedDist(0.85), O.MaxDist(0.5)),
                    trans_eps=1e-3, rot_eps=1e-3,
                    max_correction_trans=2.0, max_correction_rot=0.5)
    return SlamConfig(
        localizer=LocalizerConfig(icp=icp, keyframe_cloud_capacity=512,
                                  overlap_threshold=0.8),
        loop_closer=LoopCloserConfig(
            icp=icp, topo_dist_threshold=10.0, geom_dist_threshold=4.0,
            overlap_threshold=0.6, residual_error_threshold=5000.0),
        sensor_cloud_capacity=512)


def corridor_64k_sequence(n_scans: int = 16):
    rng = np.random.default_rng(0)
    world = corridor_world(rng, n_points=200000, length=60.0, width=8.0,
                           height=5.0)
    poses, scans = [], []
    for i in range(n_scans):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [2.0 + i * 1.0, 0.0, 1.8]
        poses.append(T)
        scans.append(render_scan(world, T, rng, 65536, max_range=30.0,
                                 noise=0.01))
    return scans, poses, poses


def velodyne_config() -> SlamConfig:
    """``examples/velodyne_slam.py::velodyne_config()`` (sync_lag=0),
    field for field: the 64k-point point-to-plane profile."""
    icp = ICPConfig(
        error="point_to_plane", matcher="pallas",
        pallas_precision="high",
        reading_filters=(F.VoxelGrid(voxel_size=0.4, hash_size=1 << 17),
                         F.Compact(2048)),
        reference_filters=(F.VoxelGrid(voxel_size=0.2, hash_size=1 << 18),
                           F.Compact(8192),
                           F.SurfaceNormal(knn=8, tile_query=4096)),
        outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)),
        coarse_div=8, coarse_iterations=8,
        max_iterations=5, trans_eps=1e-4, rot_eps=1e-4,
        max_correction_trans=3.0, max_correction_rot=0.5)
    verify_icp = dataclasses.replace(icp, max_iterations=24)
    return SlamConfig(
        localizer=LocalizerConfig(icp=icp, keyframe_cloud_capacity=65536,
                                  overlap_threshold=0.8, sync_lag=0),
        loop_closer=LoopCloserConfig(icp=verify_icp,
                                     topo_dist_threshold=30.0,
                                     geom_dist_threshold=10.0,
                                     overlap_threshold=0.6,
                                     deferred_verification=False),
        sensor_cloud_capacity=65536)


REPLAYS = {
    "loop": (loop_sequence_golden, loop_config, "golden_replay.npz"),
    "corridor_64k": (corridor_64k_sequence, velodyne_config,
                     "golden_replay_64k.npz"),
}


def run_replay(name: str, device=None, sync=None, config=None):
    """Drive :class:`PoseGraphSlam` over a replay. Returns (per-scan poses
    ``[n, 4, 4]``, keyframe trajectory, stats). ``device`` None means the
    GPU; ``config`` replaces the replay's own ``SlamConfig``. ``sync`` is
    called after every scan so that the per-scan time covers the device's
    work."""
    make_seq, make_cfg, _ = REPLAYS[name]
    scans, odom, _ = make_seq()
    slam = PoseGraphSlam(config or make_cfg(), device=device)
    T_rs = np.eye(4, dtype=np.float32)
    per_scan, times = [], []
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        t0 = time.perf_counter()
        slam.add_data(i, "world", T_odom, T_rs, scan)
        if sync is not None:
            sync()
        times.append(time.perf_counter() - t0)
        per_scan.append(slam.localizer.T_world_robot.copy())
    g = slam.get_graph()
    stats = {"n_keyframes": int(g.n_vertices),
             "n_loops": slam.n_loop_edges(),
             "opt_runs": slam.optimizer.runs,
             "scan_seconds": times}
    return np.stack(per_scan), slam.trajectory(), stats


def fixture(name: str) -> dict:
    data = np.load(os.path.join(FIXTURES, REPLAYS[name][2]))
    return {k: data[k] for k in data.files}


def max_pose_gap(per_scan: np.ndarray, golden: np.ndarray,
                 window: int = 0) -> float:
    """Largest per-scan translation gap to the fixture, in metres. With
    ``window`` > 0 each scan is held to the nearest fixture pose within
    +-window scans (``tests/test_golden_replay.py::_pose_errs``)."""
    d = np.linalg.norm(per_scan[:, None, :3, 3] - golden[None, :, :3, 3],
                       axis=-1)
    ix = np.arange(len(per_scan))
    errs = d[ix, ix]
    for w in range(1, window + 1):
        errs[w:] = np.minimum(errs[w:], d[ix[w:], ix[:-w]])
        errs[:-w] = np.minimum(errs[:-w], d[ix[:-w], ix[w:]])
    return float(errs.max())
