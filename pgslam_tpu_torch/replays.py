"""The replays the port is held against, with their configurations.

Both reproduce, seed for seed, the runs that recorded the JAX package's
single-threaded trajectories in ``tests/fixtures/``:

* ``loop``: 70 scans of 512 points around a 10 m ring with odometric
  drift; point-to-point ICP; 20 keyframes and one accepted loop closure
  (``golden_replay.npz``).
* ``corridor_64k``: 16 Velodyne-scale 65536-point scans down a corridor,
  1 m apart, with the production point-to-plane profile at a 2k/8k voxel
  working set; 4 keyframes (``golden_replay_64k.npz``).

``VARIANTS`` run them on the deferred and streaming paths (the loop at
``sync_lag=2`` with deferred verification and at ``micro_batch=4``, whose
JAX runs ``scripts/make_torch_fixtures.py`` records, and the corridor at
BASELINE config 4's ``sync_lag=2``); :func:`run_replay_mt` drives the
threaded facade.
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


def velodyne_config(sync_lag: int = 0) -> SlamConfig:
    """``examples/velodyne_slam.py::velodyne_config(sync_lag)``, field for
    field: the 64k-point point-to-plane profile; ``sync_lag`` > 0 (the
    deployable live loop, BASELINE config 4 at 2) also defers the loop
    closer's verification."""
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
                                  overlap_threshold=0.8,
                                  sync_lag=sync_lag),
        loop_closer=LoopCloserConfig(icp=verify_icp,
                                     topo_dist_threshold=30.0,
                                     geom_dist_threshold=10.0,
                                     overlap_threshold=0.6,
                                     deferred_verification=sync_lag > 0),
        sensor_cloud_capacity=65536)


REPLAYS = {
    "loop": (loop_sequence_golden, loop_config, "golden_replay.npz"),
    "corridor_64k": (corridor_64k_sequence, velodyne_config,
                     "golden_replay_64k.npz"),
}

# Replays of the deferred and streaming paths: (replay, overrides of
# run_replay, fixture recorded by scripts/make_torch_fixtures.py or None).
VARIANTS = {
    "loop_lag2": ("loop", {"sync_lag": 2, "deferred_verification": True},
                  "golden_replay_lag2.npz"),
    "loop_stream4": ("loop", {"micro_batch": 4}, "golden_replay_stream4.npz"),
    "corridor_64k_lag2": ("corridor_64k", {"sync_lag": 2,
                                           "deferred_verification": True},
                          None),
}


def with_overrides(config: SlamConfig, sync_lag=None, micro_batch=None,
                   force_deferred=None,
                   deferred_verification=None) -> SlamConfig:
    """``config`` with the localizer's ``sync_lag``, ``micro_batch`` and
    ``force_deferred`` and the loop closer's ``deferred_verification``
    replaced where given."""
    loc = {k: v for k, v in (("sync_lag", sync_lag),
                             ("micro_batch", micro_batch),
                             ("force_deferred", force_deferred))
           if v is not None}
    config = dataclasses.replace(
        config, localizer=dataclasses.replace(config.localizer, **loc))
    if deferred_verification is not None:
        config = dataclasses.replace(config, loop_closer=dataclasses.replace(
            config.loop_closer,
            deferred_verification=deferred_verification))
    return config


def _variant(name: str, config, overrides):
    """(replay name, config with the variant's and the caller's
    overrides)."""
    if name in VARIANTS:
        name, extra, _ = VARIANTS[name]
        overrides = {**extra, **overrides}
    return name, with_overrides(config or REPLAYS[name][1](), **overrides)


def _stats(slam, seconds, **extra) -> dict:
    return {"n_keyframes": int(slam.get_graph().n_vertices),
            "n_loops": slam.n_loop_edges(),
            "opt_runs": slam.optimizer.runs, "seconds": seconds, **extra}


def run_replay(name: str, device=None, sync=None, config=None,
               sync_every_scan: bool = True, **overrides):
    """Drive :class:`PoseGraphSlam` over a replay (a name of ``REPLAYS``
    or ``VARIANTS``). Returns (per-scan poses ``[n, 4, 4]``, keyframe
    trajectory, stats). ``device`` None means the GPU; ``config``
    replaces the replay's own ``SlamConfig``; ``overrides`` are
    :func:`with_overrides`'s. ``sync`` is called after every scan, so that
    the per-scan time covers the device's work, or with
    ``sync_every_scan=False`` once after the final flush: a deferred
    replay synchronized per scan gives up what deferral buys. The pose
    reported after a scan trails by the commit lag; the last one is
    replaced by the flushed pose, as ``tests/golden_replay.py::_replay``
    does. ``stats["seconds"]`` covers the scans, the flush and the final
    ``sync``."""
    name, config = _variant(name, config, overrides)
    scans, odom, _ = REPLAYS[name][0]()
    slam = PoseGraphSlam(config, device=device)
    T_rs = np.eye(4, dtype=np.float32)
    per_scan, times = [], []
    t_start = time.perf_counter()
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        t0 = time.perf_counter()
        slam.add_data(i, "world", T_odom, T_rs, scan)
        if sync is not None and sync_every_scan:
            sync()
        times.append(time.perf_counter() - t0)
        per_scan.append(slam.localizer.T_world_robot.copy())
    slam.flush()
    if sync is not None:
        sync()
    seconds = time.perf_counter() - t_start
    loc = config.localizer
    if loc.sync_lag or loc.micro_batch > 1:
        per_scan[-1] = slam.localizer.T_world_robot.copy()
    return np.stack(per_scan), slam.trajectory(), _stats(
        slam, seconds, scan_seconds=times)


def run_replay_mt(name: str, device=None, lockstep: bool = True, sync=None,
                  config=None, timeout: float = 600.0, **overrides):
    """Drive :class:`~pgslam_tpu_torch.pipeline.PoseGraphSlamMT` over a
    replay. ``lockstep`` waits for the pipeline to go idle after every
    scan (the per-scan poses are then comparable with the single-threaded
    replay's); otherwise the scans are queued free-running and the
    pipeline is flushed once at the end, and the per-scan poses are
    those of the last scan. ``sync`` is called once after the flush.
    Returns what :func:`run_replay` does, ``stats["seconds"]`` from the
    first scan queued to the idle, synchronized end."""
    from .pipeline import PoseGraphSlamMT
    name, config = _variant(name, config, overrides)
    scans, odom, _ = REPLAYS[name][0]()
    T_rs = np.eye(4, dtype=np.float32)
    per_scan = []
    with PoseGraphSlamMT(config, device=device) as slam:
        t_start = time.perf_counter()
        for i, (scan, T_odom) in enumerate(zip(scans, odom)):
            slam.add_data(i, "world", T_odom, T_rs, scan)
            if lockstep:
                if not slam.wait_idle(timeout=timeout):
                    raise TimeoutError(f"scan {i} not done in {timeout} s")
                per_scan.append(slam.localizer.T_world_robot.copy())
        slam.flush(timeout=timeout)
        if sync is not None:
            sync()
        seconds = time.perf_counter() - t_start
        if not lockstep:
            per_scan = [slam.localizer.T_world_robot.copy()]
        per_scan[-1] = slam.localizer.T_world_robot.copy()
        stats = _stats(slam, seconds, n_scans=len(scans))
        trajectory = slam.trajectory()
    return np.stack(per_scan), trajectory, stats


def fixture(name: str) -> dict:
    """A committed fixture of a replay or a variant."""
    file = VARIANTS[name][2] if name in VARIANTS else REPLAYS[name][2]
    data = np.load(os.path.join(FIXTURES, file))
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
