"""The replays the port is held against, with their configurations.

Each reproduces, seed for seed, a run that recorded the JAX package's
single-threaded trajectory in ``tests/fixtures/``:

* ``loop``: 70 scans of 512 points around a 10 m ring with odometric
  drift; point-to-point ICP; 20 keyframes and one accepted loop closure
  (``golden_replay.npz``).
* ``corridor_64k``: 16 Velodyne-scale 65536-point scans down a corridor,
  1 m apart, with the production point-to-plane profile at a 2k/8k voxel
  working set; 4 keyframes (``golden_replay_64k.npz``).
* ``long``: 300 scans of 512 points over a 3-petal clover under the
  loop's config; 50 keyframes, 3 accepted closures, 11 composition swaps
  and 3 optimizer runs (``golden_replay_long.npz``).
* ``yaml_clover``: ``examples/slam_config.yaml`` (``from_yaml``) over the
  first YAML_CLOVER_SCANS scans of the clover at 2048 points a scan, the
  config's own ``sensorCloudCapacity`` (``golden_replay_yaml.npz``).
* ``p2plane``: the same scans under ``from_config_paths`` with
  ``examples/icp_point_to_plane.yaml`` for both ICP pipelines and the
  ``inputFilters`` list of ``slam_config.yaml`` as the input filters:
  ``RandomSampling``, ``ObservationDirection``, ``MaxDist`` and normals
  at k = 10. Its draws are not the JAX package's, so it is held to the
  truth, in an envelope around the JAX package's run
  (``golden_replay_p2plane.npz``).
* ``grid``: the loop with both ICP pipelines on the voxel-hash grid
  matcher (cell size from ``auto_cell_size``, 8 ids a bucket)
  (``golden_replay_grid.npz``).

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

from .datasets import (clover_sequence, corridor_world, loop_sequence,
                       render_scan)
from .localizer import LocalizerConfig
from .loopcloser import LoopCloserConfig
from .ops import filters as F
from .ops import outlier as O
from .ops.icp import ICPConfig
from .slam import PoseGraphSlam, SlamConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
SLAM_YAML = os.path.join(ROOT, "examples", "slam_config.yaml")
P2PLANE_YAML = os.path.join(ROOT, "examples", "icp_point_to_plane.yaml")
# The prefix of the 2048-point clover the YAML replays run: the JAX
# package's run of slam_config.yaml accepts its first closure and runs its
# first optimize within it.
YAML_CLOVER_SCANS = 120


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


def long_sequence():
    """``tests/golden_replay.py::long_sequence``."""
    return clover_sequence(np.random.default_rng(5), n_scans=300,
                           scan_points=512, petals=3, radius=8.0,
                           noise=0.002, odom_drift=0.002)


def yaml_clover_sequence():
    """The first YAML_CLOVER_SCANS scans of the 300-scan clover at 2048
    points a scan."""
    seq = clover_sequence(np.random.default_rng(5), n_scans=300,
                          scan_points=2048, petals=3, radius=8.0,
                          noise=0.002, odom_drift=0.002)
    return tuple(part[:YAML_CLOVER_SCANS] for part in seq)


def yaml_config() -> SlamConfig:
    """``PoseGraphSlam.from_yaml(SLAM_YAML)``'s config."""
    from .config import load_slam_config
    return load_slam_config(SLAM_YAML)


def input_filters_yaml(directory: str) -> str:
    """Write the ``localizer.inputFilters`` list of SLAM_YAML as its own
    YAML file in ``directory``; returns its path."""
    import yaml
    with open(SLAM_YAML) as fh:
        chain = yaml.safe_load(fh)["localizer"]["inputFilters"]
    path = os.path.join(directory, "input_filters.yaml")
    with open(path, "w") as fh:
        yaml.safe_dump(chain, fh)
    return path


def p2plane_config() -> SlamConfig:
    """``PoseGraphSlam.from_config_paths(P2PLANE_YAML, <SLAM_YAML's input
    filters>, P2PLANE_YAML)``'s config."""
    import tempfile

    from .config import load_icp_config, load_input_filters
    icp = load_icp_config(P2PLANE_YAML)
    with tempfile.TemporaryDirectory() as tmp:
        chain = load_input_filters(input_filters_yaml(tmp))
    return SlamConfig(
        localizer=LocalizerConfig(icp=icp, input_filters=chain),
        loop_closer=LoopCloserConfig(icp=icp))


def grid_config() -> SlamConfig:
    """The loop's config with both ICP pipelines on the grid matcher."""
    cfg = loop_config()
    icp = dataclasses.replace(cfg.localizer.icp, matcher="grid",
                              grid_cell_size=0.0, grid_bucket_cap=8)
    return dataclasses.replace(
        cfg, localizer=dataclasses.replace(cfg.localizer, icp=icp),
        loop_closer=dataclasses.replace(cfg.loop_closer, icp=icp))


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
    "long": (long_sequence, loop_config, "golden_replay_long.npz"),
    "yaml_clover": (yaml_clover_sequence, yaml_config,
                    "golden_replay_yaml.npz"),
    "p2plane": (yaml_clover_sequence, p2plane_config,
                "golden_replay_p2plane.npz"),
    "grid": (loop_sequence_golden, grid_config, "golden_replay_grid.npz"),
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


def _composition(slam) -> tuple:
    return tuple(slam.localizer.local_map.get_composition().as_list())


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
    does. ``stats`` also holds each scan's local-map composition
    (``compositions``), the overlap and ICP iterations of the last
    committed registration (``overlaps``, ``iterations``, None before the
    first) and the keyframe count (``keyframes``), and counts the
    swaps among the compositions (a composition replaced by the same
    keyframes in another order) as ``_replay`` does;
    ``stats["seconds"]`` covers the scans, the flush and the final
    ``sync``, and not these per-scan reads."""
    name, config = _variant(name, config, overrides)
    scans, odom, _ = REPLAYS[name][0]()
    slam = PoseGraphSlam(config, device=device)
    T_rs = np.eye(4, dtype=np.float32)
    per_scan, times, comps, overlaps, keyframes = [], [], [], [], []
    iterations = []
    untimed = 0.0
    t_start = time.perf_counter()
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        t0 = time.perf_counter()
        slam.add_data(i, "world", T_odom, T_rs, scan)
        if sync is not None and sync_every_scan:
            sync()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        per_scan.append(slam.localizer.T_world_robot.copy())
        comps.append(_composition(slam))
        last = slam.localizer.last_result
        overlaps.append(None if last is None else float(last.overlap))
        iterations.append(None if last is None else int(last.iterations))
        # The map manager's graph: slam.get_graph() would flush the
        # deferred commits and change the replay.
        keyframes.append(slam.map_manager.get_graph().n_vertices)
        untimed += time.perf_counter() - t1
    slam.flush()
    if sync is not None:
        sync()
    seconds = time.perf_counter() - t_start - untimed
    loc = config.localizer
    if loc.sync_lag or loc.micro_batch > 1:
        per_scan[-1] = slam.localizer.T_world_robot.copy()
    swaps = sum(a != b and set(a) == set(b) for a, b in zip(comps, comps[1:]))
    return np.stack(per_scan), slam.trajectory(), _stats(
        slam, seconds, scan_seconds=times, n_swaps=swaps,
        compositions=comps, overlaps=overlaps, keyframes=keyframes,
        iterations=iterations)


def run_replay_resumed(name: str, checkpoint_at: int, path: str,
                       device=None, sync=None):
    """The replay run twice on the classic path: uninterrupted, with a
    checkpoint (``io.save_checkpoint`` with the localizer) written to
    ``path`` after scan ``checkpoint_at - 1``; then a fresh facade loads
    it and runs the scans from ``checkpoint_at`` on. Returns (the
    uninterrupted run's per-scan poses, the resumed run's per-scan poses
    from ``checkpoint_at``, the resumed facade)."""
    from .io import load_checkpoint, save_checkpoint
    scans, odom, _ = REPLAYS[name][0]()
    config = REPLAYS[name][1]()
    T_rs = np.eye(4, dtype=np.float32)

    def drive(slam, first):
        poses = []
        for i in range(first, len(scans)):
            slam.add_data(i, "world", odom[i], T_rs, scans[i])
            if sync is not None:
                sync()
            poses.append(slam.localizer.T_world_robot.copy())
            if i + 1 == checkpoint_at and first == 0:
                save_checkpoint(path, slam.map_manager, slam.localizer)
        return np.stack(poses)

    full = drive(PoseGraphSlam(config, device=device), 0)
    resumed = PoseGraphSlam(config, device=device)
    load_checkpoint(path, resumed.map_manager, resumed.localizer)
    return full, drive(resumed, checkpoint_at), resumed


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


def per_scan_gaps(per_scan: np.ndarray, golden: np.ndarray) -> np.ndarray:
    """Each scan's translation gap to the fixture, in metres."""
    return np.linalg.norm(per_scan[:, :3, 3] - golden[:, :3, 3], axis=1)


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
