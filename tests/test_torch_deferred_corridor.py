"""The cases of ``tests/test_localizer_deferred.py`` on the port: the
deferred-commit scan path (``sync_lag`` > 0) on BASELINE config 5's
configuration (``fleet_problems.fleet_config``) over the 25-scan
corridor, with the JAX package's tolerances."""

import dataclasses

import numpy as np
import pytest

from pgslam_tpu_torch.cloud import make_cloud
from pgslam_tpu_torch.datasets import corridor_sequence
from pgslam_tpu_torch.fleet_problems import fleet_config
from pgslam_tpu_torch.slam import PoseGraphSlam
from torch_threads import one_torch_thread  # noqa: F401


def _config(lag):
    cfg = fleet_config()
    return dataclasses.replace(
        cfg, localizer=dataclasses.replace(cfg.localizer, sync_lag=lag))


def _run(config, scans, odom):
    slam = PoseGraphSlam(config, device="cpu")
    T_rs = np.eye(4, dtype=np.float32)
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        slam.add_data(i, "world", T_odom, T_rs, scan)
    slam.flush()
    return slam


@pytest.fixture(scope="module")
def corridor():
    rng = np.random.default_rng(7)
    return corridor_sequence(rng, n_scans=25, scan_points=512, step=0.4,
                             noise=0.003, odom_noise=0.005, length=30.0)


@pytest.fixture(scope="module")
def runs(corridor):
    scans, odom, truth = corridor
    return _run(_config(0), scans, odom), _run(_config(1), scans, odom), truth


def test_deferred_tracks_truth(runs):
    _, lag1, truth = runs
    err = np.linalg.norm(lag1.T_world_robot[:3, 3] - truth[-1][:3, 3])
    assert err < 0.25, f"final pose error {err}"


def test_deferred_matches_sync_trajectory(runs):
    """Decisions lag one scan, so keyframes may shift by one scan, but the
    final pose agrees with the classic path within 0.10 m and every
    deferred keyframe lies within 0.55 m of a classic one."""
    sync, lag1, _ = runs
    d = np.linalg.norm(sync.T_world_robot[:3, 3]
                       - lag1.T_world_robot[:3, 3])
    assert d < 0.10, f"sync vs deferred final pose differ by {d}"
    gs, gl = sync.get_graph(), lag1.get_graph()
    assert abs(gs.n_vertices - gl.n_vertices) <= 1
    ps = gs.optimized_poses[:gs.n_vertices, :3, 3]
    pl = gl.optimized_poses[:gl.n_vertices, :3, 3]
    for v in range(min(gs.n_vertices, gl.n_vertices)):
        dmin = np.min(np.linalg.norm(ps - pl[v], axis=1))
        assert dmin < 0.55, f"keyframe {v} strays {dmin} from the sync set"


def test_deferred_parity_before_decisions(corridor):
    """Five scans over 1.6 m never leave overlap 0.8: until a decision
    fires, lag 1 registers against the classic path's map, so the poses
    agree within 2e-3."""
    scans, odom, _ = corridor
    sync = _run(_config(0), scans[:5], odom[:5])
    lag1 = _run(_config(1), scans[:5], odom[:5])
    d = np.linalg.norm(sync.T_world_robot - lag1.T_world_robot)
    assert d < 2e-3, f"pre-decision parity broke: {d}"


def test_flush_is_idempotent_and_required(corridor):
    scans, odom, _ = corridor
    slam = PoseGraphSlam(_config(2), device="cpu")
    T_rs = np.eye(4, dtype=np.float32)
    for i in range(6):
        slam.localizer.process_data(
            odom[i].astype(np.float32), T_rs,
            make_cloud(scans[i], capacity=slam.config.sensor_cloud_capacity))
    assert len(slam.localizer._inflight) == 2
    slam.flush()
    assert len(slam.localizer._inflight) == 0
    T = slam.localizer.T_world_robot.copy()
    slam.flush()
    np.testing.assert_array_equal(T, slam.localizer.T_world_robot)


ACCESSORS = {
    "trajectory": lambda s, path: s.trajectory(),
    "T_world_robot": lambda s, path: s.T_world_robot,
    "get_graph": lambda s, path: s.get_graph(),
    "get_local_map": lambda s, path: s.get_local_map(),
    "get_local_map_in_world_frame":
        lambda s, path: s.get_local_map_in_world_frame(),
    "n_loop_edges": lambda s, path: s.n_loop_edges(),
    "write_graphviz": lambda s, path: s.write_graphviz(path),
}


@pytest.mark.parametrize("accessor", list(ACCESSORS))
def test_facade_accessors_autoflush(corridor, accessor, tmp_path):
    scans, odom, _ = corridor
    slam = PoseGraphSlam(_config(3), device="cpu")
    T_rs = np.eye(4, dtype=np.float32)
    for i in range(5):
        slam.add_data(i, "world", odom[i], T_rs, scans[i])
    assert len(slam.localizer._inflight) > 0
    ACCESSORS[accessor](slam, str(tmp_path / "g.dot"))
    assert len(slam.localizer._inflight) == 0


def test_lag2_still_tracks(corridor):
    scans, odom, truth = corridor
    lag2 = _run(_config(2), scans, odom)
    err = np.linalg.norm(lag2.T_world_robot[:3, 3] - truth[-1][:3, 3])
    assert err < 0.30, f"final pose error {err}"
