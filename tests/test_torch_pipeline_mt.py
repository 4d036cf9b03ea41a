"""The port's threaded pipeline (``PoseGraphSlamMT``): the golden loop
driven in lockstep and free-running against the JAX fixture, the cases
of ``tests/test_mt_semantics.py`` and ``tests/test_pipeline_mt.py``, the
optimizer's prepare-time snapshot, a worker's failure surfacing, and the
launch counters' lock under threads."""

import collections
import sys
import threading
import time

import numpy as np
import pytest

from pgslam_tpu_torch import _build, replays
from pgslam_tpu_torch.cloud import make_cloud
from pgslam_tpu_torch.datasets import corridor_sequence
from pgslam_tpu_torch.fleet_problems import fleet_config
from pgslam_tpu_torch.graph.pose_graph import ODOM_CONSTRAINT, MapManager
from pgslam_tpu_torch.localizer import LocalizerConfig
from pgslam_tpu_torch.loopcloser import LoopCloser, LoopCloserConfig
from pgslam_tpu_torch.optimizer import Optimizer
from pgslam_tpu_torch.pipeline import (LocalizerMT, MapManagerMT,
                                       OptimizerMT, PoseGraphSlamMT,
                                       WorkerError)
from torch_threads import one_torch_thread  # noqa: F401

POSE_TOL_M = 0.10   # tests/test_golden_replay.py:76 and :154


def test_mt_lockstep_loop_matches_golden():
    per_scan, trajectory, stats = replays.run_replay_mt("loop", device="cpu")
    gold = replays.fixture("loop")
    # +-1 scan: the MT localizer applies a writeback one scan later than
    # the single-threaded path (tests/test_golden_replay.py::_pose_errs).
    gap = replays.max_pose_gap(per_scan, gold["per_scan_poses"], window=1)
    assert gap < POSE_TOL_M, f"MT per-scan max dev {gap}"
    assert stats["n_loops"] == int(gold["n_loop_edges"])
    assert len(trajectory) == stats["n_keyframes"]


def test_mt_free_running_final_pose():
    per_scan, _, stats = replays.run_replay_mt("loop", device="cpu",
                                               lockstep=False)
    gold = replays.fixture("loop")["per_scan_poses"]
    err = np.linalg.norm(per_scan[-1][:3, 3] - gold[-1][:3, 3])
    assert err < POSE_TOL_M, f"MT final-pose deviation {err}"
    assert stats["n_loops"] >= 1


def _T_at(x):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = x
    return T


def _chain(mm, rng, n):
    mm.add_first_keyframe(
        make_cloud(rng.normal(size=(8, 3)).astype(np.float32)), _T_at(0.0))
    for i in range(1, n):
        mm.graph.add_vertex(
            make_cloud(rng.normal(size=(8, 3)).astype(np.float32)),
            _T_at(float(i)), mm.now())
        mm.graph.add_edge(i - 1, i, _T_at(1.0), np.eye(6, dtype=np.float32),
                          ODOM_CONSTRAINT)
    return mm


def test_optimizer_mt_batches_all_pending(rng):
    """Constraints queued before the worker starts are consumed by one
    optimization."""
    mm = _chain(MapManagerMT(), rng, 6)
    opt = OptimizerMT(mm, device="cpu")
    cov = (np.eye(6) * 0.01).astype(np.float32)
    opt.add_new_data(0, 3, _T_at(3.0), cov)
    opt.add_new_data(1, 4, _T_at(3.0), cov)
    opt.run()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and not (
            opt.idle() and mm.graph.n_edges >= 7):
        time.sleep(0.05)
    opt.stop()
    opt.raise_error()
    assert mm.get_graph().n_edges == 7
    assert opt.runs == 1 and opt.last_stats is not None


def test_localizer_mt_outdated_flag(rng):
    """update_from_graph only flags; the worker resyncs."""
    mm = _chain(MapManagerMT(), rng, 3)
    loc = LocalizerMT(mm, LocalizerConfig(keyframe_cloud_capacity=8),
                      device="cpu")
    loc.update_from_graph()
    assert loc._outdated and not loc.idle()
    loc.stop()


def test_localizer_mt_rejects_micro_batch():
    with pytest.raises(ValueError, match="micro_batch"):
        LocalizerMT(MapManagerMT(), LocalizerConfig(micro_batch=4),
                    device="cpu")


def test_loopcloser_queue_mode_batched(rng):
    """queue_mode defers verification; process_pending_batched verifies
    the queue in one batch."""
    class FakeOpt:
        def __init__(self):
            self.calls = []

        def add_new_data(self, f, t, T, c):
            self.calls.append((f, t))

    mm = MapManager()
    pts = rng.uniform(-2, 2, size=(64, 3)).astype(np.float32)
    pts[:, 2] = np.sign(pts[:, 2])
    mm.add_first_keyframe(make_cloud(pts, capacity=64), _T_at(0.0))
    positions = [0.0, 2.0, 4.0, 6.0, 4.1, 2.1, 0.2]
    for i in range(1, len(positions)):
        mm.graph.add_vertex(make_cloud(pts, capacity=64),
                            _T_at(positions[i]), mm.now())
        mm.graph.add_edge(i - 1, i, _T_at(positions[i] - positions[i - 1]),
                          np.eye(6, dtype=np.float32), ODOM_CONSTRAINT)
    lc = LoopCloser(mm, FakeOpt(), LoopCloserConfig(
        topo_dist_threshold=5.0, geom_dist_threshold=1.0,
        overlap_threshold=0.5), device="cpu")
    lc.queue_mode = True
    lc.add_new_vertex(6)
    assert lc._pending == [6]
    lc.process_pending_batched()
    assert lc._pending == []
    assert lc.last_result is not None


def test_mt_corridor_tracks_truth():
    """tests/test_pipeline_mt.py::test_mt_corridor_matches_st."""
    rng = np.random.default_rng(7)
    scans, odom, truth = corridor_sequence(
        rng, n_scans=15, scan_points=512, step=0.4, noise=0.003,
        odom_noise=0.005, length=30.0)
    with PoseGraphSlamMT(fleet_config(), device="cpu") as slam:
        T_rs = np.eye(4, dtype=np.float32)
        for i, (scan, T_odom) in enumerate(zip(scans, odom)):
            slam.add_data(i, "world", T_odom, T_rs, scan)
        assert slam.wait_idle(timeout=600.0)
        est = slam.T_world_robot.copy()
        n_kf = slam.get_graph().n_vertices
    err = np.linalg.norm(est[:3, 3] - truth[-1][:3, 3])
    assert err < 0.25, f"final pose error {err}"
    assert n_kf >= 2


def test_mt_clean_shutdown_without_run():
    slam = PoseGraphSlamMT(fleet_config(), device="cpu")
    slam.stop()
    replays.PoseGraphSlam(fleet_config(), device="cpu")


def test_mt_facade_base_accessors(tmp_path):
    rng = np.random.default_rng(2)
    scans, odom, _ = corridor_sequence(rng, n_scans=4, scan_points=256,
                                       length=20.0)
    with PoseGraphSlamMT(fleet_config(sensor_cap=384, kf_cap=256),
                         device="cpu") as slam:
        for t, (s, T) in enumerate(zip(scans, odom)):
            slam.add_data(t, "world", T, np.eye(4), s)
        slam.flush()
        pose = slam.T_world_robot
        assert pose.shape == (4, 4) and np.isfinite(pose).all()
        cloud, ok = slam.get_local_map()
        assert ok and cloud is not None
        assert slam.get_local_map_in_world_frame()[1]
        assert len(slam.trajectory()) == slam.get_graph().n_vertices >= 1
        assert slam.n_loop_edges() == 0
        slam.write_graphviz(str(tmp_path / "g.dot"))
        assert (tmp_path / "g.dot").read_text().startswith("graph G {")


def test_mt_flush_commits_lagged_scans():
    """At sync_lag 2 the flush runs on the localizer's worker and leaves
    nothing in flight."""
    rng = np.random.default_rng(2)
    scans, odom, _ = corridor_sequence(rng, n_scans=5, scan_points=256,
                                       length=20.0)
    cfg = replays.with_overrides(fleet_config(sensor_cap=384, kf_cap=256),
                                 sync_lag=2)
    with PoseGraphSlamMT(cfg, device="cpu") as slam:
        for t, (s, T) in enumerate(zip(scans, odom)):
            slam.add_data(t, "world", T, np.eye(4), s)
        assert slam.wait_idle(timeout=120.0)
        assert len(slam.localizer._inflight) == 2
        slam.flush()
        assert len(slam.localizer._inflight) == 0
        assert slam.localizer.count == 5


def test_writeback_keeps_a_vertex_appended_mid_solve(rng):
    """The writeback covers the vertices the problem held: a vertex the
    localizer appends while the solve runs keeps its pose."""
    mm = _chain(MapManager(), rng, 4)
    opt = Optimizer(mm, device="cpu")
    opt.data_buffer = [(0, 3, _T_at(3.0),
                        (np.eye(6) * 0.01).astype(np.float32))]
    opt.prepare_for_optimization()
    v = mm.graph.add_vertex(make_cloud(np.zeros((8, 3), np.float32)),
                            _T_at(9.0), mm.now())
    padded = np.tile(np.eye(4, dtype=np.float32), (64, 1, 1))
    opt.update_after_optimization(padded)
    np.testing.assert_array_equal(mm.graph.optimized_poses[v], _T_at(9.0))
    np.testing.assert_array_equal(mm.graph.optimized_poses[:4],
                                  padded[:4])


def test_worker_failure_is_raised_by_wait_idle_and_stop():
    slam = PoseGraphSlamMT(fleet_config(), device="cpu")
    slam.run()
    try:
        # A cloud of the wrong width fails inside the localizer's worker.
        bad = make_cloud(np.zeros((8, 3), np.float32))
        bad = bad.replace(points=bad.points[:, :2])
        slam.add_data(0, "world", np.eye(4), np.eye(4), bad)
        with pytest.raises(WorkerError, match="LocalizerMT"):
            slam.wait_idle(timeout=60.0)
    finally:
        with pytest.raises(WorkerError):
            slam.stop()


def test_launch_counts_are_exact_under_threads():
    """count_launch under 8 threads switching every microsecond: no
    update is lost."""
    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.shapes = collections.Counter()
    n_threads, n_calls = 8, 2000

    def hammer():
        for i in range(n_calls):
            _build.count_launch(wrapper, shapes=i % 3)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * n_calls
    assert sum(wrapper.shapes.values()) == n_threads * n_calls
