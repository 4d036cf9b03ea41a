"""The YAML entry point as a whole on the CPU: examples/slam_config.yaml
through the port's PoseGraphSlam over the 2048-point clover, against the
JAX package's run (tests/fixtures/golden_replay_yaml.npz, recorded by
scripts/make_torch_fixtures.py)."""

import numpy as np

from pgslam_tpu_torch import replays
from torch_threads import one_torch_thread  # noqa: F401

POSE_TOL_M = 0.10   # the replays' parity limit (tests/test_golden_replay.py)


def test_yaml_clover_matches_the_jax_run():
    """examples/slam_config.yaml over the 2048-point clover: the first
    closure (scan 95) and its optimize, equal keyframe, loop, swap and
    optimizer counts, every scan within 0.10 m of the JAX package's run."""
    gold = replays.fixture("yaml_clover")
    per_scan, trajectory, stats = replays.run_replay("yaml_clover",
                                                     device="cpu")
    assert len(per_scan) == len(gold["per_scan_poses"]) \
        == replays.YAML_CLOVER_SCANS
    assert np.isfinite(per_scan).all()
    assert replays.max_pose_gap(per_scan, gold["per_scan_poses"]) \
        < POSE_TOL_M
    assert stats["n_keyframes"] == int(gold["n_keyframes"]) \
        == len(trajectory)
    assert stats["n_loops"] == int(gold["n_loop_edges"]) >= 1
    assert stats["opt_runs"] == int(gold["opt_runs"]) >= 1
    assert stats["n_swaps"] == int(gold["n_swaps"])
