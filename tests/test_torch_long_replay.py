"""The long replay as a whole on the CPU: the 300-scan clover (three
closures, eleven composition swaps, three optimizes) through the port's
PoseGraphSlam, against the JAX package's single-threaded run
(tests/fixtures/golden_replay_long.npz, tests/golden_replay.py)."""

import os

import numpy as np

from pgslam_tpu_torch import replays
from pgslam_tpu_torch.eval import ate_rmse
from torch_threads import one_torch_thread  # noqa: F401

POSE_TOL_M = 0.10   # the replays' parity limit (tests/test_golden_replay.py)
# The fixture decides at knife edges: at scan 90 a keyframe spawns at an
# overlap of 409 inliers of 512 against a threshold of 409.6
# (golden_replay_long_eval.npz). Every scan up to the run's first
# local-map composition that differs from the JAX run's is held to
# POSE_TOL_M. A CPU run keeps the JAX run's compositions up to scan 221;
# from scan 157 its poses drift from the fixture's (0.21533 m at scan 271,
# nearer the truth) until the third closure pulls both back. Over the
# whole run it is held to pgslam_tpu's own limits for its paths that are
# not bit-identical to its single-threaded run over the long fixture
# (tests/test_golden_replay.py:325-374): each scan within 0.30 m at +-1
# scan (the threaded facade), each scan's error to the truth below
# max(0.8, 1.5 x) the fixture's (the deferred path), the final pose
# within 0.10 m.
LONG_WINDOW_TOL_M = 0.30
LONG_TRUTH_FLOOR_M, LONG_TRUTH_FACTOR = 0.8, 1.5
LONG_ATE_SLACK_M = 0.05


def test_long_replay_matches_the_jax_fixture():
    """The 300-scan clover: 50 keyframes, 3 closures, 11 swaps and 3
    optimizes as in golden_replay_long.npz, the JAX run's decisions past
    scan 90 with every scan before the first that differs within
    POSE_TOL_M, pgslam_tpu's own limits for its non-bitwise paths over
    that fixture, and an ATE to the truth no worse than the fixture's
    plus 0.05 m."""
    gold = replays.fixture("long")
    per_scan, trajectory, stats = replays.run_replay("long", device="cpu")
    assert np.isfinite(per_scan).all()
    assert (stats["n_keyframes"], stats["n_loops"], stats["n_swaps"],
            stats["opt_runs"]) == (50, 3, 11, 3) == (
        int(gold["n_keyframes"]), int(gold["n_loop_edges"]),
        int(gold["n_swaps"]), int(gold["opt_runs"]))
    assert len(trajectory) == 50
    golden = gold["per_scan_poses"]
    decisions = np.load(os.path.join(replays.FIXTURES,
                                     "golden_replay_long_eval.npz"))
    jax_comps = [tuple(c[c >= 0]) for c in decisions["compositions"]]
    shared = next((i for i, (a, b) in enumerate(zip(
        stats["compositions"], jax_comps)) if a != b), len(per_scan))
    assert shared >= 91     # past the knife edge at scan 90
    assert replays.max_pose_gap(per_scan[:shared], golden[:shared]) \
        <= POSE_TOL_M
    assert replays.max_pose_gap(per_scan, golden, window=1) \
        < LONG_WINDOW_TOL_M
    assert np.linalg.norm(per_scan[-1][:3, 3] - golden[-1][:3, 3]) \
        < POSE_TOL_M
    truth = np.stack(replays.long_sequence()[2])
    err = np.linalg.norm(per_scan[:, :3, 3] - truth[:, :3, 3], axis=1)
    gold_err = np.linalg.norm(golden[:, :3, 3] - truth[:, :3, 3], axis=1)
    assert err.max() < max(LONG_TRUTH_FLOOR_M,
                           LONG_TRUTH_FACTOR * gold_err.max())
    assert ate_rmse(per_scan, truth) <= ate_rmse(golden, truth) \
        + LONG_ATE_SLACK_M
