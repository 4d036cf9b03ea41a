"""The port's deferred paths against ``pgslam_tpu`` on the golden loop:
both packages replay ``sync_lag=2`` with deferred loop-closure
verification on the CPU (the JAX package as its own tests run it), and
the port's deferred verification alone is held to the JAX package's own
envelope for it (``tests/test_golden_replay.py:202-229``)."""

import dataclasses

import numpy as np

from golden_replay import _replay, golden_config, golden_sequence
from pgslam_tpu_torch import replays
from torch_threads import one_torch_thread  # noqa: F401

GAP_TOL_M = 0.10          # the envelope pgslam_tpu allows its non-ST paths
FIXTURE_ATOL = 1e-5       # tests/test_golden_replay.py's fixture pin


def test_lag2_matches_pgslam_tpu():
    """Equal keyframe and loop counts and every scan within 0.10 m (the
    last one the flushed pose in both); the JAX run is also the committed
    fixture the card is held to (chip_smoke.py's replay_loop_lag2)."""
    cfg = golden_config()
    cfg = dataclasses.replace(cfg, loop_closer=dataclasses.replace(
        cfg.loop_closer, deferred_verification=True))
    j_scan, j_traj, j_stats = _replay(golden_sequence(), cfg, sync_lag=2)
    p_scan, p_traj, p_stats = replays.run_replay("loop_lag2", device="cpu")
    assert p_stats["n_keyframes"] == j_stats["n_keyframes"] == len(p_traj)
    assert p_stats["n_loops"] == j_stats["n_loops"] >= 1
    gap = replays.max_pose_gap(p_scan, j_scan)
    assert gap <= GAP_TOL_M, f"per-scan gap to pgslam_tpu {gap} m"
    fix = replays.fixture("loop_lag2")
    np.testing.assert_allclose(j_scan, fix["per_scan_poses"],
                               atol=FIXTURE_ATOL)
    assert int(fix["n_keyframes"]) == j_stats["n_keyframes"]


def _truth_errs(per_scan, truth):
    return np.linalg.norm(per_scan[:, :3, 3] - np.stack(truth)[:, :3, 3],
                          axis=1)


def test_deferred_verification_in_the_jax_envelope():
    """Deferred verification alone: the closure lands one scan later, so
    the pins are the JAX package's: the loop count, the final pose within
    0.10 m of the golden fixture, and the error to truth within
    max(0.30, 1.5x) the fixture's own."""
    _, _, truth = replays.loop_sequence_golden()
    gold = replays.fixture("loop")
    per_scan, _, stats = replays.run_replay("loop", device="cpu",
                                            deferred_verification=True)
    assert stats["n_loops"] == int(gold["n_loop_edges"]) >= 1
    d_final = np.linalg.norm(per_scan[-1][:3, 3]
                             - gold["per_scan_poses"][-1][:3, 3])
    assert d_final < 0.10, f"final pose {d_final} m from the fixture"
    te = _truth_errs(per_scan, truth).max()
    gold_te = _truth_errs(gold["per_scan_poses"], truth).max()
    assert te < max(0.30, 1.5 * gold_te), f"truth error {te} ({gold_te})"
