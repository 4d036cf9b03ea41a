"""The port's streaming path (``micro_batch=4``) against ``pgslam_tpu``
on the golden loop, both on the CPU, and against the JAX package's own
streaming envelope (``tests/test_golden_replay.py:232-266``)."""

import dataclasses

import numpy as np
import pytest

from golden_replay import _replay, golden_config, golden_sequence
from pgslam_tpu_torch import replays
from torch_threads import one_torch_thread  # noqa: F401

GAP_TOL_M = 0.10          # the envelope pgslam_tpu allows its non-ST paths
FIXTURE_ATOL = 1e-5       # tests/test_golden_replay.py's fixture pin


@pytest.fixture(scope="module")
def port_run():
    return replays.run_replay("loop_stream4", device="cpu")


def test_stream4_matches_pgslam_tpu(port_run):
    """Equal keyframe and loop counts and every scan within 0.10 m; the
    JAX run is also the committed fixture chip_smoke.py prints its gap
    to."""
    cfg = golden_config()
    cfg = dataclasses.replace(cfg, localizer=dataclasses.replace(
        cfg.localizer, micro_batch=4))
    j_scan, _, j_stats = _replay(golden_sequence(), cfg)
    p_scan, p_traj, p_stats = port_run
    assert p_stats["n_keyframes"] == j_stats["n_keyframes"] == len(p_traj)
    assert p_stats["n_loops"] == j_stats["n_loops"] >= 1
    gap = replays.max_pose_gap(p_scan, j_scan)
    assert gap <= GAP_TOL_M, f"per-scan gap to pgslam_tpu {gap} m"
    np.testing.assert_allclose(
        j_scan, replays.fixture("loop_stream4")["per_scan_poses"],
        atol=FIXTURE_ATOL)


def test_stream4_in_the_jax_envelope(port_run):
    """Decisions quantize to batch boundaries and the reported pose
    trails by 1-4 scans, so each scan is held to the nearest truth pose
    in its trailing window: below max(0.5, 2.5x) the golden fixture's own
    error, and the flushed final pose within 0.15 m of truth."""
    per_scan, _, stats = port_run
    _, _, truth = replays.loop_sequence_golden()
    t = np.stack(truth)
    gold = replays.fixture("loop")["per_scan_poses"]
    assert stats["n_loops"] >= 1
    assert np.linalg.norm(per_scan[-1][:3, 3] - t[-1][:3, 3]) < 0.15
    gold_te = np.linalg.norm(gold[:, :3, 3] - t[:, :3, 3], axis=1).max()
    te = max(np.linalg.norm(per_scan[i][:3, 3] - t[max(0, i - 4):i + 1, :3, 3],
                            axis=1).min() for i in range(len(per_scan) - 1))
    assert te < max(0.5, 2.5 * gold_te), f"truth error {te} ({gold_te})"
