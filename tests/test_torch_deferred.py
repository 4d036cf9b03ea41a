"""The port's deferred and streaming scan paths against its own classic
path on the golden loop, bit for bit where nothing is stale, and the one
packed result that every scan and verification fetches."""

import dataclasses

import numpy as np
import pytest
import torch

from pgslam_tpu_torch import replays
from pgslam_tpu_torch.ops.icp import (HostFetch, ICPResult, pack_result,
                                      unpack_result)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def classic():
    return replays.run_replay("loop", device="cpu")


def _counts(stats):
    return {k: v for k, v in stats.items() if "seconds" not in k}


@pytest.mark.parametrize("overrides", [{"force_deferred": True},
                                       {"micro_batch": 1}],
                         ids=["force_deferred_lag0", "micro_batch_1"])
def test_bitwise_equal_to_classic(classic, overrides):
    """With nothing in flight a deferred dispatch takes the classic guess
    and probe pose and a fresh commit the classic pose composition, so
    ``force_deferred`` at lag 0 gives the classic replay's bits (tolerance
    zero), per scan, in the trajectory and in every count; micro_batch 1
    is the classic path."""
    per_scan, trajectory, stats = replays.run_replay("loop", device="cpu",
                                                     **overrides)
    np.testing.assert_array_equal(per_scan, classic[0])
    np.testing.assert_array_equal(trajectory, classic[1])
    assert _counts(stats) == _counts(classic[2])
    assert stats["n_loops"] == 1 and stats["n_keyframes"] == 20


def _result(lead=()):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn((*lead, *s), generator=g)
    return ICPResult(T=r(4, 4), iterations=torch.full(lead, 7,
                                                      dtype=torch.int32),
                     converged=torch.ones(lead, dtype=torch.bool),
                     max_iter_reached=torch.zeros(lead, dtype=torch.bool),
                     overlap=r(), residual=r(), cov=r(6, 6),
                     diverged=torch.zeros(lead, dtype=torch.bool))


def test_pack_unpack_round_trip_is_to_host():
    """A result packed, fetched through ``HostFetch`` and unpacked has
    the bits of each field's own host copy (the one road of a result to
    the host, in place of a copy a field)."""
    res = _result()
    got, extra = unpack_result(HostFetch(pack_result(res, 0.25)).get())
    for f in ("T", "cov", "overlap", "residual", "iterations", "converged",
              "max_iter_reached", "diverged"):
        np.testing.assert_array_equal(getattr(got, f),
                                      getattr(res, f).cpu().numpy())
    assert extra == 0.25
    res.diverged = None
    got, extra = unpack_result(pack_result(res).numpy())
    assert got.diverged is None and extra is None


def test_pack_keeps_the_batch_axis():
    res = _result((3,))
    packed = pack_result(res)
    assert packed.shape == (3, 59)
    for b in range(3):
        got, _ = unpack_result(packed[b].numpy())
        np.testing.assert_array_equal(got.T, res.T[b].cpu().numpy())


def test_streaming_flush_pads_a_partial_batch():
    """Seven scans at micro_batch 4: one full batch, then three scans
    that only flush() registers (a batch padded with its last scan);
    every scan ends committed and the pose is the classic one within
    the streaming envelope of 0.15 m."""
    cfg = replays.loop_config()
    cfg = dataclasses.replace(cfg, localizer=dataclasses.replace(
        cfg.localizer, micro_batch=4))
    scans, odom, _ = replays.loop_sequence_golden()
    slam = replays.PoseGraphSlam(cfg, device="cpu")
    T_rs = np.eye(4, dtype=np.float32)
    for i in range(8):
        slam.add_data(i, "world", odom[i], T_rs, scans[i])
    loc = slam.localizer
    assert len(loc._microbuf) == 3 and not loc._inflight
    T = slam.T_world_robot          # the accessor flushes
    assert not loc._microbuf and not loc._inflight
    assert loc.count == 8
    gold = replays.fixture("loop")["per_scan_poses"]
    assert np.linalg.norm(T[:3, 3] - gold[7][:3, 3]) < 0.15
