"""The fleet of one on the golden loop through K2's semantics, in both
packages: the JAX package's ``MultiAgentSlam`` with its fused route
forced (``PGSLAM_FUSED_BATCHED=1``: registration and verification run
the Pallas kernel, in interpret mode on the CPU) against the port's
``MultiAgentSlam(fused="on")`` (K2's plain version on the CPU), both with
synchronous closures as ``tests/test_golden_replay.py`` runs its batched
path.

The two routes give the same poses through scan 25 and stay within 0.4
mm through scan 45; the sequence carries last bits far after that, so
later scans are not compared. Both gaps to ``golden_replay.npz`` are
printed: the reference's own fused route ends about 0.104 m from the
fixture, past the 0.10 m envelope of its ``icp_core`` paths, so the
port's K2 route sitting near 0.10 m on the card is the reference's
behaviour."""

import numpy as np

from golden_replay import N_SCANS, golden_config, golden_sequence
from pgslam_tpu.graph.pose_graph import LOOP_CONSTRAINT as J_LOOP
from pgslam_tpu.parallel.multi_agent import MultiAgentSlam as JFleet
from pgslam_tpu_torch import replays
from pgslam_tpu_torch.graph.pose_graph import LOOP_CONSTRAINT
from pgslam_tpu_torch.parallel.multi_agent import MultiAgentSlam

# Per-scan translation gap allowed between the two fused routes over the
# scans they track closely (measured: 0 through scan 25, at most 3.8e-4 m
# through scan 45).
TRACKED_SCANS = 46
ROUTE_GAP_TOL_M = 1e-3


def _sync_closures(fleet):
    fleet.loop_closer.queue_mode = False
    fleet.localizers[0].defer_graph_resync = False


def _drive(fleet, scans, odom):
    T_rs = np.eye(4, dtype=np.float32)
    per_scan = []
    for i in range(N_SCANS):
        fleet.add_data_batch(i, "world", odom[i][None], T_rs, [scans[i]])
        per_scan.append(np.asarray(fleet.poses())[0].copy())
    g = fleet.get_graph()
    return np.stack(per_scan), g


def test_fleet_of_one_fused_route_matches_jax_fused_route(monkeypatch):
    monkeypatch.setenv("PGSLAM_FUSED_BATCHED", "1")
    scans, odom, _ = golden_sequence()
    jf = JFleet(golden_config(), n_agents=1)
    _sync_closures(jf)
    j_per_scan, jg = _drive(jf, scans, odom)

    t_scans, t_odom, _ = replays.loop_sequence_golden()
    np.testing.assert_array_equal(np.stack(t_scans), np.stack(scans))
    tf = MultiAgentSlam(replays.loop_config(), n_agents=1, device="cpu",
                        fused="on")
    _sync_closures(tf)
    t_per_scan, tg = _drive(tf, t_scans, t_odom)

    j_loops = int(np.sum(np.asarray(jg.edge_type[:jg.n_edges]) == J_LOOP))
    t_loops = int(np.sum(tg.edge_type[:tg.n_edges] == LOOP_CONSTRAINT))
    assert t_loops == j_loops
    assert tg.n_vertices == jg.n_vertices
    gap = np.linalg.norm(t_per_scan[:, :3, 3] - j_per_scan[:, :3, 3],
                         axis=1)
    assert np.isfinite(gap).all()
    assert gap[:TRACKED_SCANS].max() <= ROUTE_GAP_TOL_M, \
        gap[:TRACKED_SCANS]
    gold = replays.fixture("loop")["per_scan_poses"]
    j_gap = replays.max_pose_gap(j_per_scan, gold, window=1)
    t_gap = replays.max_pose_gap(t_per_scan, gold, window=1)
    print(f"fused routes to golden_replay.npz: JAX {j_gap:.5f} m, port "
          f"{t_gap:.5f} m; route gap through scan {TRACKED_SCANS - 1} "
          f"{gap[:TRACKED_SCANS].max():.2e} m")
