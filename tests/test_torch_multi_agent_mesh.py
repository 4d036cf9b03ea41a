"""``MultiAgentSlam(mesh=)`` of the port on a mesh of CPU positions
against the JAX package's fleet on its (dp = 4, tp = 2) mesh of 8
virtual devices (``tests/fixtures/golden_fleet_mesh.npz``, recorded by
``python scripts/make_torch_fixtures.py mesh_fleet``), against the port's
single-device fleet, and the fleet of one on the golden loop over a
dp = 1 x tp = 8 mesh (tests/test_golden_replay.py:95-121)."""

import os

import numpy as np
import pytest
import torch

from pgslam_tpu_torch import fleet_problems as FP
from pgslam_tpu_torch import replays
from pgslam_tpu_torch.parallel.multi_agent import MultiAgentSlam
from pgslam_tpu_torch.parallel.multichip import make_mesh
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "golden_fleet_mesh.npz")
MESH_GAP_M = 0.05      # test_multi_agent.py:108-110: mesh vs plain fleet
TRUTH_M = 0.25         # test_multi_agent.py:106-107
POSE_TOL_M = 0.10      # the golden loop's envelope (test_golden_replay.py)


def _corridor():
    from pgslam_tpu_torch.datasets import corridor_sequence
    return corridor_sequence(np.random.default_rng(7), n_scans=12,
                             scan_points=512, step=0.4, noise=0.003,
                             odom_noise=0.005, length=30.0)


def _drive(fleet, steps, seq):
    """Agent b on scan i + b; each step's poses and vertex count."""
    scans, odom, _ = seq
    B = fleet.n_agents
    poses, nv = [], []
    for i in range(steps):
        fleet.add_data_batch(i, "world", np.stack([odom[i + b]
                                                   for b in range(B)]),
                             np.eye(4, dtype=np.float32),
                             [scans[i + b] for b in range(B)])
        poses.append(fleet.poses().copy())
        nv.append(fleet.get_graph().n_vertices)
    return np.stack(poses), np.array(nv)


def test_mesh_fleet_matches_jax_and_the_single_device_fleet():
    """tests/test_multi_agent.py::test_multi_agent_on_tp_mesh: B = 4, 8
    steps, dp = 4 x tp = 2. Every step's poses within MESH_GAP_M of the
    JAX mesh fleet's and its vertex count equal; the final poses within
    MESH_GAP_M of the port's single-device fleet and TRUTH_M of the
    truth, with equal vertex counts."""
    seq = _corridor()
    gold = np.load(FIXTURE)
    mesh = make_mesh(8, tp=2, devices=["cpu"] * 8)
    fleet = MultiAgentSlam(FP.fleet_config(), n_agents=4, mesh=mesh)
    assert fleet.device == torch.device("cpu")
    poses, nv = _drive(fleet, 8, seq)
    gap = np.linalg.norm(poses[..., :3, 3]
                         - gold["per_step_poses"][..., :3, 3], axis=-1)
    print(f"mesh fleet: max gap to the JAX mesh fleet {gap.max():.3e} m")
    assert gap.max() < MESH_GAP_M, gap.max(axis=1)
    np.testing.assert_array_equal(nv, gold["n_vertices"])

    plain = MultiAgentSlam(FP.fleet_config(), n_agents=4, device="cpu")
    plain_poses, plain_nv = _drive(plain, 8, seq)
    truth = seq[2]
    for b in range(4):
        assert np.linalg.norm(poses[-1, b, :3, 3]
                              - plain_poses[-1, b, :3, 3]) < MESH_GAP_M
        assert np.linalg.norm(poses[-1, b, :3, 3]
                              - truth[7 + b][:3, 3]) < TRUTH_M
    assert nv[-1] == plain_nv[-1]


def test_tp1_mesh_route_bit_equal_to_the_whole_batch():
    """tp = 1: each dp chunk through batched_register on its device, K2's
    plain version under fused="on"; every step's poses bit-equal to the
    unchunked batch's."""
    seq = _corridor()
    mesh = make_mesh(4, tp=1, devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 4, "tp": 1}
    chunked = MultiAgentSlam(FP.fleet_config(), n_agents=4, mesh=mesh,
                             fused="on")
    whole = MultiAgentSlam(FP.fleet_config(), n_agents=4, device="cpu",
                           fused="on")
    a, nva = _drive(chunked, 4, seq)
    b, nvb = _drive(whole, 4, seq)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(nva, nvb)


def test_mesh_fleet_device_is_the_meshs_first():
    mesh = make_mesh(2, tp=2, devices=["cpu"] * 2)
    assert MultiAgentSlam(FP.fleet_config(), n_agents=2, mesh=mesh,
                          device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="differs"):
        MultiAgentSlam(FP.fleet_config(), n_agents=2, mesh=mesh,
                       device=torch.device("cuda", 1))


def test_fleet_of_one_on_a_tp8_mesh_matches_golden_replay():
    """tests/test_golden_replay.py:117-121: the fleet at B = 1 with
    synchronous closures, registering through the sharded loop over 8
    reference shards, within POSE_TOL_M of golden_replay.npz (window 1).
    With one agent a dp group the sharded registration is icp_core's bit
    for bit, so the run equals the single-device fleet of one's (its CPU
    route is icp_core) pose for pose."""
    scans, odom, _ = replays.loop_sequence_golden()

    def run(**kw):
        fleet = MultiAgentSlam(replays.loop_config(), n_agents=1, **kw)
        fleet.loop_closer.queue_mode = False
        fleet.localizers[0].defer_graph_resync = False
        T_rs = np.eye(4, dtype=np.float32)
        per_scan = []
        for i, (scan, T_odom) in enumerate(zip(scans, odom)):
            fleet.add_data_batch(i, "world", T_odom[None], T_rs, [scan])
            per_scan.append(fleet.poses()[0].copy())
        return np.stack(per_scan)

    sharded = run(mesh=make_mesh(8, tp=8, devices=["cpu"] * 8))
    gold = replays.fixture("loop")
    gap = replays.max_pose_gap(sharded, gold["per_scan_poses"], window=1)
    print(f"fleet of one on dp=1 x tp=8: max deviation {gap:.4f} m")
    assert gap < POSE_TOL_M
    np.testing.assert_array_equal(sharded, run(device="cpu", fused="off"))
