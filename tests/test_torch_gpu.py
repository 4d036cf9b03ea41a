"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the slice on the card. Every test here needs an NVIDIA GPU and
skips without one; the file imports torch and the port only, so it runs
where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from pgslam_tpu_torch import se3
from pgslam_tpu_torch.cloud import make_cloud, stack_clouds
from pgslam_tpu_torch.ops import filters as F
from pgslam_tpu_torch.ops import outlier as O
from pgslam_tpu_torch.ops.icp import ICPConfig
from pgslam_tpu_torch.ops.icp_fused import (fused_icp_register,
                                            fused_icp_register_plain)
from pgslam_tpu_torch.ops.knn import knn, knn_plain
from pgslam_tpu_torch.optim import pgo
from pgslam_tpu_torch.optim.lm import lm_optimize
from pgslam_tpu_torch.optim.pcg import pcg_solve
from pgslam_tpu_torch.optim.pgo import PGOConfig, lm_optimize_plain
from pgslam_tpu_torch.pgo_problems import bucketed_problem, pose_graph_problem

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels are CUDA")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [1, 8])
def test_k1_matches_plain(cuda, k):
    rng = np.random.default_rng(7)
    q = torch.as_tensor(rng.uniform(-40, 40, (3000, 3)), dtype=torch.float32,
                        device=cuda)
    r = torch.as_tensor(rng.uniform(-40, 40, (5000, 3)), dtype=torch.float32,
                        device=cuda)
    qm = torch.ones(3000, dtype=torch.bool, device=cuda)
    qm[1] = False
    rm = torch.ones(5000, dtype=torch.bool, device=cuda)
    rm[4500:] = False
    before = knn.launches
    mk = knn(q, qm, r, rm, k=k)
    mp = knn_plain(q, qm, r, rm, k=k)
    torch.cuda.synchronize()
    assert knn.launches == before + 1
    assert torch.equal(mk.ids, mp.ids)
    fin = torch.isfinite(mp.dists2)
    assert torch.equal(fin, torch.isfinite(mk.dists2))
    assert float((mk.dists2[fin] - mp.dists2[fin]).abs().max()) < 1e-3


def test_k1_rejects_non_contiguous(cuda):
    q = torch.zeros((16, 3), device=cuda)[::2]
    m = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        knn(q, m, q, m)


def _icp_pair(cuda, error):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (420, 3)).astype(np.float32)
    pts[:, 2] = np.sign(pts[:, 2]) * 2 + rng.normal(size=420) * 0.1
    off = se3.exp(torch.tensor([0.2, -0.1, 0.05, 0.02, -0.03, 0.04])).numpy()
    moved = ((pts - off[:3, 3]) @ off[:3, :3]
             + rng.normal(size=pts.shape) * 0.01).astype(np.float32)
    cfg = ICPConfig(error=error, outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)),
                    max_iterations=12, coarse_div=4, coarse_iterations=4)
    ref = make_cloud(pts, capacity=512, device=cuda)
    if error == "point_to_plane":
        ref = F.compute_normals(ref)
    reading = make_cloud(moved, capacity=512, device=cuda)
    return cfg, stack_clouds([reading] * 3), stack_clouds([ref] * 3)


def _assert_k2_matches_plain(res, rows):
    """Phase k2's limits, per entry."""
    B = rows.shape[0]
    assert float((res.T - rows[:, :16].reshape(B, 4, 4)).abs().max()) < 1e-4
    assert torch.equal(res.iterations, rows[:, 16].to(torch.int32))
    assert torch.equal(res.converged, rows[:, 17] > 0.5)
    torch.testing.assert_close(res.overlap, rows[:, 18], atol=1e-4, rtol=0)
    torch.testing.assert_close(res.residual, rows[:, 19], atol=0, rtol=1e-4)
    cov = rows[:, 20:56].reshape(B, 6, 6)
    scale = cov.abs().amax(dim=(1, 2), keepdim=True)
    assert bool(((res.cov - cov).abs() <= 1e-3 * scale).all())


@pytest.mark.parametrize("error", ["point_to_plane", "point_to_point"])
def test_k2_matches_plain(cuda, error):
    cfg, rd, rf = _icp_pair(cuda, error)
    T0 = torch.eye(4, device=cuda).expand(3, 4, 4).contiguous()
    before = fused_icp_register.launches
    res = fused_icp_register(rd, rf, T0, cfg)
    rows = fused_icp_register_plain(rd, rf, T0, cfg)
    torch.cuda.synchronize()
    assert fused_icp_register.launches == before + 1
    _assert_k2_matches_plain(res, rows)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_k2_anderson_matches_plain(cuda, m):
    """The AA stage in K2 against the plain version's _stage_aa, which
    solves the window's system in the same closed form."""
    import dataclasses
    cfg, rd, rf = _icp_pair(cuda, "point_to_plane")
    cfg = dataclasses.replace(cfg, anderson_m=m, trans_eps=1e-4,
                              rot_eps=1e-4)
    T0 = torch.eye(4, device=cuda).expand(3, 4, 4).contiguous()
    res = fused_icp_register(rd, rf, T0, cfg)
    rows = fused_icp_register_plain(rd, rf, T0, cfg)
    _assert_k2_matches_plain(res, rows)


def _box_problems(cuda, n_distinct, seed=0):
    """Distinct registrations: points on the faces of a box, each moved by
    its own odometry-sized offset (bench.py's twist scales)."""
    rng = np.random.default_rng(seed)
    half = np.array([4.0, 3.0, 2.0])
    rds, rfs = [], []
    for _ in range(n_distinct):
        pts = rng.uniform(-1, 1, (600, 3)) * half
        face = rng.integers(0, 6, 600)
        axis = face % 3
        pts[np.arange(600), axis] = (np.where(face < 3, 1.0, -1.0)
                                     * half[axis]
                                     + rng.normal(size=600) * 0.02)
        off = se3.exp(torch.as_tensor(
            rng.normal(size=6) * [0.15, 0.15, 0.03, 0.005, 0.005, 0.02],
            dtype=torch.float32)).numpy()
        moved = ((pts - off[:3, 3]) @ off[:3, :3]
                 + rng.normal(size=pts.shape) * 0.01).astype(np.float32)
        rfs.append(F.compute_normals(make_cloud(pts.astype(np.float32),
                                                capacity=640, device=cuda)))
        rds.append(make_cloud(moved, capacity=640, device=cuda))
    return rds, rfs


def test_k2_batch_entries_are_independent(cuda):
    """B = 16 (the fleet's batch): 12 distinct problems and 4 duplicates.
    Each entry gives the bits of its own B = 1 launch, duplicates equal
    their originals, and every entry holds phase k2's limits against the
    plain version."""
    rds, rfs = _box_problems(cuda, 12)
    rds, rfs = rds + rds[:4], rfs + rfs[:4]
    cfg = ICPConfig(outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)),
                    max_iterations=12, coarse_div=4, coarse_iterations=4)
    rd, rf = stack_clouds(rds), stack_clouds(rfs)
    T0 = torch.eye(4, device=cuda).expand(16, 4, 4).contiguous()
    before = fused_icp_register.batch_sizes[16]
    res = fused_icp_register(rd, rf, T0, cfg)
    assert fused_icp_register.batch_sizes[16] == before + 1
    fields = ("T", "iterations", "converged", "overlap", "residual", "cov")
    for b in range(16):
        one = fused_icp_register(stack_clouds([rds[b]]),
                                 stack_clouds([rfs[b]]), T0[:1], cfg)
        for f in fields:
            assert torch.equal(getattr(res, f)[b], getattr(one, f)[0]), (b, f)
    for b in range(4):
        for f in fields:
            assert torch.equal(getattr(res, f)[b], getattr(res, f)[12 + b])
    _assert_k2_matches_plain(res, fused_icp_register_plain(rd, rf, T0, cfg))


def test_batched_register_routes_to_k2_on_the_card(cuda):
    from pgslam_tpu_torch.parallel.batched import batched_register
    rds, rfs = _box_problems(cuda, 3)
    rd, rf = stack_clouds(rds), stack_clouds(rfs)
    T0 = torch.eye(4, device=cuda).expand(3, 4, 4).contiguous()
    cfg = ICPConfig(outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)),
                    max_iterations=12)
    before = fused_icp_register.launches
    fused = batched_register(rd, rf, T0, cfg)
    assert fused_icp_register.launches == before + 1
    plain = batched_register(rd, rf, T0, cfg, fused="off")
    assert fused_icp_register.launches == before + 1
    # K2 and icp_core differ by design (tie averaging, closed-form step)
    assert float((fused.T - plain.T).abs().max()) < 1e-3


def test_fleet_on_the_card(cuda):
    """tests/test_multi_agent.py::test_two_agents_share_graph's scene on
    the card: the fleet registers through K2 at its batch size."""
    from pgslam_tpu_torch.datasets import corridor_sequence
    from pgslam_tpu_torch.fleet_problems import fleet_config
    from pgslam_tpu_torch.parallel.multi_agent import MultiAgentSlam
    scans, odom, truth = corridor_sequence(
        np.random.default_rng(7), n_scans=12, scan_points=512, step=0.4,
        noise=0.003, odom_noise=0.005, length=30.0)
    fleet = MultiAgentSlam(fleet_config(), n_agents=2)
    before = fused_icp_register.batch_sizes[2]
    T_rs = np.eye(4, dtype=np.float32)
    for i in range(10):
        fleet.add_data_batch(i, "world", np.stack([odom[i], odom[i + 1]]),
                             T_rs, [scans[i], scans[i + 1]])
    assert fused_icp_register.batch_sizes[2] > before
    for b, i in ((0, 9), (1, 10)):
        assert np.linalg.norm(fleet.poses()[b][:3, 3]
                              - truth[i][:3, 3]) < 0.25
    assert fleet.get_graph().n_vertices >= 3


def _ring(cuda, V=40, seed=1):
    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(V) / V
    R = se3.exp_so3(torch.as_tensor(np.stack([0 * a, 0 * a, a], -1),
                                    dtype=torch.float32))
    t = torch.as_tensor(np.stack([10 * np.cos(a), 10 * np.sin(a), 0 * a], -1),
                        dtype=torch.float32)
    poses = se3.make(R, t)
    ef = np.concatenate([np.arange(V - 1), rng.integers(0, V, 33)])
    et = np.concatenate([np.arange(1, V), rng.integers(0, V, 33)])
    et[ef == et] = (et[ef == et] + 1) % V
    Ts = se3.inverse(poses[ef]) @ poses[et]
    init = poses.clone()
    init[1:] = init[1:] @ se3.exp(torch.as_tensor(
        rng.normal(size=(V - 1, 6)) * 0.05, dtype=torch.float32))
    E = len(ef)
    args = (init, torch.ones(V, dtype=torch.bool),
            torch.as_tensor(ef, dtype=torch.int32),
            torch.as_tensor(et, dtype=torch.int32), Ts,
            torch.eye(6).repeat(E, 1, 1) * 0.01,
            torch.ones(E, dtype=torch.bool))
    return tuple(x.to(cuda) for x in args) + (0,)


@pytest.mark.parametrize("robust", ["none", "huber"])
def test_k3_matches_plain(cuda, robust):
    args = _ring(cuda)
    rmask = torch.zeros(args[2].shape[0], dtype=torch.bool, device=cuda)
    rmask[39:] = True
    cfg = PGOConfig(max_iterations=4, cg_iterations=16, cg_tol=1e-3,
                    robust=robust)
    rm = None if robust == "none" else rmask
    before = lm_optimize.launches
    pk, sk = lm_optimize(*args, rm, config=cfg)
    pp, sp = lm_optimize_plain(*args, rm, config=cfg)
    torch.cuda.synchronize()
    assert lm_optimize.launches == before + 1
    assert float((pk[:, :3, 3] - pp[:, :3, 3]).norm(dim=1).max()) < 1e-4
    assert float((pk[:, :3, :3] - pp[:, :3, :3]).abs().max()) < 1e-4
    assert int(sk["iterations"]) == int(sp["iterations"])
    for key in ("initial_cost", "final_cost"):
        torch.testing.assert_close(sk[key], sp[key], atol=0, rtol=1e-3)


def _k4_system(cuda, V, n_loop):
    """One LM step's system at the problem's initial poses."""
    args, _ = pose_graph_problem(V, n_loop, device=cuda)
    prob = pgo.LMProblem(*args)
    blocks, b, D = prob.system(args[0])
    P_inv, damp = pgo.block_jacobi(D, torch.tensor(1e-6, device=cuda),
                                   args[1])
    return (blocks, P_inv, damp, b, prob.prior_info, 0, prob.ef, prob.et)


K4_CG = dict(cg_iterations=64, cg_tol=1e-4)


@pytest.mark.parametrize("V,n_loop", [(40, 33), (1024, 1025)])
def test_k4_matches_plain(cuda, V, n_loop):
    sysargs = _k4_system(cuda, V, n_loop)
    before = pcg_solve.launches
    xk, sk = pcg_solve(*sysargs, **K4_CG, return_iterations=True)
    xp, sp = pgo.pcg_solve_plain(*sysargs, **K4_CG, return_iterations=True)
    torch.cuda.synchronize()
    assert pcg_solve.launches == before + 1
    assert int(sk) == sp
    # fp32 CG with another summation order
    assert float((xk - xp).abs().max()) <= 1e-3 * float(xp.abs().max())


def test_k4_repeats_bitwise(cuda):
    sysargs = _k4_system(cuda, 1024, 1025)
    x1 = pcg_solve(*sysargs, **K4_CG)
    x2 = pcg_solve(*sysargs, **K4_CG)
    assert torch.equal(x1, x2)
    assert pcg_solve.grid > 1


def test_k4_rejects_bad_input(cuda):
    blocks, P_inv, damp, b, prior, fixed, ef, et = _k4_system(cuda, 40, 33)
    bad = [((blocks[0].double(),) + blocks[1:], P_inv, b),
           (blocks, P_inv[:-1], b),
           (blocks, P_inv, torch.zeros((6, 40), device=cuda).T)]
    for blk, Pi, bb in bad:
        with pytest.raises(ValueError):
            pcg_solve(blk, Pi, damp, bb, prior, fixed, ef, et, **K4_CG)


def test_padded_edges_left_out_of_csr_exactly(cuda):
    """Padded edges carry zero blocks, so K4 gives the same bits with them
    out of its CSR lists, and K3 (which leaves them out) still agrees with
    its plain version on a padded graph."""
    from pgslam_tpu_torch.optim.lm import edge_csr
    args, _ = bucketed_problem(768, 128, device=cuda)
    V, emask = args[0].shape[0], args[6]
    assert not bool(emask.all())
    prob = pgo.LMProblem(*args)
    blocks, b, D = prob.system(args[0])
    P_inv, damp = pgo.block_jacobi(D, torch.tensor(1e-6, device=cuda),
                                   args[1])
    sysargs = (blocks, P_inv, damp, b, prob.prior_info, 0, prob.ef, prob.et)
    x_all = pcg_solve(*sysargs, **K4_CG, csr=edge_csr(prob.ef, prob.et, V))
    x_valid = pcg_solve(*sysargs, **K4_CG,
                        csr=edge_csr(prob.ef, prob.et, V, emask))
    assert torch.equal(x_all, x_valid)
    cfg = PGOConfig(max_iterations=4, cg_iterations=16, cg_tol=1e-3)
    pk, sk = lm_optimize(*args, config=cfg)
    pp, sp = lm_optimize_plain(*args, config=cfg)
    assert float((pk[:, :3, 3] - pp[:, :3, 3]).norm(dim=1).max()) < 1e-4
    assert int(sk["iterations"]) == int(sp["iterations"])


def test_pcg_routes_to_k4_above_threshold(cuda):
    """The padded shapes of ``pgo_1k`` (V = 1024, E = 2048) stay on K3 and
    those of a 1536-pose run (V = E = 2048) go to the loop with K4."""
    cfg = PGOConfig(max_iterations=2, cg_iterations=16, cg_tol=1e-3)
    for (n, n_loop), kernel in (((1024, 1025), lm_optimize),
                                ((1536, 256), pcg_solve)):
        args, _ = bucketed_problem(n, n_loop, device=cuda)
        V, E = args[0].shape[0], args[2].shape[0]
        assert (V + E <= pgo.K3_MAX_SIZE) == (kernel is lm_optimize)
        before = (lm_optimize.launches, pcg_solve.launches)
        out, stats = pgo.optimize_pose_graph(*args, config=cfg)
        torch.cuda.synchronize()
        after = (lm_optimize.launches, pcg_solve.launches)
        ran = [a > b for a, b in zip(after, before)]
        assert ran == [kernel is lm_optimize, kernel is pcg_solve]
        assert torch.isfinite(out).all()
        assert float(stats["final_cost"]) < float(stats["initial_cost"])


def test_loop_replay_launches_every_kernel(cuda):
    from pgslam_tpu_torch import replays
    before = (knn.launches, fused_icp_register.launches,
              lm_optimize.launches)
    per_scan, trajectory, stats = replays.run_replay("loop", device=cuda)
    gold = replays.fixture("loop")["per_scan_poses"]
    assert replays.max_pose_gap(per_scan, gold) < 0.10
    assert stats["n_keyframes"] == 20 and stats["n_loops"] == 1
    after = (knn.launches, fused_icp_register.launches,
             lm_optimize.launches)
    assert all(a > b for a, b in zip(after, before))
