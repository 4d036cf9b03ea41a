"""The plain reference agrees with the program's plain path on the CPU,
and its pose-graph judge reads zero at an optimum and more away from it."""

import json
import os

import numpy as np
import pytest
import torch

from slambench.core import slamconfig, traffic
from slambench.core.reference import geometry as G
from slambench.core.reference import icp as RI
from slambench.core.reference import pgo as RP
from slambench.tests.helpers import BENCH_DIR


def _cfg(name):
    with open(os.path.join(BENCH_DIR, "configs", name + ".json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", ["velodyne64", "fleet16"])
def test_icp_matches_the_program_plain_path(name):
    from pgslam_tpu_torch.cloud import make_cloud
    from pgslam_tpu_torch.ops.icp import ICPEngine, icp_core
    cfg = _cfg(name)
    sec = slamconfig.icp_section(cfg, cfg["slam"]["localizer"]["icp"])
    prog_cfg = slamconfig.build(cfg).localizer.icp
    rng = np.random.default_rng(5)
    n = 4096 if name == "velodyne64" else 512
    scans, odom, _ = traffic.corridor_sequence(
        rng, n_scans=2, scan_points=n, step=0.5, odom_noise=0.02)
    T0 = (np.linalg.inv(odom[0]) @ odom[1]).astype(np.float32)
    eng = ICPEngine(prog_cfg)
    eng.set_map(make_cloud(scans[0], device="cpu"))
    prog = icp_core(eng.prepare_reading(make_cloud(scans[1], device="cpu")),
                    eng.reference, torch.as_tensor(T0), prog_cfg)
    ref = RI.register(
        RI.prepare_reading(G.cloud_from_points(scans[1], "cpu"), sec),
        RI.prepare_reference(G.cloud_from_points(scans[0], "cpu"), sec),
        torch.as_tensor(T0), sec)
    assert torch.equal(prog.T, ref.T)
    assert int(prog.iterations) == ref.iterations
    assert float(prog.overlap) == pytest.approx(ref.overlap, abs=1e-6)


def _ring(n=12, seed=0):
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    truth = np.tile(np.eye(4), (n, 1, 1))
    truth[:, 0, 3], truth[:, 1, 3] = 5 * np.cos(ang), 5 * np.sin(ang)
    ef = np.array(list(range(n - 1)) + [0])
    et = np.array(list(range(1, n)) + [n - 1])
    meas = np.stack([np.linalg.inv(truth[a]) @ truth[b]
                     for a, b in zip(ef, et)])
    meas[:, :3, 3] += rng.normal(size=(n, 3)) * 0.05
    init = [truth[0]]
    for k in range(n - 1):
        init.append(init[-1] @ meas[k])
    cov = np.tile(np.eye(6) * 1e-3, (n, 1, 1))
    return (np.stack(init).astype(np.float32), ef, et,
            meas.astype(np.float32), cov.astype(np.float32))


def test_pgo_judge_reads_the_distance_to_the_optimum():
    poses, ef, et, meas, cov = _ring()
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt)
    args = (torch.as_tensor(ef), torch.as_tensor(et), t(meas), t(cov))
    anchor = t(poses[0])
    d, g = RP.gauss_newton_step(t(poses), *args, 0, anchor)
    far, far_s = RP.displacement(d, 15.0).max(), RP.sigma(d, g)
    opt = RP.solve(t(poses), *args, 0, anchor, iterations=8)
    d, g = RP.gauss_newton_step(opt, *args, 0, anchor)
    near, near_s = RP.displacement(d, 15.0).max(), RP.sigma(d, g)
    assert far > 0.02 and near < 1e-9
    assert far_s > 1.0 and near_s < 1e-6


def test_pgo_judge_at_the_program_optimum():
    from pgslam_tpu_torch.optimizer import pad_graph
    from pgslam_tpu_torch.optim.pgo import optimize_pose_graph
    poses, ef, et, meas, cov = _ring()
    arrays = pad_graph(poses, ef, et, meas, cov, 16)
    out, _ = optimize_pose_graph(*(torch.as_tensor(a) for a in arrays), 0)
    prog = out.numpy()[:len(poses)]
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    step, g = RP.gauss_newton_step(t(prog), torch.as_tensor(ef),
                                   torch.as_tensor(et), t(meas), t(cov), 0,
                                   t(poses[0]))
    assert float(RP.displacement(step, 15.0).max()) < 1e-3
    assert RP.sigma(step, g) < 0.1


def _k2_pair(sec, prog_cfg, scans, odom, a, b):
    """The program's plain K2 and the reference's K2 route on one pair:
    (program transform, iterations, overlap, reference result)."""
    from pgslam_tpu_torch.cloud import make_cloud
    from pgslam_tpu_torch.ops.icp import ICPEngine
    from pgslam_tpu_torch.ops.icp_fused import fused_icp_register_plain
    T0 = (np.linalg.inv(odom[a]) @ odom[b]).astype(np.float32)
    eng = ICPEngine(prog_cfg)
    eng.set_map(make_cloud(scans[a], device="cpu"))
    reading = eng.prepare_reading(make_cloud(scans[b], device="cpu"))
    lift = lambda c: c.map(lambda x: x[None])
    row = fused_icp_register_plain(lift(reading), lift(eng.reference),
                                   torch.as_tensor(T0)[None], prog_cfg)[0]
    ref = RI.register(
        RI.prepare_reading(G.cloud_from_points(scans[b], "cpu"), sec),
        RI.prepare_reference(G.cloud_from_points(scans[a], "cpu"), sec),
        torch.as_tensor(T0), sec)
    return row[:16].reshape(4, 4), int(row[16]), float(row[18]), ref


def test_k2_reference_matches_the_program_plain_k2():
    """The K2 route of the reference follows ``fused_icp_register_plain``
    (the plain version of the fleet's kernel): one step agrees to
    rounding on every pair (the reference sums its batched moments in
    another order); whole registrations agree in transform, iterations
    and overlap on most pairs, as the check's per-agent median asks. A
    last-bit difference can send the trimmed match set of a
    registration along the corridor to another converged solution."""
    import dataclasses
    cfg = _cfg("fleet16")
    sec = dict(slamconfig.icp_section(cfg, cfg["slam"]["localizer"]["icp"]),
               route="k2")
    prog_cfg = slamconfig.build(cfg).localizer.icp
    rng = np.random.default_rng(9)
    scans, odom, _ = traffic.corridor_sequence(
        rng, n_scans=4, scan_points=512, step=0.25, odom_noise=0.02)
    pairs = ((0, 1), (1, 2), (2, 3), (0, 2))
    one = dataclasses.replace(prog_cfg, max_iterations=1, smooth_length=1)
    sec1 = dict(sec, max_iterations=1, smooth_length=1)
    for a, b in pairs:
        T, it, _, ref = _k2_pair(sec1, one, scans, odom, a, b)
        assert torch.allclose(T, ref.T, rtol=0, atol=1e-6)
        assert it == ref.iterations == 1
    agree = 0
    for a, b in pairs:
        T, it, ov, ref = _k2_pair(sec, prog_cfg, scans, odom, a, b)
        agree += bool(torch.allclose(T, ref.T, rtol=0, atol=1e-5)
                      and it == ref.iterations
                      and ov == pytest.approx(ref.overlap, abs=1e-6))
    assert agree >= 3


def test_k1_tally_wraps_the_importers():
    from pgslam_tpu_torch.cloud import make_cloud
    from pgslam_tpu_torch.ops import icp as I
    from pgslam_tpu_torch.ops import knn as K

    from slambench.core.tally import K1Tally
    orig = K.knn
    tally = K1Tally("cpu")
    tally.install()
    try:
        assert K.knn is orig and I.knn is not orig
        assert "pgslam_tpu_torch.ops.icp" in tally.modules()
        rng = np.random.default_rng(2)
        q = make_cloud(rng.normal(size=(64, 3)).astype(np.float32),
                       device="cpu")
        r = make_cloud(rng.normal(size=(96, 3)).astype(np.float32),
                       device="cpu")
        I.knn(q.points, q.mask, r.points, r.mask, k=2)
        I.knn(q.points, q.mask, r.points, r.mask)
    finally:
        tally.remove()
    assert I.knn is orig
    n_q, n_r = q.points.shape[0], r.points.shape[0]
    assert tally.shapes == {(n_q, n_r, 2): 1, (n_q, n_r, 1): 1}
