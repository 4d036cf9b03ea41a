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
from pgslam_tpu_torch.optim.lm import lm_optimize
from pgslam_tpu_torch.optim.pgo import PGOConfig, lm_optimize_plain

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


@pytest.mark.parametrize("error", ["point_to_plane", "point_to_point"])
def test_k2_matches_plain(cuda, error):
    cfg, rd, rf = _icp_pair(cuda, error)
    T0 = torch.eye(4, device=cuda).expand(3, 4, 4).contiguous()
    before = fused_icp_register.launches
    res = fused_icp_register(rd, rf, T0, cfg)
    rows = fused_icp_register_plain(rd, rf, T0, cfg)
    torch.cuda.synchronize()
    assert fused_icp_register.launches == before + 1
    assert float((res.T - rows[:, :16].reshape(3, 4, 4)).abs().max()) < 1e-4
    assert torch.equal(res.iterations, rows[:, 16].to(torch.int32))
    torch.testing.assert_close(res.overlap, rows[:, 18], atol=1e-4, rtol=0)
    torch.testing.assert_close(res.residual, rows[:, 19], atol=0, rtol=1e-4)
    cov = rows[:, 20:56].reshape(3, 6, 6)
    assert float((res.cov - cov).abs().max()) \
        <= 1e-3 * float(cov.abs().max())


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
