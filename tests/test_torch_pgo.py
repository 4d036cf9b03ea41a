"""K3 (the whole LM optimize): the port's plain LM against the JAX XLA LM
(and the Pallas kernel in interpret mode, slow tier). The CUDA kernel is
held against the plain LM in tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgslam_tpu import se3 as jse3
from pgslam_tpu.optim import pgo as jpgo
from pgslam_tpu_torch.optim import pgo as tpgo
from pgslam_tpu_torch.optim.lm import edge_csr

POSE_TOL_M = 1e-4


def _ring_problem(V=40, E=72, seed=1, noise=0.05, corrupt=False):
    """tests/test_pgo_pallas.py's ring, as numpy."""
    rng = np.random.default_rng(seed)
    angles = 2 * np.pi * np.arange(V) / V
    R = np.asarray(jse3.exp_so3(jnp.asarray(
        np.stack([np.zeros(V), np.zeros(V), angles], -1), jnp.float32)))
    t = np.stack([10 * np.cos(angles), 10 * np.sin(angles),
                  np.zeros(V)], -1).astype(np.float32)
    poses = np.asarray(jse3.make(jnp.asarray(R), jnp.asarray(t)))
    ef = np.concatenate([np.arange(V - 1), rng.integers(0, V, E - V + 1)])
    et = np.concatenate([np.arange(1, V), rng.integers(0, V, E - V + 1)])
    dup = ef == et
    et[dup] = (et[dup] + 1) % V
    Ts = np.einsum("eij,ejk->eik", np.linalg.inv(poses[ef]),
                   poses[et]).astype(np.float32)
    if corrupt:   # one bad loop edge for the robust kernels to gate
        Ts[50] = Ts[50] @ np.asarray(jse3.exp(jnp.asarray(
            [3.0, 0.0, 0.0, 0.0, 0.0, 0.3], jnp.float32)))
    covs = np.tile((np.eye(6) * 0.01).astype(np.float32), (E, 1, 1))
    init = poses.copy()
    init[1:] = init[1:] @ np.asarray(jax.vmap(jse3.exp)(jnp.asarray(
        rng.normal(size=(V - 1, 6)) * noise, jnp.float32)))
    emask = np.ones(E, bool)
    emask[-5:] = False
    rmask = np.zeros(E, bool)
    rmask[V - 1:] = True
    return (init.astype(np.float32), np.ones(V, bool), ef.astype(np.int32),
            et.astype(np.int32), Ts, covs, emask), rmask


def _jax(args, rmask, cfg_kw, robust):
    cfg = jpgo.PGOConfig(robust=robust, **cfg_kw)
    out, st = jpgo._optimize_xla(
        *[jnp.asarray(a) for a in args], jnp.int32(0),
        robust_emask=None if robust == "none" else jnp.asarray(rmask),
        config=cfg)
    return np.asarray(out), {k: float(v) for k, v in st.items()}


def _port(args, rmask, cfg_kw, robust, device="cpu"):
    cfg = tpgo.PGOConfig(robust=robust, **cfg_kw)
    out, st = tpgo.optimize_pose_graph(
        *[torch.as_tensor(a, device=device) for a in args], 0,
        robust_emask=None if robust == "none"
        else torch.as_tensor(rmask, device=device), config=cfg)
    return out.cpu().numpy(), {k: float(v) for k, v in st.items()}


@pytest.mark.parametrize("robust", ["none", "huber", "cauchy"])
def test_plain_lm_matches_optimize_xla(robust):
    args, rmask = _ring_problem(corrupt=robust != "none")
    kw = dict(max_iterations=4, cg_iterations=16, cg_tol=1e-3)
    pj, sj = _jax(args, rmask, kw, robust)
    pt, st = _port(args, rmask, kw, robust)
    gap = np.linalg.norm(pt[:, :3, 3] - pj[:, :3, 3], axis=1).max()
    assert gap < POSE_TOL_M
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], atol=1e-4)
    assert st["iterations"] == sj["iterations"]
    np.testing.assert_allclose(st["final_cost"], sj["final_cost"],
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(st["initial_cost"], sj["initial_cost"],
                               rtol=1e-5)


def test_block_helpers_match_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(10, 6, 6)).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
    np.testing.assert_allclose(
        tpgo.spd_inverse6(torch.from_numpy(M)).numpy(),
        np.asarray(jpgo.spd_inverse6(jnp.asarray(M))), rtol=1e-4, atol=1e-6)
    e = (rng.normal(size=(10, 6)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(tpgo._jr_inv(torch.from_numpy(e)).numpy(),
                               np.asarray(jpgo._jr_inv(jnp.asarray(e))),
                               atol=1e-6)


def test_anchor_and_padding():
    args, rmask = _ring_problem()
    vmask = args[1].copy()
    vmask[-3:] = False
    args = (args[0], vmask) + args[2:]
    out, st = _port(args, rmask, dict(max_iterations=4, cg_iterations=16,
                                      cg_tol=1e-3), "none")
    np.testing.assert_allclose(out[0], args[0][0], atol=1e-5)
    np.testing.assert_array_equal(out[-3:], args[0][-3:])
    assert st["final_cost"] < st["initial_cost"]


def test_edge_csr_order():
    ef = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    et = torch.tensor([1, 2, 0, 2], dtype=torch.int32)
    ptr, ent = edge_csr(ef, et, 3)
    assert ptr.tolist() == [0, 3, 5, 8]
    # vertex 0: 'from' ends of edges 0, 3, then the 'to' end of edge 2
    assert ent.tolist() == [0, 6, 5, 2, 1, 4, 3, 7]


def test_unported_solvers_raise():
    args, rmask = _ring_problem()
    with pytest.raises(NotImplementedError):
        _port(args, rmask, dict(solver="cholesky"), "none")


@pytest.mark.slow
def test_plain_lm_matches_lm_pallas_interpret():
    args, rmask = _ring_problem(V=12, E=16, noise=0.02)
    kw = dict(max_iterations=2, cg_iterations=8, cg_tol=1e-3)
    out, st = jpgo.optimize_pose_graph(
        *[jnp.asarray(a) for a in args], jnp.int32(0),
        config=jpgo.PGOConfig(solver="lm_pallas", **kw))
    pt, stt = _port(args, rmask, kw, "none")
    # the Pallas kernel's bf16 hi/lo incidence splits set its noise floor
    np.testing.assert_allclose(pt, np.asarray(out), atol=2e-3)
    assert stt["iterations"] == float(st["iterations"])
