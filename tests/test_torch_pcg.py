"""The large-graph back end on the CPU: K4's plain version against the
JAX package's ``pcg_solve_pallas`` (interpret mode) and XLA PCG, the LM
loop under every solver name against ``pgo._optimize_xla``,
``pose_marginals`` against its JAX counterpart, and the routing. K4
itself is held against its plain version on the card in
tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgslam_tpu.optim import pcg_pallas as jpcg
from pgslam_tpu.optim import pgo as jpgo
from pgslam_tpu_torch.optim import pgo as tpgo
from pgslam_tpu_torch.optim.pcg import pcg_solve

from test_torch_pgo import _jax, _port, _ring_problem

POSE_TOL_M = 1e-4
# The Pallas kernel moves vectors through bf16 hi/lo-split incidence
# matmuls (~2^-16 relative); tests/test_pgo_pallas.py holds it to the XLA
# path at this bound.
PALLAS_ATOL = 2e-3
CG = dict(cg_iterations=16, cg_tol=1e-3)
LM = dict(max_iterations=4, **CG)


def _system():
    """One LM step's linear system at the ring's initial poses, from the
    port's assembly, as numpy: blocks, P_inv, damp_diag, b, and the
    (clamped) edge endpoints."""
    args, _ = _ring_problem()
    t = [torch.as_tensor(a) for a in args]
    prob = tpgo.LMProblem(*t, 0, config=tpgo.PGOConfig(**LM))
    blocks, b, D = prob.system(t[0])
    P_inv, damp = tpgo.block_jacobi(D, torch.tensor(1e-6), t[1])
    arrs = [x.numpy() for x in (*blocks, P_inv, damp, b)]
    return arrs, prob.ef.numpy(), prob.et.numpy(), float(prob.prior_info)


def _plain(arrs, ef, et, prior, **kw):
    t = [torch.as_tensor(a) for a in arrs]
    return tpgo.pcg_solve_plain(tuple(t[:3]), *t[3:], prior, 0,
                                torch.as_tensor(ef), torch.as_tensor(et),
                                **CG, **kw)


def test_pcg_plain_matches_pcg_solve_pallas_interpret():
    arrs, ef, et, prior = _system()
    x = _plain(arrs, ef, et, prior).numpy()
    S = jpcg.build_incidence_bf16(jnp.asarray(ef, jnp.int32),
                                  jnp.asarray(et, jnp.int32), len(arrs[5]))
    xj = np.asarray(jpcg.pcg_solve_pallas(
        S, *[jnp.asarray(a) for a in arrs], jnp.float32(prior), jnp.int32(0),
        n_edges=len(ef), **CG))
    assert np.abs(x).max() > 1e-2      # a real step, not a zero solve
    np.testing.assert_allclose(x, xj, atol=PALLAS_ATOL)


def test_pcg_plain_matches_xla_pcg_step():
    """One LM iteration of the XLA loop is one XLA PCG solve and its
    retraction; the port's solve of the same system, retracted, lands on
    the same poses."""
    from pgslam_tpu_torch import se3
    args, rmask = _ring_problem()
    kw = dict(LM, max_iterations=1, solver="pcg_xla")
    pj, sj = _jax(args, rmask, kw, "none")
    arrs, ef, et, prior = _system()
    x = _plain(arrs, ef, et, prior)
    pt = (torch.as_tensor(args[0]) @ se3.exp(x)).numpy()
    assert sj["final_cost"] < sj["initial_cost"]      # the step was taken
    gap = np.linalg.norm(pt[:, :3, 3] - pj[:, :3, 3], axis=1).max()
    assert gap < POSE_TOL_M
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], atol=1e-4)


def test_k4_wrapper_takes_plain_version_on_cpu():
    arrs, ef, et, prior = _system()
    x, steps = _plain(arrs, ef, et, prior, return_iterations=True)
    t = [torch.as_tensor(a) for a in arrs]
    before = pcg_solve.launches
    xk, sk = pcg_solve(tuple(t[:3]), *t[3:], prior, 0, torch.as_tensor(ef),
                       torch.as_tensor(et), **CG, return_iterations=True)
    assert pcg_solve.launches == before
    assert torch.equal(x, xk) and steps == sk and 0 < steps <= 16
    meta = [a.to("meta") for a in t]
    with pytest.raises(ValueError):
        pcg_solve(tuple(meta[:3]), *meta[3:], prior, 0, torch.as_tensor(ef),
                  torch.as_tensor(et), **CG)


def _compare(args, rmask, solver, atol):
    kw = dict(LM, solver=solver)
    pj, sj = _jax(args, rmask, kw, "none")
    pt, st = _port(args, rmask, kw, "none")
    gap = np.linalg.norm(pt[:, :3, 3] - pj[:, :3, 3], axis=1).max()
    assert gap < atol
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], atol=atol)
    assert st["iterations"] == sj["iterations"]
    np.testing.assert_allclose(st["final_cost"], sj["final_cost"],
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(st["initial_cost"], sj["initial_cost"],
                               rtol=1e-5)
    assert st["final_cost"] < 1e-3 * st["initial_cost"]


def test_loop_pcg_pallas_matches_optimize_xla():
    args, rmask = _ring_problem()
    _compare(args, rmask, "pcg_pallas", PALLAS_ATOL)


@pytest.mark.parametrize("solver", ["pcg_xla", "cholesky", "auto"])
def test_loop_matches_optimize_xla(solver):
    args, rmask = _ring_problem()
    _compare(args, rmask, solver, POSE_TOL_M)


def test_dense_solve_takes_exact_steps():
    """Cholesky steps are exact Newton steps: the dense loop reaches a
    lower cost than 16-step PCG in the same LM iterations."""
    args, rmask = _ring_problem()
    _, sd = _port(args, rmask, dict(LM, solver="cholesky"), "none")
    _, sp = _port(args, rmask, dict(LM, solver="pcg_xla"), "none")
    assert sd["cg_steps"] == 0 < sp["cg_steps"]
    assert sd["final_cost"] <= sp["final_cost"]


# Per-block relative tolerance of the marginals (of each block's largest
# entry). The anchor's prior information (1e12 at sigma 1e-6) beside edge
# information of 1e2 gives the dense information matrix a condition
# number near 1e13, past fp32's 1/eps, so the two packages' LU inverses
# round differently (3.6e-4 measured); the block-diagonal inverse is a
# closed form on well-scaled 6x6 blocks (1.2e-6 measured).
MARGINAL_RTOL = {"dense": 2e-3, "block_diag": 1e-5}


@pytest.mark.parametrize("method", ["dense", "block_diag"])
def test_pose_marginals_match_jax(method):
    args, _ = _ring_problem()
    vmask = args[1].copy()
    vmask[-2:] = False
    args = (args[0], vmask) + args[2:]
    Sj = np.asarray(jpgo.pose_marginals(*[jnp.asarray(a) for a in args],
                                        jnp.int32(0), method=method))
    St = tpgo.pose_marginals(*[torch.as_tensor(a) for a in args], 0,
                             method=method).numpy()
    assert St.shape == (40, 6, 6) and np.isfinite(St).all()
    np.testing.assert_array_equal(St[-2:], 0.0)
    scale = np.abs(Sj).max(axis=(1, 2))
    err = np.abs(St - Sj).max(axis=(1, 2))
    assert (err <= MARGINAL_RTOL[method] * scale).all(), \
        (err / np.maximum(scale, 1e-30)).max()


ROUTES = [
    ("lm_pallas", 64, 64, "cpu", "lm"),
    ("lm_pallas", 100000, 100000, "cuda", "lm"),
    ("pcg", 64, 64, "cpu", "lm"), ("pcg", 100000, 100000, "cpu", "lm"),
    ("pcg", 1024, tpgo.K3_MAX_SIZE - 1024, "cuda", "lm"),
    ("pcg", 1024, tpgo.K3_MAX_SIZE - 1023, "cuda", "pcg"),
    ("pcg", 1024, 2048, "cuda", "lm"),          # pgo_1k
    ("pcg", 4096, 8192, "cuda", "pcg"),
    ("pcg_pallas", 64, 64, "cpu", "pcg"), ("pcg_pallas", 64, 64, "cuda", "pcg"),
    ("pcg_xla", 64, 64, "cuda", "pcg_plain"),
    ("pcg_xla", 64, 64, "cpu", "pcg_plain"),
    ("cholesky", 100000, 100000, "cuda", "dense"),
    ("auto", 8192 // 6, 4096, "cuda", "dense"),
    ("auto", 8192 // 6 + 1, 4096, "cpu", "pcg_plain"),
    ("no_such_solver", 64, 64, "cuda", "pcg_plain"),
]


@pytest.mark.parametrize("solver,V,E,device,path", ROUTES)
def test_route(solver, V, E, device, path):
    assert tpgo.route(tpgo.PGOConfig(solver=solver), V, E, device) == path


def test_bucketed_problem_has_optimizer_shapes():
    """Padded as ``Optimizer.prepare_for_optimization`` pads a graph:
    powers of two, identity fill, masks off, and the same valid part as
    the unpadded problem."""
    from pgslam_tpu_torch.pgo_problems import (bucketed_problem,
                                               pose_graph_problem)
    (poses, vmask, ef, et, eT, ec, emask, fixed), _ = bucketed_problem(
        48, 8, device="cpu")
    assert poses.shape[0] == 64 and ef.shape[0] == 64 and fixed == 0
    assert int(vmask.sum()) == 48 and int(emask.sum()) == 55
    plain, _ = pose_graph_problem(48, 8, device="cpu")
    valid = plain[:1] + plain[2:6]
    for padded, part, n in zip((poses, ef, et, eT, ec), valid,
                               (48, 55, 55, 55, 55)):
        assert torch.equal(padded[:n], part)
    assert torch.equal(poses[48:], torch.eye(4).expand(16, 4, 4))
    assert torch.equal(ec[55:], torch.eye(6).expand(9, 6, 6))
    assert not bool(ef[55:].any()) and not bool(et[55:].any())


def test_problem_builders_default_to_cuda(monkeypatch):
    from pgslam_tpu_torch import pgo_problems
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: pgo_problems.named_problem("pgo_1k"),
                  lambda: pgo_problems.bucketed_problem(48, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_unknown_solve_raises():
    args, _ = _ring_problem()
    with pytest.raises(ValueError):
        tpgo.lm_optimize_loop(*[torch.as_tensor(a) for a in args], 0,
                              solve="lu")
