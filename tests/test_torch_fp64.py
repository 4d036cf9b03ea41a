"""fp64 on the port's plain paths (the CPU): the three checks of
``scripts/fp64_instantiation.py`` at its tolerances (se3 round trip,
exact-matcher ICP recovery, LM on the 16-pose ring), each output held to
``pgslam_tpu``'s fp64 output on the same seeded inputs at 1e-9, and an
fp32 run that keeps its dtype and its bits. The C++ reference builds
``PoseGraphSlam<float>`` and ``<double>``; the TPU has no fp64, and the
JAX package checks its fp64 on the CPU, in a process of its own because
``jax_enable_x64`` is process-global: the JAX outputs come from such a
subprocess here too."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pgslam_tpu_torch import se3
from pgslam_tpu_torch.cloud import make_cloud
from pgslam_tpu_torch.ops import outlier as O
from pgslam_tpu_torch.ops.icp import ICPConfig, icp
from pgslam_tpu_torch.optim.pgo import PGOConfig, optimize_pose_graph
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scripts/fp64_instantiation.py's tolerances.
SE3_ROUNDTRIP_TOL = 1e-12
ICP_RECOVERY_TOL = 1e-10
PGO_COST_TOL = 1e-15
PGO_POSE_TOL = 1e-9
# The port against pgslam_tpu, fp64 both.
PARITY_TOL = 1e-9
TWIST_GT = [0.05, -0.03, 0.01, 0.005, -0.002, 0.01]
ICP_CFG = dict(error="point_to_point", matcher="exact", max_iterations=20)
PGO_ITERATIONS = 10

# The JAX side, run in a subprocess with jax_enable_x64 on the inputs the
# test wrote: the three computations of scripts/fp64_instantiation.py.
JAX_FP64 = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[3])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from pgslam_tpu import se3
    from pgslam_tpu.cloud import make_cloud
    from pgslam_tpu.ops import outlier as O
    from pgslam_tpu.ops.icp import ICPConfig, icp
    from pgslam_tpu.optim.pgo import PGOConfig, optimize_pose_graph
    d = np.load(sys.argv[1])
    T = jax.vmap(se3.exp)(jnp.asarray(d["xi"]))
    back = jax.vmap(se3.log)(T)
    T_gt = se3.exp(jnp.asarray(d["twist_gt"]))
    res = icp(make_cloud(d["pts"], capacity=256, dtype=jnp.float64),
              make_cloud(d["moved"], capacity=256, dtype=jnp.float64),
              jnp.eye(4, dtype=jnp.float64),
              ICPConfig(error="point_to_point", matcher="exact",
                        outlier=(O.TrimmedDist(0.9),), max_iterations=20))
    V = d["init"].shape[0]
    out, st = optimize_pose_graph(
        jnp.asarray(d["init"]), jnp.ones(V, bool), jnp.asarray(d["ei"]),
        jnp.asarray(d["ej"]), jnp.asarray(d["rel"]), jnp.asarray(d["cov"]),
        jnp.ones(V, bool), jnp.asarray(0, jnp.int32),
        config=PGOConfig(max_iterations=int(d["pgo_iterations"])))
    for a in (T, back, T_gt, res.T, out):
        assert a.dtype == jnp.float64, a.dtype
    np.savez(sys.argv[2], T=np.asarray(T), back=np.asarray(back),
             T_gt=np.asarray(T_gt), icp_T=np.asarray(res.T),
             pgo=np.asarray(out), pgo_cost=float(st["final_cost"]))
""")


def _inputs():
    """scripts/fp64_instantiation.py's inputs, in its order from its
    seed (the ICP truth is a twist, exponentiated by each package)."""
    rng = np.random.default_rng(7)
    xi = rng.normal(size=(64, 6)) * 0.5
    pts = rng.normal(size=(256, 3)) * np.array([5.0, 5.0, 1.0])
    V = 16
    angles = np.linspace(0, 2 * np.pi, V, endpoint=False)
    gt = np.tile(np.eye(4), (V, 1, 1))
    gt[:, 0, 3] = np.cos(angles) * 5.0
    gt[:, 1, 3] = np.sin(angles) * 5.0
    init = gt.copy()
    init[1:, :3, 3] += rng.normal(size=(V - 1, 3)) * 0.1
    ei = np.arange(V, dtype=np.int32)
    ej = ((np.arange(V) + 1) % V).astype(np.int32)
    rel = np.stack([np.linalg.inv(gt[i]) @ gt[j] for i, j in zip(ei, ej)])
    cov = np.tile(np.eye(6) * 1e-4, (V, 1, 1))
    T_gt = se3.exp(torch.tensor(TWIST_GT, dtype=torch.float64)).numpy()
    moved = pts @ T_gt[:3, :3].T + T_gt[:3, 3]
    return dict(xi=xi, pts=pts, moved=moved, twist_gt=np.array(TWIST_GT),
                gt=gt, init=init, ei=ei, ej=ej, rel=rel, cov=cov,
                pgo_iterations=PGO_ITERATIONS)


def _port(d, dtype=torch.float64):
    """The three computations on the port's plain paths (the CPU)."""
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    T = se3.exp(t(d["xi"]))
    back = se3.log(T)
    res = icp(make_cloud(d["pts"], capacity=256, device="cpu", dtype=dtype),
              make_cloud(d["moved"], capacity=256, device="cpu",
                         dtype=dtype),
              torch.eye(4, dtype=dtype),
              ICPConfig(outlier=(O.TrimmedDist(0.9),), **ICP_CFG))
    V = d["init"].shape[0]
    out, st = optimize_pose_graph(
        t(d["init"]), torch.ones(V, dtype=torch.bool),
        torch.as_tensor(d["ei"]), torch.as_tensor(d["ej"]), t(d["rel"]),
        t(d["cov"]), torch.ones(V, dtype=torch.bool), 0,
        config=PGOConfig(max_iterations=PGO_ITERATIONS))
    return dict(T=T, back=back, icp_T=res.T, pgo=out,
                pgo_cost=st["final_cost"])


@pytest.fixture(scope="module")
def fp64_runs(tmp_path_factory):
    """The port's fp64 outputs and pgslam_tpu's on the same inputs."""
    d = _inputs()
    tmp = tmp_path_factory.mktemp("fp64")
    np.savez(tmp / "in.npz", **d)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_FP64, str(tmp / "in.npz"),
         str(tmp / "out.npz"), REPO],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    return d, _port(d), dict(np.load(tmp / "out.npz"))


def test_se3_roundtrip_fp64(fp64_runs):
    d, ours, theirs = fp64_runs
    assert ours["T"].dtype == ours["back"].dtype == torch.float64
    assert np.abs(ours["back"].numpy() - d["xi"]).max() < SE3_ROUNDTRIP_TOL
    np.testing.assert_allclose(ours["T"].numpy(), theirs["T"], rtol=0,
                               atol=PARITY_TOL)
    np.testing.assert_allclose(ours["back"].numpy(), theirs["back"], rtol=0,
                               atol=PARITY_TOL)


def test_icp_exact_recovery_fp64(fp64_runs):
    d, ours, theirs = fp64_runs
    T = ours["icp_T"]
    assert T.dtype == torch.float64
    T_gt = torch.as_tensor(theirs["T_gt"])
    err = float(torch.linalg.norm(se3.log(se3.inverse(T) @ T_gt)))
    assert err < ICP_RECOVERY_TOL
    np.testing.assert_allclose(T.numpy(), theirs["icp_T"], rtol=0,
                               atol=PARITY_TOL)


def test_pgo_ring_fp64(fp64_runs):
    d, ours, theirs = fp64_runs
    out = ours["pgo"]
    assert out.dtype == torch.float64
    assert float(ours["pgo_cost"]) < PGO_COST_TOL
    assert np.abs(out.numpy() - d["gt"]).max() < PGO_POSE_TOL
    np.testing.assert_allclose(out.numpy(), theirs["pgo"], rtol=0,
                               atol=PARITY_TOL)


def test_fp32_keeps_its_dtype_and_bits():
    """The default stays fp32 and the fp32 bits do not depend on the
    dtype of the start pose or on the new dtype argument."""
    d = {k: (v.astype(np.float32) if isinstance(v, np.ndarray)
             and v.dtype == np.float64 else v) for k, v in _inputs().items()}
    ours = _port(d, torch.float32)
    for k in ("T", "back", "icp_T", "pgo"):
        assert ours[k].dtype == torch.float32, k
    assert make_cloud(d["pts"], device="cpu").points.dtype == torch.float32
    assert torch.equal(make_cloud(d["pts"], device="cpu").points,
                       make_cloud(d["pts"], device="cpu",
                                  dtype=torch.float32).points)
    reading = make_cloud(d["pts"], capacity=256, device="cpu")
    ref = make_cloud(d["moved"], capacity=256, device="cpu")
    cfg = ICPConfig(outlier=(O.TrimmedDist(0.9),), **ICP_CFG)
    a = icp(reading, ref, torch.eye(4, dtype=torch.float32), cfg)
    b = icp(reading, ref, torch.eye(4, dtype=torch.float64), cfg)
    assert a.T.dtype == b.T.dtype == torch.float32
    assert torch.equal(a.T, b.T) and torch.equal(a.cov, b.cov)
    assert torch.equal(ours["icp_T"], a.T)
    # int16 millimetres still dequantize (in fp32), to the cloud's dtype.
    mm = (d["pts"] * 1000).astype(np.int16)
    metres = mm.astype(np.float32) * np.float32(1e-3)
    for dtype in (torch.float32, torch.float64):
        c = make_cloud(mm, device="cpu", dtype=dtype)
        assert c.points.dtype == dtype
        np.testing.assert_array_equal(c.points.numpy(),
                                      metres.astype(c.points.numpy().dtype))
