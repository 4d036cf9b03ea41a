"""K2 (a whole ICP registration): the port's plain version against the JAX
icp_core at the tolerances of tests/test_icp_fused.py, and against the
Pallas kernel in interpret mode (slow tier). The CUDA kernel is held
against the plain version in tests/test_torch_gpu.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgslam_tpu import se3 as jse3
from pgslam_tpu.cloud import make_cloud as jmake
from pgslam_tpu.cloud import stack_clouds as jstack
from pgslam_tpu.ops import filters as JF
from pgslam_tpu.ops import outlier as JO
from pgslam_tpu.ops.icp import ICPConfig as JICPConfig
from pgslam_tpu.ops.icp import ICPEngine as JEngine
from pgslam_tpu.ops.icp import icp_core as j_icp_core
from pgslam_tpu_torch import se3 as tse3
from pgslam_tpu_torch.cloud import make_cloud as tmake
from pgslam_tpu_torch.cloud import stack_clouds as tstack
from pgslam_tpu_torch.convert import config_from_dict
from pgslam_tpu_torch.ops.icp import ICPConfig as TICPConfig
from pgslam_tpu_torch.ops.icp import ICPEngine as TEngine
from pgslam_tpu_torch.ops.icp_fused import fused_eligible, fused_icp_register


def _cfg(**kw):
    """tests/test_icp_fused.py::_cfg for both packages."""
    base = dict(error="point_to_plane", matcher="pallas",
                outlier=(JO.TrimmedDist(0.9), JO.MaxDist(1.0)),
                reference_filters=(JF.SurfaceNormal(knn=8),),
                max_iterations=12, trans_eps=1e-4, rot_eps=1e-4,
                coarse_div=4, coarse_iterations=4)
    base.update(kw)
    j = JICPConfig(**base)
    return j, config_from_dict(TICPConfig, dataclasses.asdict(j))


def _scene(n=420, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    pts[:, 2] = np.sign(pts[:, 2]) * 2 + \
        rng.normal(size=n).astype(np.float32) * 0.1
    return rng, pts


def _pair(jcfg, tcfg, capacity=512, dup=0):
    rng, pts = _scene()
    if dup:
        pts = np.concatenate([pts, pts[:dup]])
    off = np.asarray(jse3.exp(jnp.asarray(
        [0.2, -0.1, 0.05, 0.02, -0.03, 0.04], jnp.float32)))
    moved = ((pts - off[:3, 3]) @ off[:3, :3]).astype(np.float32)
    moved += rng.normal(size=moved.shape).astype(np.float32) * 0.01
    je, te = JEngine(jcfg), TEngine(tcfg)
    je.set_map(jmake(pts, capacity=capacity))
    te.set_map(tmake(pts, capacity=capacity))
    return (je, jmake(moved, capacity=capacity)), \
        (te, tmake(moved, capacity=capacity))


def _port(te, reading, tcfg, B=1):
    return fused_icp_register(tstack([reading] * B),
                              tstack([te.reference] * B),
                              torch.eye(4).expand(B, 4, 4).contiguous(), tcfg)


@pytest.mark.parametrize("kw", [{}, {"coarse_div": 0},
                                {"outlier": (JO.MaxDist(1.0),)},
                                {"error": "point_to_point",
                                 "reference_filters": ()}])
def test_plain_matches_icp_core(kw):
    jcfg, tcfg = _cfg(**kw)
    assert fused_eligible(tcfg)
    (je, jr), (te, tr) = _pair(jcfg, tcfg)
    rx = j_icp_core(jr, je.reference, jse3.identity(), jcfg)
    rf = _port(te, tr, tcfg, B=2)
    d = tse3.log(tse3.inverse(rf.T[0]) @ torch.from_numpy(np.array(rx.T)))
    # test_icp_fused.py's bounds: 1e-5 p2plane, 5e-5 p2point (polar vs SVD)
    assert float(d.norm()) < (5e-5 if kw.get("error") else 1e-5)
    if not kw.get("error"):
        # Point-to-point stops apart by design, as in test_icp_fused.py:
        # icp_core's arccos angle is quantized to ~3.4e-4 rad in fp32,
        # above rot_eps, while K2 reads the twist of its step.
        assert abs(int(rf.iterations[0]) - int(rx.iterations)) <= 1
        assert bool(rf.converged[0]) == bool(rx.converged)
    np.testing.assert_allclose(float(rf.overlap[0]), float(rx.overlap),
                               atol=0.02 if kw.get("error") else 0.01)
    np.testing.assert_allclose(float(rf.residual[0]), float(rx.residual),
                               rtol=0.05 if kw.get("error") else 0.02)
    cx = np.asarray(rx.cov)
    np.testing.assert_allclose(rf.cov[0].numpy(), cx,
                               atol=1e-8 + 0.05 * np.abs(cx).max())
    np.testing.assert_array_equal(rf.T[0].numpy(), rf.T[1].numpy())


def test_duplicate_references_average_to_the_same_match():
    jcfg, tcfg = _cfg()
    (je, jr), (te, tr) = _pair(jcfg, tcfg, capacity=1024, dup=80)
    rx = j_icp_core(jr, je.reference, jse3.identity(), jcfg)
    rf = _port(te, tr, tcfg)
    d = tse3.log(tse3.inverse(rf.T[0]) @ torch.from_numpy(np.array(rx.T)))
    assert float(d.norm()) < 1e-5
    assert torch.isfinite(rf.cov).all()


def test_degenerate_reading_and_bound_checker():
    jcfg, tcfg = _cfg()
    (_, _), (te, tr) = _pair(jcfg, tcfg)
    dead = tmake(np.zeros((4, 3), np.float32), mask=np.zeros(4, bool),
                 capacity=512)
    rf = _port(te, dead, tcfg)
    np.testing.assert_allclose(rf.T[0].numpy(), np.eye(4), atol=1e-6)
    assert torch.isfinite(rf.cov).all() and float(rf.overlap[0]) == 0.0
    _, tcfg = _cfg(max_correction_trans=0.01)
    rf = _port(te, tr, tcfg)
    assert bool(rf.diverged[0]) and not bool(rf.converged[0])
    np.testing.assert_allclose(rf.T[0].numpy(), np.eye(4), atol=1e-6)


def test_eligibility_gate():
    from pgslam_tpu.ops.icp_pallas import fused_eligible as j_eligible
    from pgslam_tpu_torch.ops.icp_fused import MAX_SMOOTH
    assert fused_eligible(_cfg(error="point_to_point")[1])
    # Anderson windows as the JAX package takes them: m <= 4 in-kernel.
    for m, ok in ((3, True), (4, True), (5, False)):
        jcfg, tcfg = _cfg(anderson_m=m)
        assert fused_eligible(tcfg) == j_eligible(jcfg) == ok, m
    assert not fused_eligible(_cfg(knn=2)[1])
    # Narrower than JAX (ROADMAP queue 3): two filters of one kind, or a
    # checker window above MAX_SMOOTH, run icp_core in the port.
    for kw in ({"outlier": (JO.TrimmedDist(0.9), JO.TrimmedDist(0.8))},
               {"outlier": (JO.MaxDist(1.0), JO.MaxDist(0.5))},
               {"smooth_length": MAX_SMOOTH + 1}):
        jcfg, tcfg = _cfg(**kw)
        assert j_eligible(jcfg) and not fused_eligible(tcfg), kw
    assert fused_eligible(_cfg(smooth_length=MAX_SMOOTH)[1])
    with pytest.raises(ValueError):
        fused_icp_register(None, None, None, _cfg(knn=2)[1])


@pytest.mark.slow
def test_plain_matches_fused_pallas_interpret():
    from pgslam_tpu.ops.icp_pallas import fused_icp_register as pallas_reg
    jcfg, tcfg = _cfg(coarse_div=0)
    (je, jr), (te, tr) = _pair(jcfg, tcfg)
    rp = pallas_reg(jstack([jr]), jstack([je.reference]),
                    jnp.tile(jse3.identity(), (1, 1, 1)), jcfg, tile_r=256)
    rf = _port(te, tr, tcfg)
    d = tse3.log(tse3.inverse(rf.T[0]) @ torch.from_numpy(np.array(rp.T[0])))
    assert float(d.norm()) < 1e-5
    assert abs(int(rf.iterations[0]) - int(rp.iterations[0])) <= 1
    np.testing.assert_allclose(float(rf.overlap[0]), float(rp.overlap[0]),
                               atol=0.01)
