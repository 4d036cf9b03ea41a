"""Anderson acceleration (type-II AA on the window of se3-log twists) in
the port against pgslam_tpu on the same numpy inputs: ``icp_core``'s AA
loop (``body_aa``) and K2's plain AA stage (``run_stage_aa``). The CUDA
stage is held against the plain one in tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgslam_tpu import se3 as jse3
from pgslam_tpu.cloud import make_cloud as jmake
from pgslam_tpu.cloud import stack_clouds as jstack
from pgslam_tpu.ops import filters as JF
from pgslam_tpu.ops import minimizer as JM
from pgslam_tpu.ops import outlier as JO
from pgslam_tpu.ops.icp import ICPConfig as JICPConfig
from pgslam_tpu.ops.icp import ICPEngine as JEngine
from pgslam_tpu.ops.icp import _match_and_weigh, build_error_elements
from pgslam_tpu.ops.icp import icp_core as j_icp_core
from pgslam_tpu_torch import se3 as tse3
from pgslam_tpu_torch.cloud import make_cloud as tmake
from pgslam_tpu_torch.convert import config_from_dict, config_to_dict
from pgslam_tpu_torch.ops.icp import ICPConfig as TICPConfig
from pgslam_tpu_torch.ops.icp import ICPEngine as TEngine
from pgslam_tpu_torch.ops.icp import _anderson
from pgslam_tpu_torch.ops.icp import icp_core as t_icp_core
from pgslam_tpu_torch.ops.icp_fused import fused_eligible

from test_torch_icp_fused import _cfg, _pair, _port


def _t(a):
    return torch.from_numpy(np.array(a))


def _twist_gap(T_port, T_jax):
    return float(tse3.log(tse3.inverse(T_port) @ _t(T_jax)).norm())


def _anderson_scene():
    """tests/test_anderson.py's scene (its ``rng`` fixture is seed 42)."""
    rng = np.random.default_rng(42)
    pts = rng.uniform(-5, 5, (1500, 3)).astype(np.float32)
    pts[:, 2] = np.sign(pts[:, 2]) * 2 + rng.normal(size=1500) * 0.3
    T_true = jse3.exp(jnp.asarray([0.35, -0.25, 0.1, 0.05, -0.04, 0.09],
                                  jnp.float32))
    moved = np.asarray(jse3.apply(jse3.inverse(T_true), jnp.asarray(pts)))
    return pts, moved, np.asarray(T_true)


def _configs(error, m):
    """tests/test_anderson.py's config (point-to-plane adds normals)."""
    jcfg = JICPConfig(error=error, max_iterations=60,
                      outlier=(JO.TrimmedDist(0.95), JO.MaxDist(1.0)),
                      trans_eps=1e-4, rot_eps=1e-4, anderson_m=m,
                      reference_filters=(JF.SurfaceNormal(knn=8),)
                      if error == "point_to_plane" else ())
    return jcfg, config_from_dict(TICPConfig, config_to_dict(jcfg))


_PLAIN_ITERATIONS = {}


def _register(error, m):
    """JAX and port icp_core on the scene; returns (jax result, port
    result, truth)."""
    pts, moved, T_true = _anderson_scene()
    jcfg, tcfg = _configs(error, m)
    je, te = JEngine(jcfg), TEngine(tcfg)
    je.set_map(jmake(pts, capacity=1536))
    te.set_map(tmake(pts, capacity=1536))
    rj = j_icp_core(jmake(moved, capacity=1536), je.reference,
                    jse3.identity(), jcfg)
    rt = t_icp_core(tmake(moved, capacity=1536), te.reference, torch.eye(4),
                    tcfg)
    return rj, rt, T_true


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("error", ["point_to_plane", "point_to_point"])
def test_icp_core_anderson_matches_jax(error, m):
    rj, rt, T_true = _register(error, m)
    assert _twist_gap(rt.T, rj.T) < 1e-4
    assert _twist_gap(rt.T, T_true) < 2e-3          # test_anderson.py's
    assert bool(rt.converged) == bool(rj.converged)
    if error == "point_to_plane":
        assert abs(int(rt.iterations) - int(rj.iterations)) <= \
            (2 if m == 4 else 1)
    else:
        # Point-to-point AA on this scene amplifies the plain steps'
        # ~2e-7 rounding differences through the window's small solve:
        # mid-run the two trajectories stand centimetres apart before
        # they meet at the answer, so their stopping iterations drift
        # (measured 17/18/13 against JAX's 17/15/13). The update itself
        # is pinned step for step below; the claim test_anderson.py makes
        # is held here: AA stops no later than the plain run.
        if error not in _PLAIN_ITERATIONS:
            _PLAIN_ITERATIONS[error] = int(_register(error, 0)[0].iterations)
        assert int(rt.iterations) <= _PLAIN_ITERATIONS[error]


def _jax_aa_update(T, T_plain, T0, X, GX, it, m):
    """``pgslam_tpu/ops/icp.py`` ``body_aa``'s update, transcribed."""
    Tinv0 = jse3.inverse(T0)
    x_k = jse3.log(T @ Tinv0)
    g_k = jse3.log(T_plain @ Tinv0)
    X = jnp.roll(X, 1, axis=0).at[0].set(x_k)
    GX = jnp.roll(GX, 1, axis=0).at[0].set(g_k)
    Fr = GX - X
    dF = Fr[0] - Fr[1:]
    dG = GX[0] - GX[1:]
    A = dF @ dF.T + 1e-10 * jnp.eye(m - 1, dtype=T.dtype)
    gamma = jnp.linalg.solve(A, dF @ Fr[0])
    x_acc = g_k - gamma @ dG
    plain_sz = jnp.linalg.norm(g_k - x_k)
    ok = jnp.logical_and(jnp.linalg.norm(x_acc - g_k) <= 2.0 * plain_sz
                         + 1e-9, it + 1 >= m)
    return jse3.exp(jnp.where(ok, x_acc, g_k)) @ T0, X, GX, bool(ok)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_anderson_update_matches_jax_step_for_step(m):
    """The port's AA update fed JAX's own trajectory: at every iteration
    both take the same (T, plain step) and must give the same accelerated
    transform and the same accept/reject decision."""
    pts, moved, _ = _anderson_scene()
    jcfg, _ = _configs("point_to_point", m)
    je = JEngine(jcfg)
    je.set_map(jmake(pts, capacity=1536))
    reading = jmake(moved, capacity=1536)
    T = T0 = jse3.identity()
    X = GX = jnp.zeros((m, 6), jnp.float32)
    eye4 = torch.eye(4)
    Xt = GXt = torch.zeros((m, 6))
    eye = torch.eye(m - 1)
    accepted = 0
    for it in range(16):
        p = jse3.apply(T, reading.points)
        matches, w = _match_and_weigh(p, reading.mask, je.reference, jcfg,
                                      None)
        T_plain = JM.point_to_point(build_error_elements(
            p, reading.mask, je.reference, matches, w, jcfg)) @ T
        T_new, X, GX, ok = _jax_aa_update(T, T_plain, T0, X, GX, it, m)
        T_port, Xt, GXt = _anderson(_t(T), _t(T_plain), Xt, GXt, eye4,
                                    tse3.inverse(eye4), eye, it + 1 >= m)
        # The window's small solve is ill-conditioned mid-run (gamma up
        # to ~9 here), so its rounding alone moves the update by ~4e-5.
        assert _twist_gap(T_port, T_new) < 1e-4, it
        accepted += ok
        T = T_new
    assert accepted > 0


@pytest.mark.parametrize("m", [2, 3, 4])   # m = 4: the 3x3 solve
def test_fused_plain_anderson_matches_icp_core(m):
    """K2's plain AA stage against JAX's icp_core with AA, at
    tests/test_icp_fused.py:146-166's bounds."""
    jcfg, tcfg = _cfg(anderson_m=m)
    assert fused_eligible(tcfg)
    (je, jr), (te, tr) = _pair(jcfg, tcfg)
    rx = j_icp_core(jr, je.reference, jse3.identity(), jcfg)
    rf = _port(te, tr, tcfg)
    assert _twist_gap(rf.T[0], rx.T) < 1e-4
    assert abs(int(rf.iterations[0]) - int(rx.iterations)) <= \
        (2 if m == 4 else 1)
    assert bool(rf.converged[0]) == bool(rx.converged)


@pytest.mark.slow
def test_fused_plain_anderson_matches_pallas_interpret():
    from pgslam_tpu.ops.icp_pallas import fused_icp_register as pallas_reg
    jcfg, tcfg = _cfg(anderson_m=3)
    (je, jr), (te, tr) = _pair(jcfg, tcfg)
    rp = pallas_reg(jstack([jr]), jstack([je.reference]),
                    jnp.tile(jse3.identity(), (1, 1, 1)), jcfg, tile_r=256)
    rf = _port(te, tr, tcfg)
    assert _twist_gap(rf.T[0], rp.T[0]) < 1e-4
    assert abs(int(rf.iterations[0]) - int(rp.iterations[0])) <= 1
    assert bool(rf.converged[0]) == bool(rp.converged[0])
