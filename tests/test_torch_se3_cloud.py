"""The port's core types against pgslam_tpu on the same numpy inputs:
SE(3) maps, clouds, the dataset generators, configs and conversions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pgslam_tpu.cloud as jcloud
import pgslam_tpu.datasets as jds
import pgslam_tpu.se3 as jse3
from pgslam_tpu import metrics as jmetrics
from pgslam_tpu_torch import cloud as tcloud
from pgslam_tpu_torch import datasets as tds
from pgslam_tpu_torch import metrics as tmetrics
from pgslam_tpu_torch import se3 as tse3

SE3_TOL = 3.5e-6     # PARITY.md "Precision": fp32 se3 round trip


def _twists(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    scale = np.concatenate([np.full(n // 4, 1e-5), np.full(n // 4, 1e-2),
                            np.full(n // 4, 0.3), np.full(n - 3 * (n // 4),
                                                          1.0)])
    x[:, 3:] *= scale[:, None].astype(np.float32)
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_se3_exp_log_inverse_match_jax(seed):
    x = _twists(seed=seed)
    Tj = np.array(jse3.exp(jnp.asarray(x)))
    Tt = tse3.exp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=SE3_TOL)
    np.testing.assert_allclose(tse3.log(torch.from_numpy(Tj)).numpy(),
                               np.asarray(jse3.log(jnp.asarray(Tj))),
                               atol=SE3_TOL)
    np.testing.assert_allclose(tse3.inverse(torch.from_numpy(Tj)).numpy(),
                               np.asarray(jse3.inverse(jnp.asarray(Tj))),
                               atol=SE3_TOL)
    # round trip, away from the log's branch cut at |w| = pi
    # fp32 round-trip error grows with the angle; hold the port to the
    # JAX package's own error on the same twists.
    x = x[np.linalg.norm(x[:, 3:], axis=1) < 2.0]
    err_t = np.abs(tse3.log(tse3.exp(torch.from_numpy(x))).numpy() - x)
    err_j = np.abs(np.asarray(jse3.log(jse3.exp(jnp.asarray(x)))) - x)
    assert err_t.max() <= 2.0 * err_j.max() + SE3_TOL


def test_se3_helpers_match_jax():
    x = _twists(seed=2)
    Tj = jse3.exp(jnp.asarray(x))
    Tt = torch.from_numpy(np.array(Tj))
    big = np.linalg.norm(x[:, 3:], axis=1) > 1e-2
    pairs = [
        (tse3.rotation_angle(Tt)[big], jse3.rotation_angle(Tj)[big]),
        (tse3.translation_norm(Tt), jse3.translation_norm(Tj)),
        (tse3.adjoint(Tt), jse3.adjoint(Tj)),
        (tse3.normalize_rotation_fast(Tt), jse3.normalize_rotation_fast(Tj)),
        (tmetrics.distance(Tt, Tt[:1]), jmetrics.distance(Tj, Tj[:1])),
        (tmetrics.weight(Tt), jmetrics.weight(Tj)),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    pts = np.random.default_rng(3).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.apply(Tt[3], torch.from_numpy(pts)).numpy(),
        np.asarray(jse3.apply(Tj[3], jnp.asarray(pts))), atol=1e-5)


def test_rotation_angle_exact_at_small_angles():
    """The JAX arccos form reads ~3.4e-4 rad or 0 for any angle below
    that in fp32; the port's atan2 form tracks the fp64 truth."""
    w = np.array([[1e-6, 0, 0], [0, 3e-5, 4e-5], [2e-4, -1e-4, 0],
                  [0.3, 0.2, -0.1]], np.float32)
    R = tse3.exp_so3(torch.from_numpy(w))
    T = tse3.make(R, torch.zeros(4, 3))
    truth = np.linalg.norm(w.astype(np.float64), axis=1)
    np.testing.assert_allclose(tse3.rotation_angle(T).numpy(), truth,
                               rtol=1e-3, atol=1e-8)


def test_cloud_ops_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(37, 3)).astype(np.float32) * 5
    nrm = rng.normal(size=(37, 3)).astype(np.float32)
    mask = rng.uniform(size=37) < 0.8
    cj = jcloud.make_cloud(pts, mask=mask, descriptors={"normals": nrm},
                           capacity=64)
    ct = tcloud.make_cloud(pts, mask=mask, descriptors={"normals": nrm},
                           capacity=64)
    np.testing.assert_array_equal(ct.points.numpy(), np.asarray(cj.points))
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    assert ct.capacity == cj.capacity == 64
    assert int(ct.count()) == int(cj.count())
    T = _twists(8, seed=4)[5]
    tj = jcloud.transform_cloud(jse3.exp(jnp.asarray(T)), cj)
    tt = tcloud.transform_cloud(tse3.exp(torch.from_numpy(T)), ct)
    np.testing.assert_allclose(tt.points.numpy(), np.asarray(tj.points),
                               atol=1e-5)
    np.testing.assert_allclose(tt.descriptors["normals"].numpy(),
                               np.asarray(tj.descriptors["normals"]),
                               atol=1e-6)
    # int16 millimetre fixed point
    mm = (pts * 1000).astype(np.int16)
    qj = jcloud.dequantize_cloud(jcloud.make_cloud(mm))
    qt = tcloud.make_cloud(mm)
    np.testing.assert_array_equal(qt.points.numpy(), np.asarray(qj.points))
    assert tcloud.dequantize_cloud(qt) is qt
    st = tcloud.stack_clouds([ct, tt])
    assert st.points.shape == (2, 64, 3)
    assert st.descriptors["normals"].shape == (2, 64, 3)
    with pytest.raises(ValueError):
        tcloud.make_cloud(pts, capacity=10)


def test_datasets_bit_equal():
    for seed in (0, 3):
        sj = jds.loop_sequence(np.random.default_rng(seed), n_scans=6,
                               scan_points=300, radius=10.0, max_range=8.0)
        st = tds.loop_sequence(np.random.default_rng(seed), n_scans=6,
                               scan_points=300, radius=10.0, max_range=8.0)
        for a_list, b_list in zip(sj, st):
            for a, b in zip(a_list, b_list):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    wj = jds.corridor_world(np.random.default_rng(0), n_points=5000,
                            length=20.0, width=8.0, height=5.0)
    wt = tds.corridor_world(np.random.default_rng(0), n_points=5000,
                            length=20.0, width=8.0, height=5.0)
    np.testing.assert_array_equal(wj, wt)
    T = tds._se3(2.0, 0.0, 1.8, yaw=0.1)
    np.testing.assert_array_equal(T, jds._se3(2.0, 0.0, 1.8, yaw=0.1))
    np.testing.assert_array_equal(
        jds.render_scan(wj, T, np.random.default_rng(1), 4000, 30.0, 0.01),
        tds.render_scan(wt, T, np.random.default_rng(1), 4000, 30.0, 0.01))


def _config_pairs():
    from pgslam_tpu import localizer, loopcloser, optimizer, slam
    from pgslam_tpu.ops import filters, icp, outlier
    from pgslam_tpu.optim import pgo
    from pgslam_tpu_torch import localizer as tloc
    from pgslam_tpu_torch import loopcloser as tlc
    from pgslam_tpu_torch import optimizer as topt
    from pgslam_tpu_torch import slam as tslam
    from pgslam_tpu_torch.ops import filters as tf
    from pgslam_tpu_torch.ops import icp as ticp
    from pgslam_tpu_torch.ops import outlier as to
    from pgslam_tpu_torch.optim import pgo as tpgo
    return [(icp.ICPConfig, ticp.ICPConfig),
            (outlier.TrimmedDist, to.TrimmedDist),
            (outlier.MaxDist, to.MaxDist),
            (filters.VoxelGrid, tf.VoxelGrid),
            (filters.Compact, tf.Compact),
            (filters.SurfaceNormal, tf.SurfaceNormal),
            (pgo.PGOConfig, tpgo.PGOConfig),
            (optimizer.OptimizerConfig, topt.OptimizerConfig),
            (localizer.LocalizerConfig, tloc.LocalizerConfig),
            (loopcloser.LoopCloserConfig, tlc.LoopCloserConfig),
            (slam.SlamConfig, tslam.SlamConfig)]


@pytest.mark.parametrize("pair", range(11))
def test_config_fields_and_defaults_match_jax(pair):
    jcls, tcls = _config_pairs()[pair]
    assert [f.name for f in dataclasses.fields(tcls)] == \
        [f.name for f in dataclasses.fields(jcls)]
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


def test_config_from_dict_rebuilds_the_replay_configs():
    import sys
    import os
    from golden_replay import golden_config
    from pgslam_tpu_torch import replays
    from pgslam_tpu_torch.convert import config_from_dict, config_to_dict
    from pgslam_tpu_torch.slam import SlamConfig
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "examples"))
    from velodyne_slam import velodyne_config
    for jcfg, tcfg in ((golden_config(), replays.loop_config()),
                       (velodyne_config(), replays.velodyne_config())):
        d = config_to_dict(jcfg)
        rebuilt = config_from_dict(SlamConfig, d)
        assert rebuilt == tcfg
        assert config_to_dict(rebuilt) == d
        assert dataclasses.asdict(rebuilt) == dataclasses.asdict(jcfg)


def test_graph_from_arrays_roundtrip():
    from pgslam_tpu.graph.pose_graph import PoseGraph as JGraph
    from pgslam_tpu_torch.convert import graph_from_arrays
    rng = np.random.default_rng(0)
    g = JGraph()
    for v in range(5):
        g.add_vertex(None, np.asarray(jse3.exp(jnp.asarray(
            rng.normal(size=6).astype(np.float32)))), v + 1)
    for u, v, t in ((0, 1, 0), (1, 2, 0), (2, 3, 0), (3, 4, 0), (4, 0, 1)):
        g.add_edge(u, v, np.linalg.inv(g.poses[u]) @ g.poses[v],
                   np.eye(6) * 0.01, t)
    n, e = g.n_vertices, g.n_edges
    t = graph_from_arrays(g.poses[:n], g.optimized_poses[:n],
                          g.update_times[:n], g.edge_from[:e], g.edge_to[:e],
                          g.edge_T[:e], g.edge_cov[:e], g.edge_type[:e])
    for name in ("poses", "optimized_poses", "update_times"):
        np.testing.assert_array_equal(getattr(t, name)[:n],
                                      getattr(g, name)[:n])
    for name in ("edge_from", "edge_to", "edge_T", "edge_cov", "edge_type",
                 "edge_weight"):
        np.testing.assert_array_equal(getattr(t, name)[:e],
                                      getattr(g, name)[:e])
    for v in range(n):
        np.testing.assert_array_equal(t.adjacent_vertices(v),
                                      g.adjacent_vertices(v))
    for optimized in (True, False):
        np.testing.assert_array_equal(
            t.device_poses(optimized).numpy(),
            np.asarray(g.device_poses(optimized)))
    for a, b in zip(t.device_edges(), g.device_edges()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
