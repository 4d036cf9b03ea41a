"""The fleet path of the port against pgslam_tpu on the same numpy inputs:
``batched_register`` (the headline metric's path), ``MultiAgentSlam``
over one shared pose graph, and the fleet's configurations and fixtures.
The K2 batches of the fleet are held on the card in
tests/test_torch_gpu.py."""

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
from pgslam_tpu.parallel.batched import batched_register as j_batched
from pgslam_tpu_torch import fleet_problems as FP
from pgslam_tpu_torch import replays
from pgslam_tpu_torch.cloud import make_cloud as tmake
from pgslam_tpu_torch.cloud import stack_clouds as tstack
from pgslam_tpu_torch.convert import config_from_dict, config_to_dict
from pgslam_tpu_torch.graph.pose_graph import LOOP_CONSTRAINT
from pgslam_tpu_torch.ops.icp import ICPConfig as TICPConfig
from pgslam_tpu_torch.ops.icp import ICPEngine as TEngine
from pgslam_tpu_torch.ops.icp import icp_core as t_icp_core
from pgslam_tpu_torch.parallel.batched import batched_register
from pgslam_tpu_torch.parallel.multi_agent import MultiAgentSlam

from test_slam_e2e import small_config
from test_torch_icp import _pair as _icp_pair

POSE_TOL_M = 0.10   # the envelope pgslam_tpu allows its own non-ST paths


def _t(a):
    return torch.from_numpy(np.array(a))


def _jcut(cloud, b):
    import jax
    return jax.tree_util.tree_map(lambda x: x[b], cloud)


def _twist_gap(T_port, T_jax):
    from pgslam_tpu_torch import se3 as tse3
    return float(tse3.log(tse3.inverse(T_port) @ _t(T_jax)).norm())


# -- configurations and fixtures -------------------------------------------

def test_fleet_configs_equal_jax():
    import bench
    for ours, theirs in ((FP.fleet_config(), small_config()),
                         (FP.batched_icp_config(), bench.batched_icp_config())):
        assert ours == config_from_dict(type(ours), config_to_dict(theirs))


def test_config5_sequence_equals_jax():
    from pgslam_tpu.datasets import corridor_sequence
    theirs = corridor_sequence(np.random.default_rng(7), n_scans=6,
                               scan_points=512, step=0.25, noise=0.003,
                               odom_noise=0.005, length=60.0)
    for a, b in zip(FP.config5_sequence(n_scans=6), theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_headline_fixtures_equal_bench(monkeypatch):
    """The recipe against ``bench.generate_stage_a`` bit for bit, at a
    small size (bench.py's protocol constants patched, not edited)."""
    import bench
    world = FP.headline_world()
    np.testing.assert_array_equal(world, bench._render_world())
    npts, batch, nbat = 2048, 3, 2
    for name, value in (("NPTS", npts), ("BATCH", batch), ("NBAT", nbat),
                        ("RSTRIDE", npts // 2048), ("LSTRIDE", npts // 1024)):
        monkeypatch.setattr(bench, name, value)
    stage_a = bench.generate_stage_a(world)
    packets, offsets = FP.headline_packets(world, n_blocks=nbat, batch=batch,
                                           n_points=npts)
    assert packets.dtype == np.int16 and packets.shape == (nbat, batch, 1024,
                                                           3)
    np.testing.assert_array_equal(packets, stage_a["lean_packets"])
    np.testing.assert_array_equal(offsets, stage_a["offsets"])
    np.testing.assert_array_equal(FP.np_se3_exp(np.ones((2, 6)) * 0.1),
                                  bench._np_se3_exp(np.ones((2, 6)) * 0.1))
    from pgslam_tpu.datasets import render_scan
    maps = FP.headline_maps(world, batch=2, n_points=npts)
    for b in range(2):
        np.testing.assert_array_equal(maps[b], render_scan(
            world, bench._agent_pose(b), np.random.default_rng(142 + b),
            npts, **bench.FIXTURE_PARAMS["scan"]))


# -- batched_register --------------------------------------------------------

def _box_pair(seed, n=420):
    """Points on the six faces of a 8 x 6 x 4 m box, moved by
    tests/test_torch_icp.py's offset. Unlike that file's two parallel
    planes, which leave x, y and yaw to the noise (their point-to-plane
    runs stop wherever rounding takes them for most seeds), every degree
    of freedom is observed, so each seed is a well-posed problem."""
    rng = np.random.default_rng(seed)
    half = np.array([4.0, 3.0, 2.0])
    pts = rng.uniform(-1, 1, (n, 3)) * half
    face = rng.integers(0, 6, n)
    axis = face % 3
    pts[np.arange(n), axis] = (np.where(face < 3, 1.0, -1.0) * half[axis]
                               + rng.normal(size=n) * 0.02)
    pts = pts.astype(np.float32)
    off = np.asarray(jse3.exp(jnp.asarray(
        [0.2, -0.1, 0.05, 0.02, -0.03, 0.04], jnp.float32)))
    moved = (pts - off[:3, 3]) @ off[:3, :3]
    moved += rng.normal(size=moved.shape).astype(np.float32) * 0.01
    return pts, moved.astype(np.float32)


# Three distinct problems per route. Left out, because there the two
# packages' single icp_core runs already stop apart (the batch adds
# nothing): box seed 2 at coarse_div 0, whose smoothed checker crosses eps
# within rounding (8 against 9 iterations), and box seeds 0 and 2 at
# coarse_div 4, where one trimmed point flips in the 105-point coarse stage
# and the fine stage stops 2e-4 apart.
_SEEDS = {("point_to_point", 0): (0, 1, 2), ("point_to_plane", 0): (0, 1, 3),
          ("point_to_plane", 4): (1, 3, 4)}


def _batch(error="point_to_plane", coarse=0):
    """Three distinct registrations: box scenes for point-to-plane,
    tests/test_torch_icp.py's blobs for point-to-point."""
    seeds = _SEEDS[error, coarse]
    eps = 1e-3 if error == "point_to_point" else 1e-4
    kw = dict(error=error, max_iterations=40, trans_eps=eps, rot_eps=eps,
              coarse_div=coarse, coarse_iterations=4)
    jcfg = JICPConfig(outlier=(JO.TrimmedDist(0.9), JO.MaxDist(1.0)),
                      reference_filters=(JF.SurfaceNormal(knn=8),), **kw)
    tcfg = config_from_dict(TICPConfig, config_to_dict(jcfg))
    je, te = JEngine(jcfg), TEngine(tcfg)
    jr, jm, tr, tm = [], [], [], []
    for s in seeds:
        pts, moved = (_box_pair(s) if error == "point_to_plane"
                      else _icp_pair(error, seed=s))
        je.set_map(jmake(pts, capacity=512))
        te.set_map(tmake(pts, capacity=512))
        jm.append(je.reference)
        tm.append(te.reference)
        jr.append(jmake(moved, capacity=512))
        tr.append(tmake(moved, capacity=512))
    B = len(seeds)
    return (jcfg, jstack(jr), jstack(jm), jnp.tile(jse3.identity(), (B, 1, 1)),
            tcfg, tstack(tr), tstack(tm),
            torch.eye(4).expand(B, 4, 4).contiguous())


@pytest.mark.parametrize("error", ["point_to_plane", "point_to_point"])
def test_batched_register_cpu_auto_matches_jax(error):
    """The CPU "auto" route (icp_core per entry) against JAX's (the
    vmapped icp_core), at tests/test_torch_icp.py's icp_core bounds."""
    jcfg, jr, jm, jT, tcfg, tr, tm, tT = _batch(error)
    rj = j_batched(jr, jm, jT, jcfg)
    rt = batched_register(tr, tm, tT, tcfg)
    for b in range(3):
        assert _twist_gap(rt.T[b], rj.T[b]) < 1e-5
        assert int(rt.iterations[b]) == int(rj.iterations[b])
        assert bool(rt.converged[b]) == bool(rj.converged[b])
        np.testing.assert_allclose(float(rt.overlap[b]),
                                   float(rj.overlap[b]), atol=1e-6)
        np.testing.assert_allclose(float(rt.residual[b]),
                                   float(rj.residual[b]), rtol=1e-3)
    # each entry is its own icp_core run
    one = t_icp_core(tr.map(lambda a: a[1]), tm.map(lambda a: a[1]), tT[1],
                     tcfg)
    assert torch.equal(one.T, rt.T[1])


@pytest.mark.slow
def test_batched_register_fused_on_matches_jax():
    """``fused="on"``: K2 (its plain version on CPU tensors) against JAX's
    K2 (the Pallas kernel in interpret mode), at
    tests/test_torch_icp_fused.py's bounds."""
    jcfg, jr, jm, jT, tcfg, tr, tm, tT = _batch("point_to_plane", coarse=4)
    rj = j_batched(jr, jm, jT, jcfg, fused="on")
    rt = batched_register(tr, tm, tT, tcfg, fused="on")
    for b in range(3):
        assert _twist_gap(rt.T[b], rj.T[b]) < 1e-5
        assert abs(int(rt.iterations[b]) - int(rj.iterations[b])) <= 1
        np.testing.assert_allclose(float(rt.overlap[b]),
                                   float(rj.overlap[b]), atol=0.01)


def test_batched_register_fused_on_routes_to_k2_plain():
    """``fused="on"`` on CPU tensors runs K2's plain version: each entry
    equals its own batch of one bit for bit, and matches JAX's icp_core
    at tests/test_torch_icp_fused.py's point-to-plane bounds."""
    from pgslam_tpu.ops.icp import icp_core as j_icp_core
    from pgslam_tpu_torch.ops.icp_fused import fused_icp_register
    jcfg, jr, jm, jT, tcfg, tr, tm, tT = _batch("point_to_plane", coarse=4)
    before = fused_icp_register.launches
    rt = batched_register(tr, tm, tT, tcfg, fused="on")
    assert fused_icp_register.launches == before   # no kernel on the CPU
    for b in range(3):
        one = batched_register(tr.map(lambda a: a[b:b + 1]),
                               tm.map(lambda a: a[b:b + 1]), tT[b:b + 1],
                               tcfg, fused="on")
        assert torch.equal(one.T[0], rt.T[b])
        rx = j_icp_core(_jcut(jr, b), _jcut(jm, b), jse3.identity(), jcfg)
        assert _twist_gap(rt.T[b], rx.T) < 1e-5


def test_batched_register_routing():
    from pgslam_tpu_torch.parallel.batched import use_fused
    _, _, _, _, tcfg, tr, tm, tT = _batch()
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not use_fused(tcfg, tm, cpu) and use_fused(tcfg, tm, cuda)
    assert use_fused(tcfg, tm, cpu, "on") and not use_fused(tcfg, tm, cuda,
                                                            "off")
    no_normals = tm.replace(descriptors={})
    assert not use_fused(tcfg, no_normals, cuda, "on")
    aa5 = dataclasses.replace(tcfg, anderson_m=5)
    assert not use_fused(aa5, tm, cuda, "on")
    with pytest.raises(ValueError):
        use_fused(tcfg, tm, cpu, "yes")


# -- MultiAgentSlam ----------------------------------------------------------

def _corridor_12():
    from pgslam_tpu.datasets import corridor_sequence
    return corridor_sequence(np.random.default_rng(7), n_scans=12,
                             scan_points=512, step=0.4, noise=0.003,
                             odom_noise=0.005, length=30.0)


def _loop_edges(g):
    return int(np.sum(g.edge_type[:g.n_edges] == LOOP_CONSTRAINT))


def test_two_agents_share_graph_match_jax():
    """tests/test_multi_agent.py::test_two_agents_share_graph's scene,
    the port's fleet against JAX's step for step."""
    from pgslam_tpu.parallel.multi_agent import MultiAgentSlam as JFleet
    from pgslam_tpu.utils import counters as jcounters
    from pgslam_tpu_torch.utils import counters as tcounters
    keys = [f"loopcloser/{k}"
            for k in ("accepted", "rejected", "rejected_duplicate")]
    before = ([jcounters[k] for k in keys], [tcounters[k] for k in keys])
    scans, odom, truth = _corridor_12()
    jf = JFleet(small_config(), n_agents=2)
    tf = MultiAgentSlam(FP.fleet_config(), n_agents=2, device="cpu")
    T_rs = np.eye(4, dtype=np.float32)
    worst = 0.0
    for i in range(10):
        Ts = np.stack([odom[i], odom[i + 1]])
        for f in (jf, tf):
            f.add_data_batch(i, "world", Ts, T_rs, [scans[i], scans[i + 1]])
        gap = np.linalg.norm(jf.poses()[:, :3, 3] - tf.poses()[:, :3, 3],
                             axis=1).max()
        worst = max(worst, float(gap))
        assert gap < POSE_TOL_M, (i, gap)
        assert tf.get_graph().n_vertices == jf.get_graph().n_vertices
        assert _loop_edges(tf.get_graph()) == _loop_edges(jf.get_graph())
    print(f"max per-agent pose gap to JAX over 10 steps: {worst:.3e} m")
    # Closure outcomes: the port's closer counts its own, and the process
    # counters moved by as much as JAX's.
    closer = tf.loop_closer
    own = [closer.accepted, closer.rejected, closer.rejected_duplicate]
    assert own == [tcounters[k] - b for k, b in zip(keys, before[1])]
    assert own == [jcounters[k] - b for k, b in zip(keys, before[0])]
    for b, i in ((0, 9), (1, 10)):
        assert np.linalg.norm(tf.poses()[b][:3, 3] - truth[i][:3, 3]) < 0.25
    assert tf.map_manager.get_fixed_vertex() == 0
    assert tf.trajectory().shape == (tf.get_graph().n_vertices, 4, 4)


def test_fleet_of_one_matches_golden_replay():
    """The fleet at B = 1 with synchronous closures replays the golden
    loop (tests/test_golden_replay.py:95-115)."""
    scans, odom, _ = replays.loop_sequence_golden()
    fleet = MultiAgentSlam(replays.loop_config(), n_agents=1, device="cpu")
    fleet.loop_closer.queue_mode = False
    fleet.localizers[0].defer_graph_resync = False
    T_rs = np.eye(4, dtype=np.float32)
    per_scan = []
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        fleet.add_data_batch(i, "world", T_odom[None], T_rs, [scan])
        per_scan.append(fleet.poses()[0].copy())
    gold = replays.fixture("loop")
    gap = replays.max_pose_gap(np.stack(per_scan), gold["per_scan_poses"],
                               window=1)
    print(f"fleet of one: max deviation {gap:.4f} m")
    assert gap < POSE_TOL_M
    assert _loop_edges(fleet.get_graph()) == int(gold["n_loop_edges"])


def test_prewarm_then_run_matches_cold():
    scans, odom, _ = _corridor_12()
    T_rs = np.eye(4, dtype=np.float32)

    def run(prewarm):
        fleet = MultiAgentSlam(FP.fleet_config(), n_agents=2, device="cpu")
        if prewarm:
            fleet.prewarm()
        for i in range(9):
            fleet.add_data_batch(i, "world", np.stack([odom[i], odom[i + 1]]),
                                 T_rs, [scans[i], scans[i + 1]])
        return fleet.poses(), fleet.get_graph().n_vertices

    cold_poses, cold_nv = run(False)
    warm_poses, warm_nv = run(True)
    np.testing.assert_array_equal(cold_poses, warm_poses)
    assert cold_nv == warm_nv


@pytest.mark.parametrize("fused, k2_batches", [("auto", 0), ("on", 2)])
def test_fleet_fused_routes_its_registration(monkeypatch, fused, k2_batches):
    """``MultiAgentSlam(fused=)`` reaches ``batched_register``: on CPU
    tensors "auto" registers by ``icp_core`` and "on" by K2's plain
    version, one batch of the fleet's size per step after the first."""
    from pgslam_tpu_torch.parallel import batched
    sizes = []
    k2 = batched.fused_icp_register

    def counted(readings, *a, **kw):
        sizes.append(readings.points.shape[0])
        return k2(readings, *a, **kw)

    monkeypatch.setattr(batched, "fused_icp_register", counted)
    scans, odom, _ = _corridor_12()
    fleet = MultiAgentSlam(FP.fleet_config(), n_agents=2, device="cpu",
                           fused=fused)
    for i in range(3):
        fleet.add_data_batch(i, "world", np.stack([odom[i], odom[i + 1]]),
                             np.eye(4), [scans[i], scans[i + 1]])
    assert sizes == [2] * k2_batches


def test_agents_with_first_scans_only():
    scans, odom, _ = _corridor_12()
    fleet = MultiAgentSlam(FP.fleet_config(), n_agents=3, device="cpu")
    fleet.add_data_batch(0, "world", np.stack([odom[0]] * 3), np.eye(4),
                         [scans[0]] * 3)
    assert fleet.get_graph().n_vertices == 3
    assert fleet.map_manager.get_fixed_vertex() == 0


def test_mesh_raises():
    """A mesh whose first device is not the ``device`` given raises (the
    mesh route itself: tests/test_torch_multi_agent_mesh.py)."""
    from pgslam_tpu_torch.parallel.multichip import make_mesh
    with pytest.raises(ValueError):
        MultiAgentSlam(FP.fleet_config(), n_agents=2,
                       mesh=make_mesh(2, tp=2, devices=["cpu"] * 2),
                       device=torch.device("cuda", 0))
    with pytest.raises(ValueError):
        MultiAgentSlam(FP.fleet_config(), n_agents=2,
                       device="cpu").add_data_batch(
            0, "world", np.stack([np.eye(4)] * 2), np.eye(4), [None])
