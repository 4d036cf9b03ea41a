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


# -- the fleet's input preparation as one batch -----------------------------

def _random_T(rng):
    from pgslam_tpu_torch import se3 as tse3
    T = tse3.exp(torch.as_tensor(rng.normal(0, 0.5, 6), dtype=torch.float32))
    return T.numpy()


def _ragged_chain(monkeypatch):
    """Make the input chain's outputs differ in capacity between agents
    (no filter of the port does that): the first agent's output gains a
    padding row, which its compaction drops again."""
    from pgslam_tpu_torch.cloud import pad_cloud
    from pgslam_tpu_torch.ops import filters as TF
    apply, calls = TF.apply_chain, []

    def ragged(chain, cloud, seed=0):
        out = apply(chain, cloud, seed)
        calls.append(seed)
        return pad_cloud(out, out.capacity + 1) if len(calls) == 1 else out
    monkeypatch.setattr(TF, "apply_chain", ragged)


# (input kind, points per agent, sensor capacity, keyframe capacity, input
# chain, reading chain, ragged chain outputs). 200 of 256 at B = 2 is a
# shape where the CPU's batched matmul rounds the rotation's three-term
# sums otherwise than one matmul per cloud.
PREP_CASES = {
    "float32": ("float32", [512, 768, 700], 768, 512, (), (), False),
    "float64": ("float64", [512, 768, 700], 768, 512, (), (), False),
    "int16": ("int16", [512, 768, 700], 768, 512, (), (), False),
    "bmm_shape": ("float32", [256, 180], 256, 200, (), (), False),
    "cloud": ("cloud", [512, 768, 700], 768, 512, (), (), False),
    "cloud_int16": ("cloud_int16", [512, 768, 700], 768, 512, (), (), False),
    "mixed": ("mixed", [512, 768, 700], 768, 512, (), (), False),
    "mixed_int16": ("mixed_int16", [512, 768, 700], 768, 512, (), (), False),
    "input_chain": ("float32", [512, 768, 700], 768, 512,
                    ("sample", "maxdist", "obsdir"), (), False),
    "reading_chain": ("int16", [512, 768, 700], 768, 512, (),
                      ("sample", "mindist", "obsdir"), False),
    "ragged_chain": ("float32", [512, 768, 700], 768, 512, ("sample",), (),
                     True),
}


@pytest.mark.parametrize("case", sorted(PREP_CASES))
def test_batched_preparation_has_each_agents_bits(monkeypatch, case):
    """The fleet's input preparation (one upload, then dequantization,
    compaction and transform once over the batch) against each agent's
    ``prepare_input`` and reading chain on its own cloud: points, mask and
    every descriptor bit for bit, at n below and at the sensor capacity,
    under per-agent seeds, from arrays, from clouds already made and from
    both at once. At the batched matmul's other rounding (``bmm_shape``)
    the points differ from the per-cloud ones by at most the rounding of
    the transform's sums; the mask is still bit for bit."""
    from pgslam_tpu_torch.cloud import Cloud, dequantize_cloud
    from pgslam_tpu_torch.localizer import prepare_input, prepare_input_batched
    from pgslam_tpu_torch.ops import filters as TF
    kind, ns, cap, kcap, chain, rchain, ragged = PREP_CASES[case]
    named = {"sample": TF.RandomSampling(0.5), "maxdist": TF.MaxDist(2.5),
             "mindist": TF.MinDist(0.3),
             "obsdir": TF.ObservationDirection(x=0.5, y=-0.2, z=0.1)}
    chain = tuple(named[c] for c in chain)
    rchain = tuple(named[c] for c in rchain)
    rng = np.random.default_rng(sum(map(ord, case)))
    B = len(ns)
    fine = [rng.normal(0, 2.0, (n, 3)) for n in ns]
    if kind.endswith("int16"):
        host = [np.round(p * 1000).astype(np.int16) for p in fine]
    else:
        host = [p.astype(kind if kind.startswith("float") else np.float32)
                for p in fine]
    if kind == "cloud":
        clouds = [tmake(p, capacity=cap, device="cpu") for p in host]
    elif kind == "mixed":      # clouds of two capacities beside an array
        clouds = [tmake(host[0], capacity=cap, device="cpu"), host[1],
                  tmake(host[2], capacity=cap + 64, device="cpu")]
    elif kind.startswith("cloud_int16") or kind == "mixed_int16":
        def raw16(p):
            pts = np.zeros((cap, 3), np.int16)
            pts[:len(p)] = p
            return Cloud(points=torch.from_numpy(pts),
                         mask=torch.arange(cap) < len(p))
        clouds = [raw16(p) for p in host]
        if kind == "mixed_int16":  # an int16 cloud beside float32 input
            clouds[1] = fine[1].astype(np.float32)
            clouds[2] = tmake(fine[2].astype(np.float32), capacity=cap,
                              device="cpu")
    else:
        clouds = host
    Ts = np.stack([_random_T(rng) for _ in range(B)])
    seeds = [3 + 5 * b for b in range(B)]
    cfg = FP.fleet_config(sensor_cap=cap, kf_cap=kcap)
    cfg = dataclasses.replace(cfg, localizer=dataclasses.replace(
        cfg.localizer, input_filters=chain,
        icp=dataclasses.replace(cfg.localizer.icp, reading_filters=rchain)))
    fleet = MultiAgentSlam(cfg, n_agents=B, device="cpu")

    # Each agent on its own: the cloud as make_cloud builds it, then
    # prepare_input under its seed and the reading chain.
    want, scale = [], []
    for b in range(B):
        c = clouds[b] if isinstance(clouds[b], Cloud) else tmake(
            clouds[b], capacity=cap, device="cpu")
        p = prepare_input(chain, kcap, c, torch.from_numpy(Ts[b]), seeds[b])
        want.append((p, TF.apply_chain(rchain, p)))
        # The size of the transform's terms: |R p| <= |p|_1, plus |t|_1.
        scale.append(float(dequantize_cloud(c).points.abs().sum(-1).max()
                           + np.abs(Ts[b][:3, 3]).sum()))
    eps = torch.finfo(torch.float32).eps

    def same(b, a, z):
        if case != "bmm_shape":
            return torch.equal(a, z)
        return bool(((a - z).abs() <= 4 * eps * scale[b]).all())
    if ragged:
        _ragged_chain(monkeypatch)
    raw, T_dev = fleet._upload_scans(clouds, Ts)
    prep = prepare_input_batched(chain, kcap, raw, T_dev, rchain, seeds)
    assert (prep.reading_batch is not None) == (not rchain)
    for b, (p, r) in enumerate(want):
        for w, got in ((p, prep.clouds[b]), (r, prep.readings[b])):
            assert same(b, w.points, got.points), b
            assert torch.equal(w.mask, got.mask), b
            assert w.descriptors.keys() == got.descriptors.keys()
            for k in w.descriptors:
                assert same(b, w.descriptors[k], got.descriptors[k]), k
    if prep.reading_batch is not None:
        for b in range(B):
            assert torch.equal(prep.reading_batch.points[b],
                               prep.readings[b].points)


def test_keyframes_do_not_alias_the_step_batch():
    """Two agents for 10 steps on the card test's scene: every keyframe's
    cloud is unchanged from its insertion to the end and holds no more
    storage than its own tensors (not the batch of the step that made
    it), and the tracer counts one route of the preparation a step (the
    batched one: both chains are empty)."""
    from torch.profiler import ProfilerActivity, profile
    from pgslam_tpu_torch.utils import timing
    scans, odom, _ = _corridor_12()
    fleet = MultiAgentSlam(FP.fleet_config(), n_agents=2, device="cpu")
    graph = fleet.get_graph()
    add_vertex = graph.add_vertex
    inserted = []

    def recorded(cloud, *a, **kw):
        inserted.append(cloud.map(lambda t: t.clone()))
        return add_vertex(cloud, *a, **kw)
    graph.add_vertex = recorded
    T_rs = np.eye(4, dtype=np.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(10):
            fleet.add_data_batch(i, "world", np.stack([odom[i], odom[i + 1]]),
                                 T_rs, [scans[i], scans[i + 1]])
    rec = timing.recording()
    assert rec.counters["steps"] == 10
    assert rec.counters["fleet.prepare.batched"] == 10
    assert rec.counters["fleet.prepare.per_agent"] == 0
    assert len(inserted) == graph.n_vertices >= 3
    for v, before in enumerate(inserted):
        now = graph.clouds[v]
        assert torch.equal(now.points, before.points), v
        assert torch.equal(now.mask, before.mask), v
        for t in (now.points, now.mask, *now.descriptors.values()):
            assert t.untyped_storage().nbytes() == t.nbytes, v
