"""The device-resident pose-graph mirror (``optim/resident.py``) on the
CPU: the port's resident optimizer against its own classic path, bit for
bit over multi-call sequences (the same solve on the same inputs; any
difference is a bookkeeping fault of the deltas), its rebuild and
invalidation rules, its fail-soft, the writeback packs against the JAX
package's, and the whole sequence against ``pgslam_tpu``'s resident
optimizer. Ported from ``tests/test_resident_pgo.py``; its five cases of
the sorted-RANGES routing and the layout hysteresis test TPU layout
machinery the port does not carry (``optim/resident.py``'s docstring)."""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgslam_tpu import se3 as jse3
from pgslam_tpu.cloud import make_cloud as jmake_cloud
from pgslam_tpu.graph.pose_graph import MapManager as JMapManager
from pgslam_tpu.optim import resident as jresident
from pgslam_tpu.optim.pgo import PGOConfig as JPGOConfig
from pgslam_tpu.optimizer import Optimizer as JOptimizer
from pgslam_tpu.optimizer import OptimizerConfig as JOptimizerConfig
from pgslam_tpu_torch import se3
from pgslam_tpu_torch.cloud import make_cloud
from pgslam_tpu_torch.graph.pose_graph import MapManager, PoseGraph
from pgslam_tpu_torch.optim import resident
from pgslam_tpu_torch.optim.lm import edge_csr, edge_csr_ptr_host
from pgslam_tpu_torch.optim.pgo import PGOConfig
from pgslam_tpu_torch.optimizer import Optimizer, OptimizerConfig
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_torch_pgo.py's limits for the port against the JAX LM.
POSE_TOL_M = 1e-4
ROT_TOL = 1e-4
COST_RTOL, COST_ATOL = 1e-3, 1e-6
COV = np.eye(6, dtype=np.float32) * 0.01


class _NoLC:
    def add_new_vertex(self, v):
        pass


def _keyframe(mm, poses, cloud, x, y=0.0):
    """Append a keyframe at (x, y) with its odometry edge."""
    Tn = np.eye(4, dtype=np.float32)
    Tn[0, 3], Tn[1, 3] = x, y
    dT = (np.linalg.inv(poses[-1]) @ Tn).astype(np.float32)
    mm.add_new_keyframe(len(poses) - 1, Tn, dT, COV, cloud)
    poses.append(Tn)


def _chain_world(mm, n, rng, cloud_fn=None):
    """``tests/test_resident_pgo.py::_chain_world``: an n-keyframe
    odometry chain; returns the true poses."""
    cloud_fn = cloud_fn or (lambda p: make_cloud(p, device="cpu"))
    cloud = cloud_fn(rng.uniform(-1, 1, (16, 3)).astype(np.float32))
    T = np.eye(4, dtype=np.float32)
    mm.set_loop_closer(_NoLC())
    mm.add_first_keyframe(cloud, T)
    poses = [T]
    for i in range(1, n):
        _keyframe(mm, poses, cloud, i * 1.0, 0.05 * np.sin(i))
    return poses


def _closure(poses, a, b, jitter=0.001):
    T = (np.linalg.inv(poses[a]) @ poses[b]).astype(np.float32)
    return T + jitter


def _optimizer(mm, resident_mode, cfg=None, jax=False):
    cfg = cfg or (JOptimizerConfig() if jax else OptimizerConfig())
    cfg = dataclasses.replace(cfg, resident=resident_mode)
    return JOptimizer(mm, cfg) if jax else Optimizer(mm, cfg, device="cpu")


def _run_sequence(resident_mode, n=40, closures=((5, 35), (2, 30), (1, 20)),
                  opt_cfg=None, grow_after=None, dirty_after=None,
                  jax=False):
    """``tests/test_resident_pgo.py::_run_sequence`` on either package:
    several optimizes with the graph growing and a host pose write
    between them. Returns the poses and stats after every optimize, and
    the optimizer."""
    rng = np.random.default_rng(0)
    mm = JMapManager() if jax else MapManager()
    opt = _optimizer(mm, resident_mode, opt_cfg, jax)
    cloud_fn = jmake_cloud if jax else None
    poses = _chain_world(mm, n, rng, cloud_fn)
    history = []
    for k, (a, b) in enumerate(closures):
        opt.add_new_data(a, b, _closure(poses, a, b, 0.001 * (k + 1)), COV)
        g = mm.get_graph()
        history.append((g.optimized_poses[:g.n_vertices].copy(),
                        dict(opt.last_stats)))
        if grow_after is not None and k == 0:
            cloud_pts = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
            cloud = (jmake_cloud if jax
                     else lambda p: make_cloud(p, device="cpu"))(cloud_pts)
            for _ in range(grow_after):
                _keyframe(mm, poses, cloud, len(poses) * 1.0)
        if dirty_after is not None and k == 0:
            T = mm.get_graph().optimized_poses[dirty_after].copy()
            T[0, 3] += 0.05
            mm.update_keyframe_transform(dirty_after, T, mm.now())
    return history, opt


def _assert_bit_equal(classic, res):
    assert len(classic) == len(res)
    for (pc, sc), (pr, sr) in zip(classic, res):
        np.testing.assert_array_equal(pc, pr)
        for key in resident.STATS:
            assert sc[key] == sr[key], key


def test_resident_is_the_default():
    assert OptimizerConfig().resident == JOptimizerConfig().resident == "auto"
    assert OptimizerConfig().writeback_pack == "auto"
    _, opt = _run_sequence("auto", closures=((5, 35),))
    assert opt._mirror is not None and opt._mirror._st is not None


def test_resident_matches_classic_bitwise():
    classic, _ = _run_sequence("off")
    res, opt = _run_sequence("auto")
    _assert_bit_equal(classic, res)
    assert opt._mirror.last_download_bytes > 0


def test_resident_matches_classic_with_growth_and_dirty():
    classic, _ = _run_sequence("off", grow_after=10, dirty_after=3)
    res, opt = _run_sequence("auto", grow_after=10, dirty_after=3)
    _assert_bit_equal(classic, res)
    # The growth and the host write went up as deltas, not a rebuild.
    assert opt._mirror.last_upload_bytes < opt._mirror.last_rebuild_bytes


@pytest.mark.parametrize("robust", ["huber", "cauchy"])
def test_resident_matches_classic_with_a_robust_kernel(robust):
    cfg = OptimizerConfig(pgo=PGOConfig(robust=robust, max_iterations=10))
    classic, _ = _run_sequence("off", opt_cfg=cfg, grow_after=5)
    res, _ = _run_sequence("auto", opt_cfg=cfg, grow_after=5)
    _assert_bit_equal(classic, res)


def test_resident_bucket_growth_rebuilds():
    # 40 -> 110 vertices crosses the 64 bucket: the V and E buckets grow,
    # the mirror rebuilds mid-sequence, and the bits stay the classic's.
    kw = dict(grow_after=70, closures=((5, 35), (2, 30), (1, 90)))
    classic, _ = _run_sequence("off", **kw)
    res, opt = _run_sequence("auto", **kw)
    _assert_bit_equal(classic, res)
    assert opt._mirror._st["V"] >= 128


def test_resident_delta_bytes_small():
    """The steady delta upload is a small part of a rebuild's."""
    _, opt = _run_sequence("auto")
    m = opt._mirror
    assert m.last_rebuild_bytes > 0
    assert m.last_upload_bytes < m.last_rebuild_bytes / 4, \
        (m.last_upload_bytes, m.last_rebuild_bytes)


def test_kill_switch_restores_the_classic_path(monkeypatch):
    monkeypatch.setenv("PGSLAM_PGO_RESIDENT", "0")
    hist, opt = _run_sequence("auto")
    assert opt._mirror is None
    monkeypatch.delenv("PGSLAM_PGO_RESIDENT")
    _assert_bit_equal(_run_sequence("off")[0], hist)


def test_restore_invalidates_mirror(tmp_path):
    from pgslam_tpu_torch.io import load_checkpoint, save_checkpoint
    rng = np.random.default_rng(1)
    mm = MapManager()
    opt = _optimizer(mm, "auto")
    poses = _chain_world(mm, 20, rng)
    opt.add_new_data(2, 15, _closure(poses, 2, 15), COV)
    st_before = opt._mirror._st
    assert st_before is not None
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, mm)
    load_checkpoint(path, mm, device="cpu")
    assert mm.get_graph().mutation_epoch == 1
    opt.add_new_data(1, 18, _closure(poses, 1, 18), COV)
    assert opt._mirror._st is not st_before
    mm2 = MapManager()
    opt2 = _optimizer(mm2, "off")
    poses2 = _chain_world(mm2, 20, np.random.default_rng(1))
    opt2.add_new_data(2, 15, _closure(poses2, 2, 15), COV)
    opt2.add_new_data(1, 18, _closure(poses2, 1, 18), COV)
    g, g2 = mm.get_graph(), mm2.get_graph()
    np.testing.assert_array_equal(g.optimized_poses[:g.n_vertices],
                                  g2.optimized_poses[:g2.n_vertices])


def test_mt_interleave_invalidates():
    """An edge appended between the prepare and the pending insert (the
    MT optimizer's unlocked solve) shifts the graph's edge slots off the
    mirror's: confirm_inserts invalidates, the next call rebuilds."""
    rng = np.random.default_rng(2)
    mm = MapManager()
    opt = _optimizer(mm, "auto")
    poses = _chain_world(mm, 20, rng)
    opt.add_new_data(2, 15, _closure(poses, 2, 15), COV)
    assert opt._mirror._st is not None
    prep = opt.prepare_for_optimization_resident()
    new_poses, _ = opt._mirror.execute(prep)
    cloud = make_cloud(rng.uniform(-1, 1, (16, 3)).astype(np.float32),
                       device="cpu")
    _keyframe(mm, poses, cloud, 99.0)
    opt.data_buffer = [(1, 10, _closure(poses, 1, 10), COV)]
    opt.update_after_optimization(new_poses)
    assert opt._mirror._st is None


def test_failed_insert_invalidates():
    """A loop edge whose insert raises (the graph refuses a duplicate)
    leaves the graph short of the mirror's slots: the mirror is dropped,
    and the next optimize agrees with a classic run of what the graph
    holds."""
    rng = np.random.default_rng(3)
    mm = MapManager()
    opt = _optimizer(mm, "auto")
    poses = _chain_world(mm, 20, rng)
    opt.queue_mode = True
    opt.add_new_data(2, 15, _closure(poses, 2, 15), COV)
    opt.add_new_data(3, 4, _closure(poses, 3, 4), COV)   # odometry pair
    with pytest.raises(ValueError):
        opt.process_pending()
    assert opt._mirror._st is None
    opt.queue_mode = False
    opt.add_new_data(1, 18, _closure(poses, 1, 18), COV)
    assert opt._mirror._st is not None
    assert opt._mirror._st["ne"] == mm.get_graph().n_edges


def test_resident_failure_falls_back_to_classic(monkeypatch, caplog):
    """A failure inside the resident execute invalidates the mirror and
    runs the batch through the classic path (with a warning); the next
    optimize rebuilds a mirror, and the bits are a classic run's."""
    rng = np.random.default_rng(5)
    mm = MapManager()
    opt = _optimizer(mm, "auto")
    poses = _chain_world(mm, 20, rng)
    calls = {"n": 0}
    orig = resident.ResidentPGO.execute

    def flaky(self, prep):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("synthetic device failure")
        return orig(self, prep)

    monkeypatch.setattr(resident.ResidentPGO, "execute", flaky)
    with caplog.at_level(logging.WARNING, "pgslam_tpu_torch.optimizer"):
        opt.add_new_data(2, 15, _closure(poses, 2, 15), COV)
    assert "falling back to the classic path" in caplog.text
    assert opt.last_stats is not None
    assert opt._mirror._st is None
    opt.add_new_data(1, 18, _closure(poses, 1, 18), COV)
    assert opt._mirror._st is not None
    mm2 = MapManager()
    opt2 = _optimizer(mm2, "off")
    poses2 = _chain_world(mm2, 20, np.random.default_rng(5))
    opt2.add_new_data(2, 15, _closure(poses2, 2, 15), COV)
    opt2.add_new_data(1, 18, _closure(poses2, 1, 18), COV)
    g, g2 = mm.get_graph(), mm2.get_graph()
    np.testing.assert_array_equal(g.optimized_poses[:g.n_vertices],
                                  g2.optimized_poses[:g2.n_vertices])


def test_prepare_failure_falls_back_to_classic(monkeypatch):
    """A host-side error in the prepare takes the same fail-soft road."""
    rng = np.random.default_rng(7)
    mm = MapManager()
    opt = _optimizer(mm, "auto")
    poses = _chain_world(mm, 20, rng)
    calls = {"n": 0}
    orig = resident.ResidentPGO.prepare

    def flaky(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise IndexError("synthetic host bookkeeping error")
        return orig(self, *a, **kw)

    monkeypatch.setattr(resident.ResidentPGO, "prepare", flaky)
    opt.add_new_data(2, 15, _closure(poses, 2, 15), COV)
    assert opt.last_stats is not None
    assert opt._mirror._st is None
    opt.add_new_data(1, 18, _closure(poses, 1, 18), COV)
    assert opt._mirror._st is not None
    mm2 = MapManager()
    opt2 = _optimizer(mm2, "off")
    poses2 = _chain_world(mm2, 20, np.random.default_rng(7))
    opt2.add_new_data(2, 15, _closure(poses2, 2, 15), COV)
    opt2.add_new_data(1, 18, _closure(poses2, 1, 18), COV)
    g, g2 = mm.get_graph(), mm2.get_graph()
    np.testing.assert_array_equal(g.optimized_poses[:g.n_vertices],
                                  g2.optimized_poses[:g2.n_vertices])


def test_graph_token_survives_id_reuse():
    g1 = PoseGraph()
    t1 = resident._graph_token(g1)
    assert resident._graph_token(g1) == t1
    g2 = PoseGraph()
    assert resident._graph_token(g2) != t1
    g1.mutation_epoch = g2.mutation_epoch = 1
    assert resident._graph_token(g1) != resident._graph_token(g2)


def test_double_restore_rebuilds_each_time(tmp_path):
    """Both restored graphs sit at epoch 1; only their tokens separate
    them, and the mirror rebuilds after each."""
    from pgslam_tpu_torch.io import load_checkpoint, save_checkpoint
    rng = np.random.default_rng(11)
    mm = MapManager()
    opt = _optimizer(mm, "auto")
    poses = _chain_world(mm, 16, rng)
    opt.add_new_data(2, 12, _closure(poses, 2, 12), COV)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, mm)
    for a, b in ((1, 14), (3, 10)):
        load_checkpoint(path, mm, device="cpu")
        st = opt._mirror._st
        opt.add_new_data(a, b, _closure(poses, a, b), COV)
        assert opt._mirror._st is not st
        assert opt._mirror._st["graph_id"] == \
            mm.get_graph()._resident_mirror_token


def test_cpu_mirror_shares_no_memory_with_the_graph():
    """On the CPU a tensor can alias a numpy array: the mirror's tensors
    must be copies, or a later host write to the graph would reach the
    device copy unannounced."""
    rng = np.random.default_rng(13)
    mm = MapManager()
    opt = _optimizer(mm, "auto")
    poses = _chain_world(mm, 20, rng)
    opt.add_new_data(2, 15, _closure(poses, 2, 15), COV)
    st = opt._mirror._st
    before = {k: st[k].clone() for k in ("poses", "eT", "ec", "ef")}
    g = mm.get_graph()
    g.optimized_poses[:g.n_vertices] += 1.0
    g.edge_T[:g.n_edges] += 1.0
    g.edge_cov[:g.n_edges] += 1.0
    g.edge_from[:g.n_edges] += 1
    for k, v in before.items():
        assert torch.equal(st[k], v), k


def test_quat7_pack_roundtrip():
    rng = np.random.default_rng(3)
    w = torch.as_tensor(rng.normal(0, 1, (32, 3)), dtype=torch.float32)
    t = torch.as_tensor(rng.normal(0, 10, (32, 3)), dtype=torch.float32)
    T = se3.make(se3.exp_so3(w), t)
    back = resident._unpack_poses_host(
        resident._pack_poses(T, "quat7").numpy(), 32, "quat7")
    Tn = T.numpy()
    np.testing.assert_array_equal(back[:, :3, 3], Tn[:, :3, 3])
    np.testing.assert_allclose(back[:, :3, :3], Tn[:, :3, :3], atol=1e-6)
    p12 = resident._pack_poses(T, "exact12").numpy()
    np.testing.assert_array_equal(
        resident._unpack_poses_host(p12, 32, "exact12"), Tn)


@pytest.mark.parametrize("pack", ["exact12", "quat7"])
def test_packers_match_pgslam_tpu(pack):
    """The packs against the JAX mirror's on the same matrices: exact12
    bit-equal, quat7 within 1e-6."""
    rng = np.random.default_rng(17)
    w = rng.normal(0, 1, (64, 3)).astype(np.float32)
    t = rng.normal(0, 10, (64, 3)).astype(np.float32)
    T = np.array(jse3.make(jse3.exp_so3(jnp.asarray(w)), jnp.asarray(t)))
    theirs = np.asarray(jresident._pack_poses(jnp.asarray(T), pack))
    ours = resident._pack_poses(torch.from_numpy(T), pack).numpy()
    back_theirs = jresident._unpack_poses_host(theirs, 64, pack)
    back_ours = resident._unpack_poses_host(ours, 64, pack)
    if pack == "exact12":
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(back_ours, back_theirs)
    else:
        np.testing.assert_allclose(ours, theirs, atol=1e-6)
        np.testing.assert_allclose(back_ours, back_theirs, atol=1e-6)
        # The host unpack is the same arithmetic on equal input.
        np.testing.assert_array_equal(
            resident._unpack_poses_host(theirs, 64, pack), back_theirs)


def test_pack_auto_takes_quat7_from_quat_min_v():
    m = resident.ResidentPGO(PGOConfig(), pack="auto", device="cpu")
    g = PoseGraph(initial_vertex_capacity=resident.QUAT_MIN_V)
    g.n_vertices = resident.QUAT_MIN_V // 2     # V = QUAT_MIN_V / 2
    assert m.prepare(g, 0, []).pack == "exact12"
    g.n_vertices = resident.QUAT_MIN_V // 2 + 1  # V = QUAT_MIN_V
    assert m.prepare(g, 0, []).pack == "quat7"
    with pytest.raises(ValueError):
        resident.ResidentPGO(PGOConfig(), pack="quat8", device="cpu")


@pytest.mark.parametrize("V,E,seed", [(8, 12, 0), (64, 96, 1),
                                      (300, 700, 2)])
def test_edge_csr_ptr_host_matches_edge_csr(V, E, seed):
    """The host ptr equals edge_csr's on random graphs whose padding is
    masked off (ends out of range are clamped, as the kernels clamp)."""
    rng = np.random.default_rng(seed)
    ef = rng.integers(-2, V + 2, E).astype(np.int32)
    et = rng.integers(0, V, E).astype(np.int32)
    emask = np.arange(E) < E - E // 4
    ef[~emask], et[~emask] = 0, 0
    for m in (None, emask):
        ptr, _ = edge_csr(torch.from_numpy(ef), torch.from_numpy(et), V,
                          None if m is None else torch.from_numpy(m))
        host = edge_csr_ptr_host(ef, et, V, m)
        assert host.dtype == np.int32 and host.shape == (V + 1,)
        np.testing.assert_array_equal(ptr.numpy(), host)
        ptr2, _ = edge_csr(torch.from_numpy(ef), torch.from_numpy(et), V,
                           None if m is None else torch.from_numpy(m),
                           ptr_host=host)
        assert torch.equal(ptr, ptr2)


@pytest.mark.parametrize("kw", [
    {}, {"grow_after": 10, "dirty_after": 3},
    {"grow_after": 70, "closures": ((5, 35), (2, 30), (1, 90))}],
    ids=["three_calls", "growth_and_dirty", "bucket_growth"])
def test_resident_matches_pgslam_tpu_resident(kw):
    """The same seeded sequence through ``pgslam_tpu``'s Optimizer
    (resident "auto", the CPU) and the port's, under
    tests/test_torch_pgo.py's LM settings and limits: poses after every
    call within 1e-4 m and 1e-4 rad, equal LM iterations, costs within
    rtol 1e-3 plus atol 1e-6. (Under the default PGOConfig the
    sequence's second optimize ends in fp32 stagnation in both packages,
    at the 50-iteration cap or near it, and two such ends of the same
    problem lie ~7e-4 m apart whatever the path; that is the LM's, not
    the mirror's, which gives the classic path's bits.)"""
    lm = dict(max_iterations=4, cg_iterations=16, cg_tol=1e-3)
    theirs, jopt = _run_sequence(
        "auto", jax=True, opt_cfg=JOptimizerConfig(pgo=JPGOConfig(**lm)),
        **kw)
    ours, opt = _run_sequence(
        "auto", opt_cfg=OptimizerConfig(pgo=PGOConfig(**lm)), **kw)
    assert jopt._mirror is not None and opt._mirror is not None
    assert len(theirs) == len(ours) == len(kw.get("closures", "abc"))
    for (pj, sj), (pt, st) in zip(theirs, ours):
        assert np.abs(pj[:, :3, 3] - pt[:, :3, 3]).max() <= POSE_TOL_M
        assert np.abs(pj[:, :3, :3] - pt[:, :3, :3]).max() <= ROT_TOL
        assert sj["iterations"] == st["iterations"]
        for key in ("initial_cost", "final_cost"):
            assert abs(sj[key] - st[key]) <= COST_ATOL \
                + COST_RTOL * abs(sj[key]), (key, sj[key], st[key])
