"""The port's multi-device layer against pgslam_tpu on the same numpy
inputs: JAX on its 8 virtual CPU devices (tests/conftest.py), the port
on a mesh of CPU positions (``devices=["cpu"] * 8``). ``make_mesh``, the
merged match over tp shards, ``sharded_icp_step`` under both merges,
``make_sharded_register``, ``multichip_slam_step``, ``shard_batch`` and
``dryrun_multichip``. On the card: tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgslam_tpu import se3 as jse3
from pgslam_tpu.cloud import make_cloud as jmake
from pgslam_tpu.cloud import stack_clouds as jstack
from pgslam_tpu.ops import minimizer as JM
from pgslam_tpu.ops import outlier as JO
from pgslam_tpu.ops.filters import compute_normals as j_normals
from pgslam_tpu.ops.icp import ICPConfig as JICPConfig
from pgslam_tpu.ops.knn import Matches as JMatches
from pgslam_tpu.optim.pgo import PGOConfig as JPGOConfig
from pgslam_tpu.parallel import multichip as JMC
from pgslam_tpu.parallel.sharded_icp import \
    make_sharded_register as j_sharded_register
from pgslam_tpu_torch import se3 as tse3
from pgslam_tpu_torch.cloud import make_cloud as tmake
from pgslam_tpu_torch.cloud import stack_clouds as tstack
from pgslam_tpu_torch.ops import outlier as TO
from pgslam_tpu_torch.ops.icp import ICPConfig as TICPConfig
from pgslam_tpu_torch.ops.icp import eps_dead_zone
from pgslam_tpu_torch.ops.icp import icp_core as t_icp_core
from pgslam_tpu_torch.ops.knn import knn_plain
from pgslam_tpu_torch.optim.pgo import PGOConfig as TPGOConfig
from pgslam_tpu_torch.parallel import multichip as MC
from pgslam_tpu_torch.parallel.batched import shard_batch
from pgslam_tpu_torch.parallel.sharded_icp import make_sharded_register

from test_torch_icp import T_TOL
from torch_threads import one_torch_thread  # noqa: F401

CPU8 = ["cpu"] * 8
RESIDUAL_RTOL = 1e-3   # test_torch_icp.py's residual rtol
COV_RTOL = 1e-3        # test_torch_icp.py's covariance rtol, atol 1e-4 max
K3_POSE_TOL_M = 1e-4   # chip_smoke.py's K3_POSE_TOL_M


def _t(a):
    return torch.from_numpy(np.array(a))


def _twist_gap(T_port, T_jax):
    return float(tse3.log(tse3.inverse(T_port) @ _t(T_jax)).norm())


# -- make_mesh (tests/test_parallel.py:169-187) ------------------------------

@pytest.mark.parametrize("n, tp, slices", [(8, 2, 1), (8, 2, 2), (8, 4, 1),
                                           (8, 8, 1), (8, 1, 1), (6, 4, 1),
                                           (2, 4, 1)])
def test_make_mesh_matches_jax(n, tp, slices):
    """The same dp x tp shape and the same position of each device: JAX's
    device ids against the indices of the listed devices."""
    ours = MC.make_mesh(n, tp=tp, slices=slices,
                        devices=[torch.device("cuda", i) for i in range(8)])
    theirs = JMC.make_mesh(n, tp=tp, slices=slices)
    assert ours.shape == dict(theirs.shape)
    assert ours.shape.get("tp", 1) == theirs.shape["tp"]
    ids = np.vectorize(lambda d: d.id)(theirs.devices)
    np.testing.assert_array_equal(
        np.vectorize(lambda d: d.index)(ours.devices), ids)


@pytest.mark.parametrize("n, tp, slices", [(8, 8, 2), (8, 2, 3), (8, 2, 0)])
def test_make_mesh_slice_errors_match_jax(n, tp, slices):
    with pytest.raises(ValueError) as theirs:
        JMC.make_mesh(n, tp=tp, slices=slices)
    with pytest.raises(ValueError) as ours:
        MC.make_mesh(n, tp=tp, slices=slices, devices=CPU8)
    assert str(ours.value) == str(theirs.value)


def test_make_mesh_never_shrinks():
    """Without enough devices make_mesh raises and names devices=; it
    does not build a smaller mesh or move to the CPU."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 8:
        pytest.skip("this machine has 8 cards")
    with pytest.raises(ValueError, match="devices="):
        MC.make_mesh(8, tp=2)
    with pytest.raises(ValueError):
        MC.make_mesh(8, tp=2, devices=["cpu"] * 4)
    mesh = MC.make_mesh(8, tp=2, devices=CPU8)
    assert mesh.devices.shape == (4, 2) and mesh.first == torch.device("cpu")


# -- the merged match ---------------------------------------------------------

def _match_inputs(seed, nq, nr, tp):
    """Scan-like points on a coarse lattice (many equal distances), every
    shard's first points repeated in the next shard (ties across shards),
    masked references in every shard and masked queries."""
    rng = np.random.default_rng(seed)
    r = np.round(rng.uniform(-4, 4, (nr, 3)) * 2) / 2
    m = nr // tp
    for j in range(1, tp):
        r[j * m:j * m + m // 4] = r[(j - 1) * m:(j - 1) * m + m // 4]
    q = np.round(rng.uniform(-4, 4, (nq, 3)) * 4) / 4
    rm = rng.uniform(size=nr) > 0.2
    rm[m - 8:m] = False
    qm = rng.uniform(size=nq) > 0.1
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return (as_t(q), torch.as_tensor(qm), as_t(r), torch.as_tensor(rm))


def _shards(r, rm, tp, nrm=None):
    m = r.shape[0] // tp
    return [(r[j * m:(j + 1) * m], rm[j * m:(j + 1) * m],
             None if nrm is None else nrm[j * m:(j + 1) * m])
            for j in range(tp)]


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 8])
def test_merged_match_bit_equal_to_whole(tp, k):
    """The merged candidate sets of tp shards against the plain K1 over
    the whole reference: ids and d2 bit for bit, the candidate points
    the whole reference's at those ids."""
    q, qm, r, rm = _match_inputs(tp * 10 + k, 300, 960, tp)
    # a query with fewer valid references than k in its reach: all masked
    rm_sparse = rm.clone()
    rm_sparse[5:] = False
    cpu = torch.device("cpu")
    for ref_mask in (rm, rm_sparse):
        whole = knn_plain(q, qm, r, ref_mask, k=k)
        got, pts, _ = MC.shard_match(q, qm, _shards(r, ref_mask, tp), k, cpu)
        assert torch.equal(got.ids, whole.ids)
        assert torch.equal(got.dists2, whole.dists2)
        assert torch.equal(pts, r[whole.ids.long()])


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_ring_match_equals_all_gather(tp):
    q, qm, r, rm = _match_inputs(tp, 256, 512, tp)
    qm[:] = True       # the ring keeps zeros where nothing matches
    cpu = torch.device("cpu")
    mt, pts, _ = MC.shard_match(q, qm, _shards(r, rm, tp), 1, cpu)
    d, i, p = MC.ring_match(q, qm, _shards(r, rm, tp), cpu)
    assert torch.equal(d, mt.dists2) and torch.equal(i, mt.ids)
    assert torch.equal(p, pts)


def test_merged_match_carries_normals():
    q, qm, r, rm = _match_inputs(3, 128, 256, 4)
    nrm = np.random.default_rng(0).normal(size=(256, 3))
    nrm = torch.as_tensor(nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
                          dtype=torch.float32)
    whole = knn_plain(q, qm, r, rm, k=3)
    _, _, n = MC.shard_match(q, qm, _shards(r, rm, 4, nrm), 3,
                             torch.device("cpu"), normals=True)
    assert torch.equal(n, nrm[whole.ids.long()])


# -- sharded_icp_step (tests/test_parallel.py:67-117) -------------------------

def _step_inputs(noise=0.0):
    """test_parallel.py:67-117's inputs: each reading the first N points
    of its reference moved by 0.05 m on every axis, plus ``noise``."""
    rng = np.random.default_rng(42)
    B, N, M = 8, 64, 256
    ref = rng.uniform(-3, 3, size=(B, M, 3)).astype(np.float32)
    reading = ref[:, :N] + 0.05
    if noise:
        reading += rng.normal(0, noise, reading.shape).astype(np.float32)
    return reading, np.ones((B, N), bool), ref, np.ones((B, M), bool)


@pytest.mark.parametrize("merge", ["all_gather", "ring"])
@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_sharded_icp_step_matches_jax(merge, noise):
    """T within T_TOL of JAX's step. The overlaps: with noise, within
    1/N of JAX's. Without (the JAX test's own inputs), every matched
    distance is 0.0075 up to rounding, so TrimmedDist's threshold keeps
    a number of exact ties that follows the last bits of d2, which the
    XLA dot and K1's formula round differently (tests/test_parallel.py
    and test_sharded_register_matches_vmapped say so of the JAX package's
    own paths); there each overlap must be what the JAX package's
    weights give on the port's own merged distances."""
    reading, rmask, ref, fmask = _step_inputs(noise)
    B, N = reading.shape[:2]
    T0 = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    jout = (JO.TrimmedDist(0.9), JO.MaxDist(1.0))
    Tj, ovj = JMC.sharded_icp_step(JMC.make_mesh(8, tp=2),
                                   JICPConfig(outlier=jout), merge=merge)(
        jnp.asarray(reading), jnp.asarray(rmask), jnp.asarray(ref),
        jnp.asarray(fmask), jnp.asarray(T0))
    tcfg = TICPConfig(outlier=(TO.TrimmedDist(0.9), TO.MaxDist(1.0)))
    mesh = MC.make_mesh(8, tp=2, devices=CPU8)
    Tt, ovt = MC.sharded_icp_step(mesh, tcfg, merge=merge)(
        _t(reading), _t(rmask), _t(ref), _t(fmask), _t(T0))
    assert Tt.shape == (B, 4, 4)
    for b in range(B):
        assert _twist_gap(Tt[b], np.asarray(Tj[b])) < T_TOL
    if noise:
        np.testing.assert_allclose(ovt.numpy(), np.asarray(ovj),
                                   atol=1.0 / N)
        return
    cpu = torch.device("cpu")
    for b in range(B):
        mt, _, _ = MC.shard_match(_t(reading[b]), _t(rmask[b]),
                                  _shards(_t(ref[b]), _t(fmask[b]), 2), 1,
                                  cpu)
        w = JO.compute_weights(jout, JMatches(
            dists2=jnp.asarray(mt.dists2.numpy()),
            ids=jnp.asarray(mt.ids.numpy())), jnp.asarray(rmask[b]))
        assert float(ovt[b]) == float(JM.overlap(w, jnp.int32(N)))


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_icp_step_ring_bit_equal_to_all_gather(tp):
    reading, rmask, ref, fmask = _step_inputs()
    mesh = MC.make_mesh(8, tp=tp, devices=CPU8)
    cfg = TICPConfig(outlier=(TO.TrimmedDist(0.9), TO.MaxDist(1.0)))
    args = (_t(reading), _t(rmask), _t(ref), _t(fmask),
            torch.eye(4).repeat(8, 1, 1))
    Ta, ova = MC.sharded_icp_step(mesh, cfg, "all_gather")(*args)
    Tr, ovr = MC.sharded_icp_step(mesh, cfg, "ring")(*args)
    assert torch.equal(Ta, Tr) and torch.equal(ova, ovr)
    with pytest.raises(ValueError):
        MC.sharded_icp_step(mesh, cfg, "tree")


# -- make_sharded_register (tests/test_parallel.py:120-166) -------------------

def _register_inputs(B=4, N=128, Mref=512, seed=42):
    """test_parallel.py::test_sharded_register_matches_vmapped's scene:
    wavy surfaces with 8-NN normals (computed once, by the JAX package,
    so both sides get the same arrays), noisy reading subsets moved by
    small twists."""
    rng = np.random.default_rng(seed)
    twists = rng.normal(size=(B, 6)).astype(np.float32) * 0.03
    refs, nrms, readings = [], [], []
    for b in range(B):
        pts = rng.uniform(-3, 3, size=(Mref, 3)).astype(np.float32)
        pts[:, 2] = 0.3 * np.sin(pts[:, 0]) + 0.2 * np.cos(1.3 * pts[:, 1])
        ref = j_normals(jmake(pts, capacity=Mref), knn=8)
        refs.append(pts)
        nrms.append(np.asarray(ref.descriptors["normals"]))
        T = jse3.exp(jnp.asarray(twists[b]))
        noisy = pts[:N] + rng.normal(0, 0.02, (N, 3)).astype(np.float32)
        readings.append(np.asarray(jse3.apply(jse3.inverse(T),
                                              jnp.asarray(noisy))))
    return np.stack(readings), np.stack(refs), np.stack(nrms), twists


def _clouds(readings, refs, nrms):
    B, N = readings.shape[:2]
    Mref = refs.shape[1]
    jr = jstack([jmake(readings[b], capacity=N) for b in range(B)])
    jf = jstack([jmake(refs[b], capacity=Mref,
                       descriptors={"normals": nrms[b]}) for b in range(B)])
    tr = tstack([tmake(readings[b], capacity=N) for b in range(B)])
    tf = tstack([tmake(refs[b], capacity=Mref,
                       descriptors={"normals": nrms[b]}) for b in range(B)])
    return jr, jf, tr, tf


def _register_cfgs(error):
    kw = dict(error=error, max_iterations=20)
    return (JICPConfig(outlier=(JO.TrimmedDist(0.9), JO.MaxDist(1.0)), **kw),
            TICPConfig(outlier=(TO.TrimmedDist(0.9), TO.MaxDist(1.0)), **kw))


@pytest.mark.parametrize("n, tp", [(8, 2), (8, 4)])
def test_sharded_register_matches_jax(n, tp):
    """dp = 4 x tp = 2 (the JAX test's mesh) and dp = 2 x tp = 4, B = 4:
    T within T_TOL, iterations and flags equal (the config clears
    eps_dead_zone), overlap within 1/N, residual and covariance to
    test_torch_icp.py's rtol."""
    readings, refs, nrms, twists = _register_inputs()
    B, N = readings.shape[:2]
    jcfg, tcfg = _register_cfgs("point_to_plane")
    assert eps_dead_zone(tcfg) is None
    jr, jf, tr, tf = _clouds(readings, refs, nrms)
    T0 = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    rj = jax.device_get(j_sharded_register(JMC.make_mesh(n, tp=tp), jcfg)(
        jr, jf, jnp.asarray(T0)))
    rt = make_sharded_register(MC.make_mesh(n, tp=tp, devices=CPU8), tcfg)(
        tr, tf, _t(T0))
    for b in range(B):
        assert _twist_gap(rt.T[b], rj.T[b]) < T_TOL, b
        err = tse3.log(tse3.inverse(rt.T[b]) @ tse3.exp(_t(twists[b])))
        assert float(err.norm()) < 3e-2
    for name in ("iterations", "converged", "max_iter_reached", "diverged"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)), name)
    np.testing.assert_allclose(rt.overlap.numpy(), np.asarray(rj.overlap),
                               atol=1.0 / N)
    np.testing.assert_allclose(rt.residual.numpy(), np.asarray(rj.residual),
                               rtol=RESIDUAL_RTOL)
    cj = np.asarray(rj.cov)
    np.testing.assert_allclose(rt.cov.numpy(), cj, rtol=COV_RTOL,
                               atol=1e-4 * np.abs(cj).max())


@pytest.mark.parametrize("error, k, n, tp", [
    ("point_to_plane", 1, 8, 2), ("point_to_point", 1, 8, 2),
    ("point_to_point", 4, 8, 8), ("point_to_plane", 3, 4, 4)])
def test_sharded_register_b1_bit_equal_to_icp_core(error, k, n, tp):
    """One agent a dp group: each agent's result equals the port's own
    icp_core on its pair, every field bit for bit."""
    readings, refs, nrms, _ = _register_inputs()
    B = n // tp
    readings, refs, nrms = readings[:B], refs[:B], nrms[:B]
    _, tcfg = _register_cfgs(error)
    tcfg = TICPConfig(**{**vars(tcfg), "knn": k})
    _, _, tr, tf = _clouds(readings, refs, nrms)
    # masked reading and reference points
    tr.mask[:, -5:] = False
    tf.mask[:, ::7] = False
    T0 = tse3.exp(_t(np.full((B, 6), 0.01, np.float32)))
    rt = make_sharded_register(MC.make_mesh(n, tp=tp, devices=CPU8), tcfg)(
        tr, tf, T0)
    for b in range(B):
        one = t_icp_core(tr.map(lambda a: a[b]), tf.map(lambda a: a[b]),
                         T0[b], tcfg)
        for name, v in vars(one).items():
            assert torch.equal(getattr(rt, name)[b], v), (b, name)


def test_sharded_register_raises_where_shard_map_would():
    readings, refs, nrms, _ = _register_inputs(B=2, Mref=510)
    _, tcfg = _register_cfgs("point_to_plane")
    _, _, tr, tf = _clouds(readings, refs, nrms)
    reg = make_sharded_register(MC.make_mesh(8, tp=2, devices=CPU8), tcfg)
    with pytest.raises(ValueError, match="dp=4"):
        reg(tr, tf, torch.eye(4).repeat(2, 1, 1))
    reg = make_sharded_register(MC.make_mesh(8, tp=4, devices=CPU8), tcfg)
    with pytest.raises(ValueError, match="tp=4"):
        reg(tr, tf, torch.eye(4).repeat(2, 1, 1))


# -- shard_batch ---------------------------------------------------------------

def test_shard_batch_splits_the_leading_axis():
    mesh = MC.make_mesh(8, tp=2, devices=CPU8)
    readings, refs, nrms, _ = _register_inputs()
    _, _, tr, tf = _clouds(readings, refs, nrms)
    T0 = torch.eye(4).repeat(4, 1, 1)
    chunks = shard_batch(mesh)((tr, tf, T0, torch.tensor(3)))
    assert len(chunks) == 4
    for i, (r, f, t, s) in enumerate(chunks):
        assert torch.equal(r.points, tr.points[i:i + 1])
        assert torch.equal(f.descriptors["normals"],
                           tf.descriptors["normals"][i:i + 1])
        assert t.shape == (1, 4, 4) and int(s) == 3
    assert len(shard_batch(mesh, "tp")(T0)) == 2
    with pytest.raises(ValueError):
        shard_batch(MC.make_mesh(8, tp=1, devices=CPU8))(T0)


# -- multichip_slam_step and the dry run --------------------------------------

def _se3_np(yaw, t):
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = t
    return T


def _slam_step_inputs(B=8, N=64, Mref=256, K=3):
    """The dry run's first scan (__graft_entry__.py:130-199), with its
    graph grown to one keyframe per agent chained from the anchor plus
    odometry, every agent's closure slot live and written by the step."""
    rng = np.random.default_rng(0)
    world = rng.normal(size=(Mref, 3)).astype(np.float32) * 3.0
    nrm = rng.normal(size=(B, Mref, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    ref = np.broadcast_to(world, (B, Mref, 3)).copy()
    readings = np.empty((B, N, 3), np.float32)
    T_inits = np.empty((B, 4, 4), np.float32)
    for b in range(B):
        dT = _se3_np(0.02 + 0.005 * b, [0.12, 0.02 * b, 0.0])
        drift = _se3_np(0.004, [0.015, -0.01, 0.005])
        T_inits[b] = (dT @ drift).astype(np.float32)
        sample = world[(np.arange(N) * (b + 3)) % Mref]
        readings[b] = ((sample - dT[:3, 3]) @ dT[:3, :3]).astype(
            np.float32) + rng.normal(0, 0.003, (N, 3)).astype(np.float32)
    V, E = 1 + B * K, B * K + B
    poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    vmask = np.zeros(V, bool)
    vmask[0] = True
    ef, et = np.zeros(E, np.int32), np.zeros(E, np.int32)
    eT = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    ec = np.tile(np.eye(6, dtype=np.float32) * 0.01, (E, 1, 1))
    emask = np.zeros(E, bool)
    slots = np.arange(B * K, B * K + B, dtype=np.int32)
    for b in range(B):
        v = 1 + b * K
        poses[v] = T_inits[b] @ _se3_np(0.01, [0.02, 0.0, 0.01])
        vmask[v] = True
        ef[b * K], et[b * K] = 0, v
        eT[b * K] = poses[v]
        emask[b * K] = True
        ef[slots[b]], et[slots[b]] = 0, v
        emask[slots[b]] = True
    agent_mask = np.arange(B) % 3 != 1      # some agents write nothing
    return (readings, np.ones((B, N), bool), ref, np.ones((B, Mref), bool),
            nrm, T_inits, poses, vmask, ef, et, eT, ec, emask, slots,
            agent_mask)


def test_multichip_slam_step_matches_jax():
    args = _slam_step_inputs()
    kw = dict(error="point_to_point", max_iterations=8)
    jstep = JMC.multichip_slam_step(
        JMC.make_mesh(8, tp=2),
        JICPConfig(outlier=(JO.TrimmedDist(0.9), JO.MaxDist(2.0)), **kw),
        JPGOConfig(max_iterations=2, cg_iterations=10))
    Tj, ovj, optj = jstep(*map(jnp.asarray, args))
    tstep = MC.multichip_slam_step(
        MC.make_mesh(8, tp=2, devices=CPU8),
        TICPConfig(outlier=(TO.TrimmedDist(0.9), TO.MaxDist(2.0)), **kw),
        TPGOConfig(max_iterations=2, cg_iterations=10))
    Tt, ovt, optt = tstep(*args)
    for b in range(Tt.shape[0]):
        assert _twist_gap(Tt[b], np.asarray(Tj[b])) < T_TOL
    np.testing.assert_allclose(ovt.numpy(), np.asarray(ovj),
                               atol=1.0 / args[0].shape[1])
    optj = np.asarray(optj)
    assert np.abs(optt.numpy()[:, :3, 3] - optj[:, :3, 3]).max() \
        < K3_POSE_TOL_M
    np.testing.assert_allclose(optt.numpy()[:, :3, :3], optj[:, :3, :3],
                               atol=K3_POSE_TOL_M)
    # the masked agents' slots kept their measurement; the others moved
    assert not np.allclose(optt.numpy()[1], args[6][1])


def test_dryrun_multichip_on_cpu_positions():
    """__graft_entry__.py's dry run on 8 CPU positions (dp = 4 x tp = 2,
    8 agents, 10 scans), the final errors below 0.05 m."""
    errs = MC.dryrun_multichip(8, devices=CPU8)
    assert len(errs) == 8 and max(errs) < MC.DRYRUN_TOL_M
    print(f"dryrun_multichip final errors: max {max(errs) * 100:.3f} cm")
