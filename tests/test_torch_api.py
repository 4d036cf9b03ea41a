"""The port's single-device public API against pgslam_tpu on the same numpy
inputs: the package's top-level names, the cloud helpers, one-shot
``icp``, the graph's and the local map's component methods, the
localizer's decision pieces and its overlap-probe cache, the covariance
block swap, and the dense Bellman-Ford."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pgslam_tpu
import pgslam_tpu_torch
import pgslam_tpu_torch.localizer as L
from pgslam_tpu import se3 as jse3
from pgslam_tpu.cloud import concatenate_clouds as j_concat
from pgslam_tpu.cloud import make_cloud as jmake
from pgslam_tpu.cloud import pad_cloud as j_pad
from pgslam_tpu.graph.pose_graph import MapManager as JMapManager
from pgslam_tpu.localizer import Localizer as JLocalizer
from pgslam_tpu.localizer import LocalizerConfig as JLocalizerConfig
from pgslam_tpu.localmap import Composition as JComposition
from pgslam_tpu.localmap import LocalMap as JLocalMap
from pgslam_tpu.ops import filters as JF
from pgslam_tpu.ops import outlier as JO
from pgslam_tpu.ops.icp import ICPConfig as JICPConfig
from pgslam_tpu.ops.icp import icp as j_icp
from pgslam_tpu.optimizer import pm_cov_to_gtsam_cov as j_swap
from pgslam_tpu_torch.cloud import (concatenate_clouds, empty_cloud,
                                    make_cloud, pad_cloud)
from pgslam_tpu_torch.convert import config_from_dict, config_to_dict
from pgslam_tpu_torch.graph.pose_graph import (LOOP_CONSTRAINT,
                                               ODOM_CONSTRAINT, MapManager)
from pgslam_tpu_torch.graph.shortest_path import (bellman_ford,
                                                  dense_adjacency, dijkstra)
from pgslam_tpu_torch.localizer import Localizer, LocalizerConfig
from pgslam_tpu_torch.localmap import Composition, LocalMap
from pgslam_tpu_torch.ops.icp import ICPConfig, icp
from pgslam_tpu_torch.optimizer import pm_cov_to_gtsam_cov

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# pgslam_tpu's top-level names (pgslam_tpu/__init__.py).
EXPORTED = (
    "empty_cloud", "icp", "PoseGraph", "LocalMap", "LocalizerConfig",
    "Localizer", "LoopCloserConfig", "LoopCloser", "OptimizerConfig",
    "Optimizer", "save_checkpoint", "load_checkpoint",
    "save_trajectory_kitti", "load_trajectory_kitti", "save_trajectory_tum",
    "load_trajectory_tum", "ate_rmse", "rpe", "align_umeyama",
    "prefetch_clouds", "prefetch_batches", "load_kitti_bin",
    "save_kitti_bin", "harsh_velodyne_pair", "ScanLoader",
    "make_sharded_register")


def T_at(x, y=0.0, z=0.0):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [x, y, z]
    return T


@pytest.mark.parametrize("name", EXPORTED)
def test_name_resolves(name):
    ours = getattr(pgslam_tpu_torch, name)
    theirs = getattr(pgslam_tpu, name)
    assert ours.__name__ == theirs.__name__
    assert ours.__module__.startswith("pgslam_tpu_torch.")
    if name in pgslam_tpu.__all__:
        assert name in pgslam_tpu_torch.__all__


def test_unknown_name_raises():
    """A name neither package has."""
    assert not hasattr(pgslam_tpu, "make_sharded_registry")
    with pytest.raises(AttributeError):
        pgslam_tpu_torch.make_sharded_registry  # noqa: B018


def test_api_imports_without_jax():
    """The new modules and the example import with jax and pgslam_tpu
    blocked."""
    code = ("import sys\n"
            "for m in ('jax', 'jax.numpy', 'pgslam_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'examples')!r}]\n"
            "import pgslam_tpu_torch as t\n"
            "import pgslam_tpu_torch.native, velodyne_slam_torch\n"
            "import pgslam_tpu_torch.parallel.multichip\n"
            "import pgslam_tpu_torch.parallel.sharded_icp\n"
            + "".join(f"t.{n}\n" for n in EXPORTED)
            + "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


# -- clouds (tests/test_cloud_ops.py) ----------------------------------------

def test_empty_cloud():
    e = empty_cloud(8, {"normals": 3})
    j = pgslam_tpu.empty_cloud(8, {"normals": 3})
    assert e.capacity == j.capacity == 8 and int(e.count()) == 0
    assert e.points.dtype == torch.float32 and e.mask.dtype == torch.bool
    assert tuple(e.descriptors["normals"].shape) == \
        j.descriptors["normals"].shape


def test_concatenate_clouds(rng):
    a_pts, b_pts = rng.normal(size=(5, 3)), rng.normal(size=(3, 3))
    normals = np.ones((5, 3))
    ours = concatenate_clouds([
        make_cloud(a_pts, capacity=8, descriptors={"normals": normals}),
        make_cloud(b_pts, capacity=4)])
    theirs = j_concat([jmake(a_pts, capacity=8,
                             descriptors={"normals": normals}),
                       jmake(b_pts, capacity=4)])
    assert ours.capacity == 12 and int(ours.count()) == 8
    np.testing.assert_array_equal(ours.points.numpy(),
                                  np.asarray(theirs.points))
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(theirs.mask))
    np.testing.assert_array_equal(ours.descriptors["normals"].numpy(),
                                  np.asarray(theirs.descriptors["normals"]))


def test_pad_cloud(rng):
    pts = rng.normal(size=(5, 3))
    ours = pad_cloud(make_cloud(pts, descriptors={"normals": pts}), 9)
    theirs = j_pad(jmake(pts, descriptors={"normals": pts}), 9)
    assert ours.capacity == 9 and int(ours.count()) == 5
    for a, b in ((ours.points, theirs.points), (ours.mask, theirs.mask),
                 (ours.descriptors["normals"],
                  theirs.descriptors["normals"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    same = make_cloud(pts)
    assert pad_cloud(same, 5) is same
    with pytest.raises(ValueError):
        pad_cloud(same, 4)


# -- one-shot registration ----------------------------------------------------

@pytest.mark.parametrize("error", ["point_to_point", "point_to_plane"])
def test_icp_matches_jax(error):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (400, 3)).astype(np.float32)
    pts[:, 2] = np.sign(pts[:, 2]) * 2 + rng.normal(size=400) * 0.1
    off = np.asarray(jse3.exp(jnp.asarray(
        [0.2, -0.1, 0.05, 0.02, -0.03, 0.04], jnp.float32)))
    moved = ((pts - off[:3, 3]) @ off[:3, :3]).astype(np.float32)
    jcfg = JICPConfig(error=error, outlier=(JO.TrimmedDist(0.9),),
                      reference_filters=(JF.SurfaceNormal(knn=8),)
                      if error == "point_to_plane" else (),
                      max_iterations=30, trans_eps=1e-3, rot_eps=1e-3)
    tcfg = config_from_dict(ICPConfig, config_to_dict(jcfg))
    jr = j_icp(jmake(moved, capacity=512), jmake(pts, capacity=512),
               jnp.eye(4), jcfg)
    tr = icp(make_cloud(moved, capacity=512), make_cloud(pts, capacity=512),
             torch.eye(4), tcfg)
    np.testing.assert_allclose(tr.T.numpy(), np.asarray(jr.T), atol=1e-5)
    np.testing.assert_allclose(tr.T.numpy(), off, atol=1e-3)
    assert int(tr.iterations) == int(jr.iterations)
    assert bool(tr.converged) == bool(jr.converged)


# -- the graph (tests/test_graph.py) -------------------------------------------

def _chains(rng, n=5, spacing=1.0):
    """The same chain graph in both packages."""
    out = []
    for M, mk in ((MapManager, make_cloud), (JMapManager, jmake)):
        r = np.random.default_rng(rng)
        mm = M()
        mm.add_first_keyframe(mk(r.normal(size=(16, 3)).astype(np.float32),
                                 capacity=16), T_at(0.0))
        for i in range(1, n):
            mm.graph.add_vertex(mk(r.normal(size=(16, 3)).astype(np.float32),
                                   capacity=16), T_at(i * spacing), mm.now())
            mm.graph.add_edge(i - 1, i, T_at(spacing),
                              np.eye(6, dtype=np.float32), ODOM_CONSTRAINT)
        out.append(mm)
    return out


def test_edges_between():
    ours, theirs = _chains(0, 6)
    for mm in (ours, theirs):
        mm.graph.add_edge(5, 1, T_at(1.0), np.eye(6), LOOP_CONSTRAINT)
    for vs in ({1, 2, 3}, {0, 5, 1}, {4}, {0, 1, 2, 3, 4, 5}):
        np.testing.assert_array_equal(ours.graph.edges_between(vs),
                                      theirs.graph.edges_between(vs))
    np.testing.assert_array_equal(ours.graph.edges_between({1, 5}), [5])


def test_update_keyframe_transform():
    ours, theirs = _chains(0, 4)
    for mm in (ours, theirs):
        mm.update_keyframe_transform(2, T_at(2.5, 0.1), mm.now())
    g, h = ours.graph, theirs.graph
    np.testing.assert_array_equal(g.optimized_poses[:4],
                                  h.optimized_poses[:4])
    np.testing.assert_array_equal(g.update_times[:4], h.update_times[:4])
    np.testing.assert_array_equal(g.poses[2], T_at(2.0))


def test_bellman_ford_matches_dijkstra():
    ours, _ = _chains(0, 8, spacing=1.5)
    g = ours.graph
    e = g.n_edges
    g.add_edge(7, 2, T_at(0.5), np.eye(6), LOOP_CONSTRAINT)
    e = g.n_edges
    W = dense_adjacency(g.n_vertices, torch.from_numpy(g.edge_from[:e]),
                        torch.from_numpy(g.edge_to[:e]),
                        torch.from_numpy(g.edge_weight[:e]),
                        torch.ones(e, dtype=torch.bool))
    for src in (0, 3, 7):
        d_bf = bellman_ford(W, src).numpy()
        d_dj, _ = dijkstra(g.n_vertices, g.edge_from[:e], g.edge_to[:e],
                           g.edge_weight[:e], src)
        np.testing.assert_allclose(d_bf, d_dj, rtol=1e-5)
    # a masked edge is no edge
    mask = torch.ones(e, dtype=torch.bool)
    mask[-1] = False
    W2 = dense_adjacency(g.n_vertices, torch.from_numpy(g.edge_from[:e]),
                         torch.from_numpy(g.edge_to[:e]),
                         torch.from_numpy(g.edge_weight[:e]), mask)
    assert float(W2[7, 2]) == float("inf")
    np.testing.assert_allclose(bellman_ford(W2, 0).numpy(),
                               1.5 * np.arange(8), rtol=1e-6)


def test_composition_container():
    ours, theirs = Composition(3), JComposition(3)
    for c in (ours, theirs):
        for v in [10, 11, 12, 13]:
            c.push_back(v)
    assert ours.as_list() == theirs.as_list() == [11, 12, 13]
    assert (10 in ours, 11 in ours) == (10 in theirs, 11 in theirs) \
        == (False, True)
    assert [ours[i] for i in range(3)] == [theirs[i] for i in range(3)]
    assert ours[-1] == ours.back() == 13
    dup = ours.copy()
    dup.push_back(14)
    assert ours.as_list() == [11, 12, 13] and dup.as_list() == [12, 13, 14]
    assert dup.capacity == 3


def test_localmap_from_graph_and_staleness():
    ours, theirs = _chains(0, 4)
    lm = LocalMap.from_graph(ours.graph, Composition(3, [1, 2, 3]))
    jlm = JLocalMap.from_graph(theirs.graph, JComposition(3, [1, 2, 3]))
    assert lm.reference_vertex() == jlm.reference_vertex() == 3
    assert lm.has_cloud() and lm.cloud().capacity == 3 * 16
    np.testing.assert_allclose(lm.cloud().points.numpy(),
                               np.asarray(jlm.cloud().points), atol=1e-6)
    np.testing.assert_array_equal(lm.cloud().mask.numpy(),
                                  np.asarray(jlm.cloud().mask))
    assert not lm.is_outdated(ours.graph)
    for mm, m in ((ours, lm), (theirs, jlm)):
        mm.update_keyframe_transform(2, T_at(2.5), mm.now())
        assert m.is_outdated(mm.graph)
        assert not m.is_reference_keyframe_outdated(mm.graph)
        m.update_from_graph(mm.graph)
        assert not m.is_outdated(mm.graph)
    np.testing.assert_allclose(lm.cloud().points.numpy(),
                               np.asarray(jlm.cloud().points), atol=1e-6)
    assert lm.has_same_composition(Composition(3, [2, 1, 3]))
    assert not lm.has_same_composition(Composition(3, [1, 3, 2]))


# -- the localizer's decisions (tests/test_localizer_logic.py) -----------------

def _logic_pair(positions, comp_ids, robot_x, seed=42):
    """The same hand-built chain, local map and robot pose in both
    packages (8-point keyframes)."""
    out = []
    for M, mk, Loc, Cfg, LM, C in (
            (MapManager, make_cloud, Localizer, LocalizerConfig, LocalMap,
             Composition),
            (JMapManager, jmake, JLocalizer, JLocalizerConfig, JLocalMap,
             JComposition)):
        rng = np.random.default_rng(seed)
        cloud = lambda: mk(rng.normal(size=(8, 3)).astype(np.float32),
                           capacity=8)
        mm = M()
        mm.add_first_keyframe(cloud(), T_at(positions[0]))
        for i in range(1, len(positions)):
            mm.graph.add_vertex(cloud(), T_at(positions[i]), mm.now())
            mm.graph.add_edge(i - 1, i, T_at(positions[i] - positions[i - 1]),
                              np.eye(6, dtype=np.float32), ODOM_CONSTRAINT)
        kw = {"device": "cpu"} if Loc is Localizer else {}
        loc = Loc(mm, Cfg(keyframe_cloud_capacity=8), **kw)
        loc.local_map = LM.from_graph(mm.get_graph(), C(3, comp_ids))
        loc.T_world_robot = T_at(robot_x)
        out.append(loc)
    return out


@pytest.mark.parametrize("positions,comp,robot,want", [
    ((0, 1, 2, 3, 4), [0, 1, 2], 2.9, [1, 2, 3]),     # moving forward
    ((0, 1, 2, 3, 4), [2, 3, 4], 1.9, [3, 1, 2]),     # moving backward
    ((0, 1, 2), [0, 1, 2], 1.0, None),                # no neighbour
])
def test_neighbor_composition(positions, comp, robot, want):
    ours, theirs = _logic_pair(positions, comp, robot)
    (c, found), (jc, jfound) = (ours.find_neighbor_local_map_composition(),
                                theirs.find_neighbor_local_map_composition())
    assert found == jfound == (want is not None)
    if want is None:
        assert c is None and jc is None
    else:
        assert c.as_list() == jc.as_list() == want
        assert c.back() == want[-1]


class _Result:
    overlap = np.float32(0.95)
    T = np.eye(4, dtype=np.float32)
    cov = np.eye(6, dtype=np.float32)
    diverged = np.bool_(False)


def test_closest_vertex_swap_changes_reference():
    ours, theirs = _logic_pair((0, 1, 2), [0, 1, 2], 0.1)
    for loc in (ours, theirs):
        loc.next_composition = loc.local_map.get_composition()
        loc.T_refkf_robot = np.asarray(np.linalg.inv(T_at(2.0)) @ T_at(0.1),
                                       np.float32)
        loc.update_after_icp(_Result())
    comp = ours.local_map.get_composition().as_list()
    assert comp == theirs.local_map.get_composition().as_list()
    assert comp[-1] == 0 and set(comp) == {0, 1, 2}
    np.testing.assert_allclose(ours.T_refkf_robot, theirs.T_refkf_robot,
                               atol=1e-6)


def test_first_cloud_bootstraps():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(8, 3)).astype(np.float32)
    mm = MapManager()
    loc = Localizer(mm, LocalizerConfig(keyframe_cloud_capacity=8),
                    device="cpu")
    loc.process_data(T_at(5.0), np.eye(4, dtype=np.float32),
                     make_cloud(pts, capacity=8))
    assert mm.get_graph().n_vertices == 1 and loc.local_map.has_cloud()
    np.testing.assert_allclose(loc.T_world_robot, T_at(5.0))
    np.testing.assert_allclose(loc.T_refkf_robot, np.eye(4))


def test_finish_scan_spawns_a_keyframe_as_jax_does():
    """A low overlap with no better neighbour spawns a keyframe: the pose
    composition, the decision and the new composition, in both."""
    ours, theirs = _logic_pair((0, 1, 2), [0, 1, 2], 2.0)

    class Low(_Result):
        overlap = np.float32(0.3)
        T = T_at(0.4)

    for loc in (ours, theirs):
        loc.next_composition = loc.local_map.get_composition()
        loc.input_cloud = loc.mm.get_graph().clouds[2]
        loc.finish_scan(Low(), T_at(2.4))
    for loc in (ours, theirs):
        assert loc.mm.get_graph().n_vertices == 4
    assert ours.local_map.get_composition().as_list() == \
        theirs.local_map.get_composition().as_list() == [1, 2, 3]
    np.testing.assert_allclose(ours.T_world_robot, theirs.T_world_robot,
                               atol=1e-6)
    np.testing.assert_array_equal(ours.last_input_T_world_robot, T_at(2.4))


def test_finish_scan_takes_a_device_result():
    """finish_scan given the result's tensors (as icp returns them) leaves
    the state its host copy does, and the JAX localizer's from the same
    numbers."""
    from pgslam_tpu_torch.ops.icp import ICPResult
    ours, theirs = _logic_pair((0, 1, 2), [0, 1, 2], 2.0)
    twin, _ = _logic_pair((0, 1, 2), [0, 1, 2], 2.0)
    dev = ICPResult(T=torch.from_numpy(T_at(0.1)), iterations=torch.tensor(
        5, dtype=torch.int32), converged=torch.tensor(True),
        max_iter_reached=torch.tensor(False), overlap=torch.tensor(0.95),
        residual=torch.tensor(0.5), cov=torch.eye(6),
        diverged=torch.tensor(False))
    host = ICPResult(**{k: np.asarray(v) for k, v in vars(dev).items()})
    for loc, res in ((ours, dev), (twin, host), (theirs, host)):
        loc.next_composition = loc.local_map.get_composition()
        loc.input_cloud = loc.mm.get_graph().clouds[2]
        loc.finish_scan(res, T_at(2.1))
    assert isinstance(ours.last_result.T, np.ndarray)
    for other in (twin, theirs):
        np.testing.assert_allclose(ours.T_world_robot, other.T_world_robot,
                                   atol=1e-6)
        assert ours.local_map.get_composition().as_list() == \
            other.local_map.get_composition().as_list()


# -- the overlap probe and its cache (tests/test_probe_cache.py) --------------

CAP = 256


def _probe_pair(seed=42):
    jcfg = JICPConfig(error="point_to_point", matcher="brute",
                      reference_filters=(JF.Compact(CAP * 3),),
                      outlier=(JO.TrimmedDist(0.9), JO.MaxDist(2.0)),
                      max_iterations=3)
    tcfg = config_from_dict(ICPConfig, config_to_dict(jcfg))
    out = []
    for M, mk, Loc, Cfg, LM, C, cfg in (
            (MapManager, make_cloud, Localizer, LocalizerConfig, LocalMap,
             Composition, tcfg),
            (JMapManager, jmake, JLocalizer, JLocalizerConfig, JLocalMap,
             JComposition, jcfg)):
        rng = np.random.default_rng(seed)

        def cloud(x):
            pts = rng.normal(size=(CAP, 3)).astype(np.float32) \
                * [3.0, 3.0, 0.5]
            pts[:, 0] += x
            return mk(pts.astype(np.float32), capacity=CAP)

        mm = M()
        mm.add_first_keyframe(cloud(0.0), T_at(0.0))
        for i, x in enumerate((1.0, 2.0), start=1):
            mm.graph.add_vertex(cloud(0.0), T_at(x), mm.now())
            mm.graph.add_edge(i - 1, i, T_at(1.0),
                              np.eye(6, dtype=np.float32), ODOM_CONSTRAINT)
        kw = {"device": "cpu"} if Loc is Localizer else {}
        loc = Loc(mm, Cfg(icp=cfg, keyframe_cloud_capacity=CAP), **kw)
        loc.local_map = LM.from_graph(mm.get_graph(), C(3, [0, 1, 2]))
        loc.T_world_robot = T_at(1.0)
        loc.input_cloud = cloud(1.0)
        out.append(loc)
    return out


def _counting_build(monkeypatch):
    calls = []
    orig = L.probe_build_batched

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(L, "probe_build_batched", counting)
    return calls


def test_probe_cache_hit_and_jax_overlap(monkeypatch):
    ours, theirs = _probe_pair()
    calls = _counting_build(monkeypatch)
    comp = Composition(3, [0, 1, 2])
    ov1 = ours.compute_overlap_with(comp)
    ov2 = ours.compute_overlap_with(comp)
    assert len(calls) == 1, "the second probe must hit the cache"
    assert ov1 == ov2 and 0.0 < ov1 <= 1.0
    assert ov1 == pytest.approx(
        theirs.compute_overlap_with(JComposition(3, [0, 1, 2])), abs=1e-5)


def test_probe_cache_invalidates_on_pose_writeback(monkeypatch):
    ours, theirs = _probe_pair()
    calls = _counting_build(monkeypatch)
    comp, jcomp = Composition(3, [0, 1, 2]), JComposition(3, [0, 1, 2])
    ours.compute_overlap_with(comp)
    for loc in (ours, theirs):
        T_new = loc.mm.get_graph().optimized_poses[1].copy()
        T_new[0, 3] += 0.5
        loc.mm.update_keyframe_transform(1, T_new, loc.mm.now())
    ov = ours.compute_overlap_with(comp)
    assert len(calls) == 2, "a pose writeback must invalidate the cache"
    assert ov == pytest.approx(theirs.compute_overlap_with(jcomp), abs=1e-5)
    ours.compute_overlap_with(Composition(3, [2, 1, 0]))
    assert len(calls) == 3 and len(ours._probe_cache) == 2


def test_probe_reading_reuse_matches_fresh_prep():
    ours, _ = _probe_pair()
    comp = Composition(3, [0, 1, 2])
    reading = ours.icp_engine.prepare_reading(ours.input_cloud)
    assert ours.compute_overlap_with(comp, reading=reading) == \
        pytest.approx(ours.compute_overlap_with(comp), abs=1e-6)


@pytest.mark.parametrize("current", [0.5, 0.85, 0.99])
def test_is_better_composition(current):
    ours, theirs = _probe_pair()
    for comp in ([0, 1, 2], [2, 1, 0], [1, 2, 0]):
        assert ours.is_better_composition(current, Composition(3, comp)) \
            == theirs.is_better_composition(current, JComposition(3, comp))
    # the current composition is never better
    assert not ours.is_better_composition(0.0, Composition(3, [0, 1, 2]))


# -- the covariance swap (tests/test_config_io.py) -----------------------------

def test_pm_cov_to_gtsam_cov(rng):
    c = rng.normal(size=(6, 6)).astype(np.float32)
    c = c @ c.T
    g = pm_cov_to_gtsam_cov(c)
    np.testing.assert_array_equal(g, j_swap(c))
    np.testing.assert_allclose(g[:3, :3], c[3:, 3:])
    np.testing.assert_allclose(g[3:, 3:], c[:3, :3])
    np.testing.assert_array_equal(pm_cov_to_gtsam_cov(g), c)
    stack = np.stack([c, 2 * c])
    np.testing.assert_array_equal(pm_cov_to_gtsam_cov(stack), j_swap(stack))
