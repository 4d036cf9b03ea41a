"""Persistence, evaluation and the dataset generators: the port against
pgslam_tpu. Checkpoints written by either package load in the other with
the same arrays; a run resumed in the port from the JAX package's
checkpoint stays within the replays' 0.10 m of the uninterrupted JAX run
with equal counts; KITTI, TUM and PLY files read the same in both;
``eval`` agrees within 1e-12; the generators are bit-equal."""

import os

import numpy as np
import pytest
import torch

from pgslam_tpu import datasets as JD
from pgslam_tpu import eval as JE
from pgslam_tpu import io as JIO
from pgslam_tpu.cloud import make_cloud as jmake
from pgslam_tpu.graph.pose_graph import MapManager as JMM
from pgslam_tpu_torch import datasets as TD
from pgslam_tpu_torch import eval as TE
from pgslam_tpu_torch import io as TIO
from pgslam_tpu_torch import replays
from pgslam_tpu_torch.cloud import make_cloud as tmake
from pgslam_tpu_torch.graph.pose_graph import MapManager as TMM
from pgslam_tpu_torch.ops import filters as TF
from torch_threads import one_torch_thread  # noqa: F401

POSE_TOL_M = 0.10   # the replays' parity limit (tests/test_golden_replay.py)
EVAL_TOL = 1e-12
RESUME_AT = 35
GRAPH_ARRAYS = ("poses", "optimized_poses", "update_times", "edge_from",
                "edge_to", "edge_T", "edge_cov", "edge_type", "edge_weight")


def _poses(n, seed=0):
    from pgslam_tpu_torch import se3
    rng = np.random.default_rng(seed)
    return se3.exp(torch.as_tensor(rng.normal(size=(n, 6)) * 0.7,
                                   dtype=torch.float32)).numpy()


def _graph_with_descriptors(make, mm, normals_of):
    """Three keyframes whose clouds carry normals and surface curvature
    (and one observation directions), two odometry edges and a loop."""
    rng = np.random.default_rng(1)
    T = _poses(3)
    for v in range(3):
        pts = rng.uniform(-3, 3, (50 + 10 * v, 3)).astype(np.float32)
        desc = normals_of(pts)
        if v == 1:
            desc["observationDirections"] = -pts / np.linalg.norm(
                pts, axis=1, keepdims=True)
        cloud = make(pts, descriptors=desc, capacity=96)
        if v == 0:
            mm.add_first_keyframe(cloud, T[0])
        else:
            mm.graph.add_vertex(cloud, T[v], mm.now())
            mm.graph.add_edge(v - 1, v, T[v], np.eye(6, dtype=np.float32)
                              * (0.1 + v), 0)
    mm.graph.add_edge(0, 2, T[2], np.eye(6, dtype=np.float32) * 0.3, 1)
    mm.graph.optimized_poses[:3] = _poses(3, seed=5)


def _normals(pts):
    c = TF.apply_one(TF.SurfaceNormal(knn=10), tmake(pts))
    return {k: v.numpy() for k, v in c.descriptors.items()}


def _assert_same_map(g_a, g_b, to_np_a, to_np_b):
    assert g_a.n_vertices == g_b.n_vertices
    assert g_a.n_edges == g_b.n_edges
    nv, ne = g_a.n_vertices, g_a.n_edges
    for name in GRAPH_ARRAYS:
        n = nv if name in ("poses", "optimized_poses", "update_times") else ne
        np.testing.assert_array_equal(getattr(g_a, name)[:n],
                                      getattr(g_b, name)[:n])
    for ca, cb in zip(g_a.clouds, g_b.clouds):
        np.testing.assert_array_equal(to_np_a(ca.points), to_np_b(cb.points))
        np.testing.assert_array_equal(to_np_a(ca.mask), to_np_b(cb.mask))
        assert set(ca.descriptors) == set(cb.descriptors)
        assert {"normals", "surfaceCurvature"} <= set(ca.descriptors)
        for k in ca.descriptors:
            np.testing.assert_array_equal(to_np_a(ca.descriptors[k]),
                                          to_np_b(cb.descriptors[k]))


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jmm = JMM()
    _graph_with_descriptors(jmake, jmm, _normals)
    path = str(tmp_path / "jax.npz")
    JIO.save_checkpoint(path, jmm)
    tmm = TMM()
    TIO.load_checkpoint(path, tmm, device="cpu")
    _assert_same_map(jmm.graph, tmm.graph, np.asarray,
                     lambda t: t.cpu().numpy())
    assert tmm.fixed_vertex == jmm.fixed_vertex == 0
    assert tmm._clock == jmm._clock
    assert tmm.graph.clouds[0].points.device == torch.device("cpu")


def test_port_checkpoint_loads_in_jax(tmp_path):
    tmm = TMM()
    _graph_with_descriptors(lambda p, **kw: tmake(p, **kw), tmm, _normals)
    path = str(tmp_path / "port.npz")
    TIO.save_checkpoint(path, tmm)
    jmm = JMM()
    JIO.load_checkpoint(path, jmm)
    _assert_same_map(tmm.graph, jmm.graph, lambda t: t.cpu().numpy(),
                     np.asarray)
    assert jmm._clock == tmm._clock
    with np.load(path) as a, np.load(path) as b:
        assert int(a["format_version"]) == JIO.FORMAT_VERSION \
            == TIO.FORMAT_VERSION
        assert sorted(a.files) == sorted(b.files)


def _jax_loop_to(n_scans, path):
    """The JAX package's golden loop run to ``n_scans`` scans, saved with
    its localizer."""
    from golden_replay import golden_config
    from pgslam_tpu.slam import PoseGraphSlam as JSlam
    scans, odom, _ = replays.loop_sequence_golden()
    slam = JSlam(golden_config())
    eye = np.eye(4, dtype=np.float32)
    for i in range(n_scans):
        slam.add_data(i, "world", odom[i], eye, scans[i])
    JIO.save_checkpoint(path, slam.map_manager, slam.localizer)


def test_resume_from_a_jax_checkpoint_matches_the_uninterrupted_run(
        tmp_path):
    """The JAX package runs the golden loop to scan 35 and saves; a fresh
    port facade on the CPU loads the checkpoint (its local map rebuilt and
    installed) and runs scans 35-69: every scan within 0.10 m of the JAX
    package's uninterrupted run (golden_replay.npz), equal keyframe and
    loop counts."""
    path = str(tmp_path / "resume.npz")
    _jax_loop_to(RESUME_AT, path)
    slam = replays.PoseGraphSlam(replays.loop_config(), device="cpu")
    TIO.load_checkpoint(path, slam.map_manager, slam.localizer)
    assert slam.localizer.count == RESUME_AT
    assert slam.localizer.icp_engine.reference is not None
    scans, odom, _ = replays.loop_sequence_golden()
    eye = np.eye(4, dtype=np.float32)
    per_scan = []
    for i in range(RESUME_AT, len(scans)):
        slam.add_data(i, "world", odom[i], eye, scans[i])
        per_scan.append(slam.localizer.T_world_robot.copy())
    gold = replays.fixture("loop")
    gap = replays.max_pose_gap(np.stack(per_scan),
                               gold["per_scan_poses"][RESUME_AT:])
    assert gap < POSE_TOL_M, gap
    assert slam.get_graph().n_vertices == len(gold["trajectory"]) == 20
    assert slam.n_loop_edges() == int(gold["n_loop_edges"]) == 1


def test_kitti_and_tum_files_read_the_same_in_both(tmp_path):
    poses = _poses(9, seed=3)
    ts = np.linspace(10.0, 12.0, 9)
    for writer, name in ((JIO, "jax"), (TIO, "port")):
        kitti = str(tmp_path / f"{name}.kitti")
        tum = str(tmp_path / f"{name}.tum")
        writer.save_trajectory_kitti(kitti, poses)
        writer.save_trajectory_tum(tum, poses, timestamps=ts)
        np.testing.assert_array_equal(TIO.load_trajectory_kitti(kitti),
                                      JIO.load_trajectory_kitti(kitti))
        (t_ts, t_p), (j_ts, j_p) = (TIO.load_trajectory_tum(tum),
                                    JIO.load_trajectory_tum(tum))
        np.testing.assert_array_equal(t_ts, j_ts)
        np.testing.assert_array_equal(t_p, j_p)
        np.testing.assert_allclose(t_p, poses, rtol=0, atol=1e-6)
    for kind in ("kitti", "tum"):
        assert len(open(tmp_path / f"port.{kind}").read().splitlines()) == 9


@pytest.mark.parametrize("binary", [True, False])
def test_ply_files_read_the_same_in_both(tmp_path, binary):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-5, 5, (120, 3)).astype(np.float32)
    mask = np.ones(120, bool)
    mask[::9] = False
    nrm = rng.normal(size=(120, 3)).astype(np.float32)
    for writer, make, name in ((JIO, jmake, "jax"), (TIO, tmake, "port")):
        path = str(tmp_path / f"{name}.ply")
        writer.save_cloud_ply(path, make(pts, mask=mask,
                                         descriptors={"normals": nrm}),
                              binary=binary)
        ours = TIO.load_cloud_ply(path, capacity=128, device="cpu")
        theirs = JIO.load_cloud_ply(path, capacity=128)
        np.testing.assert_array_equal(ours.points.numpy(),
                                      np.asarray(theirs.points))
        np.testing.assert_array_equal(ours.mask.numpy(),
                                      np.asarray(theirs.mask))
        np.testing.assert_array_equal(ours.descriptors["normals"].numpy(),
                                      np.asarray(theirs.descriptors["normals"]))
        tol = 0 if binary else 1e-6
        np.testing.assert_allclose(ours.points.numpy()[:mask.sum()],
                                   pts[mask], rtol=0, atol=tol)
    raw = str(tmp_path / "raw.ply")
    TIO.save_cloud_ply(raw, pts[:7])
    np.testing.assert_array_equal(
        TIO.load_cloud_ply(raw, device="cpu").points.numpy(), pts[:7])


def test_global_map_equals_jax():
    """global_map over the same graph: every keyframe's valid points at
    its optimized pose, with and without the per-keyframe cap."""
    from pgslam_tpu.slam import PoseGraphSlam as JSlam
    jslam = JSlam()
    _graph_with_descriptors(jmake, jslam.map_manager, _normals)
    tslam = replays.PoseGraphSlam(device="cpu")
    _graph_with_descriptors(lambda p, **kw: tmake(p, **kw),
                            tslam.map_manager, _normals)
    for cap in (0, 7):
        np.testing.assert_array_equal(tslam.global_map(cap),
                                      jslam.global_map(cap))
    assert replays.PoseGraphSlam(device="cpu").global_map().shape == (0, 3)


# -- eval ----------------------------------------------------------------------

def test_eval_matches_jax():
    truth = _poses(40, seed=7)
    est = truth.copy()
    rng = np.random.default_rng(8)
    est[:, :3, 3] += rng.normal(0, 0.05, (40, 3))
    R, t, s = TE.align_umeyama(est[:, :3, 3].astype(np.float64),
                               truth[:, :3, 3].astype(np.float64), True)
    Rj, tj, sj = JE.align_umeyama(est[:, :3, 3].astype(np.float64),
                                  truth[:, :3, 3].astype(np.float64), True)
    np.testing.assert_allclose(R, Rj, rtol=0, atol=EVAL_TOL)
    np.testing.assert_allclose(t, tj, rtol=0, atol=EVAL_TOL)
    assert abs(s - sj) <= EVAL_TOL
    for align in (True, False):
        assert abs(TE.ate_rmse(est, truth, align)
                   - JE.ate_rmse(est, truth, align)) <= EVAL_TOL
    for delta in (1, 5):
        for a, b in zip(TE.rpe(est, truth, delta), JE.rpe(est, truth, delta)):
            assert abs(a - b) <= EVAL_TOL
    with pytest.raises(ValueError):
        TE.rpe(est[:3], truth[:3], delta=5)


def test_long_eval_fixture_is_the_eval_of_the_long_fixture():
    """golden_replay_long_eval.npz holds pgslam_tpu.eval's ATE and RPE of
    the long fixture's poses; the port's eval gives the same numbers."""
    per_scan = replays.fixture("long")["per_scan_poses"]
    truth = np.stack(replays.long_sequence()[2])
    ev = np.load(os.path.join(replays.FIXTURES, "golden_replay_long_eval.npz"))
    assert abs(TE.ate_rmse(per_scan, truth) - float(ev["ate_rmse"])) \
        <= EVAL_TOL
    rt, rr = TE.rpe(per_scan, truth)
    assert abs(rt - float(ev["rpe_trans"])) <= EVAL_TOL
    assert abs(rr - float(ev["rpe_rot"])) <= EVAL_TOL


# -- datasets -------------------------------------------------------------------

def _flat(x):
    if isinstance(x, (list, tuple)):
        return [z for y in x for z in _flat(y)]
    return [x]


@pytest.mark.parametrize("name,kw", [
    ("clover_sequence", {"n_scans": 30, "scan_points": 64}),
    ("clover_sequence", {"n_scans": 12, "scan_points": 256, "petals": 2,
                         "radius": 6.0}),
    ("harsh_velodyne_pair", {"n_points": 4096}),
    ("harsh_velodyne_pair", {"n_points": 2048, "n_rings": 32,
                             "dynamic_fraction": 0.3}),
    ("velodyne_like_scan", {"n_points": 4096}),
])
def test_generators_equal_jax(name, kw):
    a = _flat(getattr(JD, name)(np.random.default_rng(1), **kw))
    b = _flat(getattr(TD, name)(np.random.default_rng(1), **kw))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_long_sequence_equals_the_fixture_generator():
    import golden_replay
    for a, b in zip(replays.long_sequence(), golden_replay.long_sequence()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_kitti_bin_round_trip(tmp_path):
    pts = TD.velodyne_like_scan(np.random.default_rng(4), n_points=2048)
    refl = np.linspace(0, 1, len(pts)).astype(np.float32)
    for writer, name in ((JD, "jax"), (TD, "port")):
        path = str(tmp_path / f"{name}.bin")
        writer.save_kitti_bin(path, pts, refl if name == "jax" else None)
        for reader in (JD, TD):
            np.testing.assert_array_equal(reader.load_kitti_bin(path), pts)
            np.testing.assert_array_equal(
                reader.load_kitti_bin(path, max_points=100), pts[:100])
    assert open(tmp_path / "jax.bin", "rb").read() != \
        open(tmp_path / "port.bin", "rb").read()
    JD.save_kitti_bin(str(tmp_path / "b.bin"), pts)
    assert open(tmp_path / "b.bin", "rb").read() == \
        open(tmp_path / "port.bin", "rb").read()
