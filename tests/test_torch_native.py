"""The port's own native core (``pgslam_tpu_torch.native``): it builds with
the host g++ into ``pgslam_tpu_torch/_build/``, its Dijkstra agrees with
the Python heap and with pgslam_tpu's native core, and its scan loader
streams KITTI ``.bin`` files as pgslam_tpu's does (the cases of
tests/test_native.py)."""

import os

import numpy as np
import pytest

from pgslam_tpu.native import ScanLoader as JScanLoader
from pgslam_tpu.native import native_dijkstra as j_native_dijkstra
from pgslam_tpu_torch import _build
from pgslam_tpu_torch import native as N
from pgslam_tpu_torch.cloud import MM_SCALE, dequantize_cloud, make_cloud
from pgslam_tpu_torch.datasets import load_kitti_bin, save_kitti_bin
from pgslam_tpu_torch.graph import shortest_path as sp
from pgslam_tpu_torch.native import (ScanLoader, native_available,
                                     native_components, native_dijkstra)
from torch_threads import one_torch_thread  # noqa: F401


def random_graph(rng, n=50, extra=60):
    ef = list(range(n - 1))
    et = list(range(1, n))
    for _ in range(extra):
        a, b = rng.integers(0, n, 2)
        if a != b:
            ef.append(int(a))
            et.append(int(b))
    w = rng.uniform(0.1, 5.0, len(ef)).astype(np.float32)
    return (np.asarray(ef, np.int32), np.asarray(et, np.int32), w)


def test_native_builds():
    assert native_available(), "the native core failed to build or load"
    path = N.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert not path.startswith(os.path.dirname(N.__file__) + os.sep)


def test_native_matches_python(rng):
    n = 50
    ef, et, w = random_graph(rng, n)
    for src in [0, 10, 49]:
        nd, ns = native_dijkstra(n, ef, et, w, src)
        pd, ps = sp.dijkstra_python(n, ef, et, w, src)
        jd, js = j_native_dijkstra(n, ef, et, w, src)
        np.testing.assert_allclose(nd, pd, rtol=1e-6)
        np.testing.assert_array_equal(nd, jd)
        assert ns == ps == js


def test_native_with_masks(rng):
    n = 30
    ef, et, w = random_graph(rng, n, extra=20)
    vertex_ok = rng.uniform(size=n) > 0.2
    edge_ok = rng.uniform(size=len(ef)) > 0.3
    src = int(np.nonzero(vertex_ok)[0][0])
    kw = dict(vertex_ok=vertex_ok, edge_ok=edge_ok)
    nd, ns = native_dijkstra(n, ef, et, w, src, **kw)
    pd, ps = sp.dijkstra_python(n, ef, et, w, src, **kw)
    np.testing.assert_allclose(nd, pd, rtol=1e-6)
    np.testing.assert_array_equal(nd, j_native_dijkstra(n, ef, et, w, src,
                                                        **kw)[0])
    assert ns == ps


def test_native_early_stop(rng):
    n = 40
    ef, et, w = random_graph(rng, n)
    nd, ns = native_dijkstra(n, ef, et, w, 5, max_settled=7)
    assert len(ns) == 7 and ns[0] == 5
    assert ns == sp.dijkstra_python(n, ef, et, w, 5, max_settled=7)[1]


def test_native_components():
    ef = np.asarray([0, 1, 3, 4], np.int32)
    et = np.asarray([1, 2, 4, 5], np.int32)
    n, labels = native_components(6, ef, et)
    assert n == 2
    assert labels[0] == labels[1] == labels[2]
    assert labels[3] == labels[4] == labels[5]
    assert labels[0] != labels[3]


def test_dispatch_uses_native(rng, monkeypatch):
    """shortest_path.dijkstra runs the native core, and the Python heap
    where the core is unavailable."""
    n = 25
    ef, et, w = random_graph(rng, n, extra=10)
    d1, s1 = sp.dijkstra(n, ef, et, w, 0)
    d2, s2 = native_dijkstra(n, ef, et, w, 0)
    np.testing.assert_array_equal(d1, d2)
    assert list(s1) == list(s2)

    def unavailable(*a, **k):
        raise ImportError("native graph core unavailable")

    monkeypatch.setattr(N, "native_dijkstra", unavailable)
    d3, s3 = sp.dijkstra(n, ef, et, w, 0)
    np.testing.assert_allclose(d3, d2, rtol=1e-6)
    assert s3 == s2


def test_native_scan_loader(tmp_path):
    """Scans stream in filename order, bit for bit, with reflectance, and
    as pgslam_tpu's loader streams them."""
    rng = np.random.default_rng(0)
    scans = []
    for i in range(5):
        pts = rng.uniform(-40, 40, (500 + 100 * i, 3)).astype(np.float32)
        refl = rng.uniform(0, 1, len(pts)).astype(np.float32)
        save_kitti_bin(str(tmp_path / f"{i:06d}.bin"), pts, refl)
        scans.append((pts, refl))
    with ScanLoader(str(tmp_path), with_reflectance=True) as loader:
        assert len(loader) == 5
        out = list(loader)
    assert len(out) == 5
    for (pts, refl), (lp, lr) in zip(scans, out):
        np.testing.assert_array_equal(lp, pts)
        np.testing.assert_array_equal(lr, refl)
    np.testing.assert_array_equal(
        out[0][0], load_kitti_bin(str(tmp_path / "000000.bin")))
    with JScanLoader(str(tmp_path)) as theirs:
        for (lp, _), jp in zip(out, theirs):
            np.testing.assert_array_equal(lp, jp)


def test_native_scan_loader_quantized(tmp_path):
    """int16 millimetre scans: the f32 reader's values to the 0.5 mm
    grid, points outside the int16 range dropped, and make_cloud and
    dequantize_cloud take the packets."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-30, 30, (800, 3)).astype(np.float32)
    pts[5] = [40.0, 0.0, 0.0]
    pts[17] = [0.0, -35.0, 2.0]
    save_kitti_bin(str(tmp_path / "000000.bin"), pts)
    with ScanLoader(str(tmp_path), quantize_mm=True) as loader:
        q = next(iter(loader))
    with JScanLoader(str(tmp_path), quantize_mm=True) as theirs:
        np.testing.assert_array_equal(q, next(iter(theirs)))
    assert q.dtype == np.int16 and q.shape == (798, 3)
    keep = np.delete(pts, [5, 17], axis=0)
    np.testing.assert_allclose(q.astype(np.float32) / MM_SCALE, keep,
                               atol=0.5 / MM_SCALE + 1e-7)
    # make_cloud dequantizes the packet into a float32 cloud
    cloud = make_cloud(q, capacity=1024)
    np.testing.assert_allclose(cloud.points.numpy()[:798], keep,
                               atol=0.5 / MM_SCALE + 1e-7)
    assert dequantize_cloud(cloud) is cloud


def test_int16_cloud_through_slam_facade():
    """An int16 millimetre scan through add_data tracks the same scan in
    float32 to the quantization grid, as in pgslam_tpu."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_slam_e2e import small_config

    from pgslam_tpu_torch.convert import config_from_dict, config_to_dict
    from pgslam_tpu_torch.datasets import corridor_sequence
    from pgslam_tpu_torch.slam import PoseGraphSlam, SlamConfig

    rng = np.random.default_rng(7)
    scans, odom, _ = corridor_sequence(
        rng, n_scans=8, scan_points=512, step=0.4, noise=0.003,
        odom_noise=0.005, length=30.0)
    cfg = config_from_dict(SlamConfig, config_to_dict(small_config()))
    T_rs = np.eye(4, dtype=np.float32)

    def run(quantize):
        slam = PoseGraphSlam(cfg, device="cpu")
        for i, (s, T) in enumerate(zip(scans, odom)):
            if quantize:
                s = np.clip(np.round(s * 1000.0), -32767,
                            32767).astype(np.int16)
            slam.add_data(i, "world", T, T_rs, s)
        return slam.T_world_robot

    d = np.linalg.norm(run(False)[:3, 3] - run(True)[:3, 3])
    assert d < 0.02, f"int16 ingest diverged {d} m from f32"


def test_native_scan_loader_skips_pathological_scans(tmp_path):
    """A scan with every point outside the int16 range, or a truncated
    file, is skipped; the scans after it are still served."""
    rng = np.random.default_rng(2)
    good0 = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    all_out = np.full((50, 3), 40.0, np.float32)
    good1 = rng.uniform(-20, 20, (200, 3)).astype(np.float32)
    save_kitti_bin(str(tmp_path / "000000.bin"), good0)
    save_kitti_bin(str(tmp_path / "000001.bin"), all_out)
    save_kitti_bin(str(tmp_path / "000002.bin"), good1)
    with ScanLoader(str(tmp_path), quantize_mm=True) as loader:
        assert [len(s) for s in loader] == [300, 200]
    (tmp_path / "000001.bin").write_bytes(b"\x00" * 7)
    with ScanLoader(str(tmp_path)) as loader:
        assert [len(s) for s in loader] == [300, 200]


def test_native_scan_loader_quantize_flag_required(tmp_path):
    """The int16 stream of a loader opened without quantize_mm is an
    error (its reader thread never built it)."""
    save_kitti_bin(str(tmp_path / "000000.bin"), np.zeros((10, 3),
                                                          np.float32))
    loader = ScanLoader(str(tmp_path), quantize_mm=False)
    try:
        q = np.empty((16, 3), np.int16)
        assert loader._lib.sl_next_q(loader._h, q, 16) == -4
        loader._quant = True
        with pytest.raises(RuntimeError, match="quantize_mm"):
            next(loader)
    finally:
        loader.close()
    with pytest.raises(ValueError):
        ScanLoader(str(tmp_path), quantize_mm=True, with_reflectance=True)


def test_native_scan_loader_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        ScanLoader(str(tmp_path / "nope"))
