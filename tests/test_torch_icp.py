"""The port's ICP layers against pgslam_tpu on the same numpy inputs:
outlier weights, minimizers, VoxelGrid / Compact / normals, icp_core."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgslam_tpu import se3 as jse3
from pgslam_tpu.cloud import make_cloud as jmake
from pgslam_tpu.ops import filters as JF
from pgslam_tpu.ops import minimizer as JM
from pgslam_tpu.ops import outlier as JO
from pgslam_tpu.ops.icp import ICPConfig as JICPConfig
from pgslam_tpu.ops.icp import ICPEngine as JEngine
from pgslam_tpu.ops.icp import icp_core as j_icp_core
from pgslam_tpu.ops.knn import Matches as JMatches
from pgslam_tpu_torch import se3 as tse3
from pgslam_tpu_torch.cloud import make_cloud as tmake
from pgslam_tpu_torch.ops import filters as TF
from pgslam_tpu_torch.ops import minimizer as TM
from pgslam_tpu_torch.ops import outlier as TO
from pgslam_tpu_torch.ops.icp import ICPConfig as TICPConfig
from pgslam_tpu_torch.ops.icp import ICPEngine as TEngine
from pgslam_tpu_torch.ops.icp import icp_core as t_icp_core
from pgslam_tpu_torch.ops.knn import Matches as TMatches

T_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("chain", [
    ((0.85, None), (None, 1.0)), ((0.9, None),), ((None, 0.5),)])
def test_outlier_weights_identical(chain):
    rng = np.random.default_rng(0)
    d2 = rng.exponential(0.3, (500, 1)).astype(np.float32)
    d2[rng.uniform(size=500) < 0.05] = np.inf
    qm = rng.uniform(size=500) < 0.95
    jc = tuple(JO.TrimmedDist(r) if r else JO.MaxDist(m) for r, m in chain)
    tc = tuple(TO.TrimmedDist(r) if r else TO.MaxDist(m) for r, m in chain)
    ids = np.zeros((500, 1), np.int32)
    wj = JO.compute_weights(jc, JMatches(jnp.asarray(d2), jnp.asarray(ids)),
                            jnp.asarray(qm))
    wt = TO.compute_weights(tc, TMatches(_t(d2), _t(ids)), _t(qm))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def _elements(seed=0, n=300):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    q = (p + rng.normal(0, 0.05, (n, 3)) + [0.1, -0.2, 0.05]).astype(
        np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    w = (rng.uniform(size=n) < 0.9).astype(np.float32)
    je = JM.ErrorElements(reading=jnp.asarray(p), reference=jnp.asarray(q),
                          weights=jnp.asarray(w), normals=jnp.asarray(nrm))
    te = TM.ErrorElements(reading=_t(p), reference=_t(q), weights=_t(w),
                          normals=_t(nrm))
    return je, te


@pytest.mark.parametrize("error", ["point_to_point", "point_to_plane"])
def test_minimizers_match_jax(error):
    je, te = _elements()
    step_j = JM.point_to_point if error == "point_to_point" \
        else JM.point_to_plane
    step_t = TM.point_to_point if error == "point_to_point" \
        else TM.point_to_plane
    np.testing.assert_allclose(step_t(te).numpy(), np.asarray(step_j(je)),
                               atol=1e-5)
    np.testing.assert_allclose(float(TM.residual_error(te, error)),
                               float(JM.residual_error(je, error)),
                               rtol=1e-5)
    cj = np.asarray(JM.covariance(je, error))
    np.testing.assert_allclose(TM.covariance(te, error).numpy(), cj,
                               rtol=1e-3, atol=1e-4 * np.abs(cj).max())
    np.testing.assert_allclose(float(TM.overlap(te.weights, 320)),
                               float(JM.overlap(je.weights, jnp.int32(320))),
                               rtol=1e-6)


def test_min_support_guard():
    je, te = _elements(n=5)
    np.testing.assert_array_equal(TM.point_to_point(te).numpy(), np.eye(4))
    np.testing.assert_array_equal(TM.point_to_plane(te).numpy(), np.eye(4))


@pytest.mark.parametrize("voxel,hash_size,span", [
    (0.2, 1 << 16, 20.0), (0.4, 1 << 17, 60.0), (0.05, 1 << 18, 300.0)])
def test_voxel_grid_keep_mask_identical(voxel, hash_size, span):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-span, span, (20000, 3)).astype(np.float32)
    pts[:500] = pts[500:1000]                  # duplicates share voxels
    mask = rng.uniform(size=20000) < 0.9
    cj = JF._voxel_grid(JF.VoxelGrid(voxel, hash_size),
                        jmake(pts, mask=mask))
    ct = TF.voxel_grid(TF.VoxelGrid(voxel, hash_size), tmake(pts, mask=mask))
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    kj = JF.compact(cj, 4096)
    kt = TF.compact(ct, 4096)
    np.testing.assert_array_equal(kt.mask.numpy(), np.asarray(kj.mask))
    np.testing.assert_array_equal(kt.points.numpy(), np.asarray(kj.points))


def test_compute_normals_match_up_to_sign():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-3, 3, (900, 3)).astype(np.float32)
    pts[:, 2] = 0.3 * pts[:, 0] + rng.normal(0, 0.01, 900)
    mask = np.ones(900, bool)
    mask[-40:] = False
    nj = JF.compute_normals(jmake(pts, mask=mask, capacity=1024))
    nt = TF.compute_normals(tmake(pts, mask=mask, capacity=1024))
    a = np.asarray(nj.descriptors["normals"])
    b = nt.descriptors["normals"].numpy()
    # LAPACK builds differ on the eigenvector sign; point-to-plane is
    # invariant to it.
    dots = np.abs(np.sum(a * b, 1))
    np.testing.assert_allclose(dots[:860], 1.0, atol=1e-4)
    np.testing.assert_array_equal(b[860:], 0.0)
    np.testing.assert_allclose(
        nt.descriptors["surfaceCurvature"].numpy(),
        np.asarray(nj.descriptors["surfaceCurvature"]), atol=1e-4)


def _pair(error, seed=0, n=420):
    rng = np.random.default_rng(seed)
    if error == "point_to_plane":     # two noisy planes: normals matter
        pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        pts[:, 2] = np.sign(pts[:, 2]) * 2 + rng.normal(size=n).astype(
            np.float32) * 0.1
    else:                             # blobs: point-to-point structure
        c = rng.uniform(-5, 5, (30, 3))
        pts = (c[rng.integers(0, 30, n)]
               + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    off = np.asarray(jse3.exp(jnp.asarray(
        [0.2, -0.1, 0.05, 0.02, -0.03, 0.04], jnp.float32)))
    moved = (pts - off[:3, 3]) @ off[:3, :3]
    moved += rng.normal(size=moved.shape).astype(np.float32) * 0.01
    return pts, moved.astype(np.float32)


@pytest.mark.parametrize("error,coarse", [("point_to_point", 0),
                                          ("point_to_plane", 0),
                                          ("point_to_plane", 4)])
def test_icp_core_matches_jax(error, coarse):
    pts, moved = _pair(error)
    # Point-to-point at the golden loop profile's eps (1e-3): the JAX
    # checker's arccos angle is quantized to ~3.4e-4 rad in fp32, so at
    # rot_eps 1e-4 its stopping iteration follows the rounding of the
    # SVD's trace (the port's atan2 angle is exact; se3.rotation_angle).
    eps = 1e-3 if error == "point_to_point" else 1e-4
    kw = dict(error=error, max_iterations=40, trans_eps=eps, rot_eps=eps,
              coarse_div=coarse, coarse_iterations=4)
    jcfg = JICPConfig(outlier=(JO.TrimmedDist(0.9), JO.MaxDist(1.0)),
                      reference_filters=(JF.SurfaceNormal(knn=8),), **kw)
    tcfg = TICPConfig(outlier=(TO.TrimmedDist(0.9), TO.MaxDist(1.0)),
                      reference_filters=(TF.SurfaceNormal(knn=8),), **kw)
    je, te = JEngine(jcfg), TEngine(tcfg)
    je.set_map(jmake(pts, capacity=512))
    te.set_map(tmake(pts, capacity=512))
    rj = j_icp_core(jmake(moved, capacity=512), je.reference,
                    jse3.identity(), jcfg)
    rt = t_icp_core(tmake(moved, capacity=512), te.reference,
                    torch.eye(4), tcfg)
    d = tse3.log(tse3.inverse(rt.T) @ _t(rj.T)).numpy()
    assert np.linalg.norm(d) < T_TOL
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.converged) == bool(rj.converged)
    np.testing.assert_allclose(float(rt.overlap), float(rj.overlap),
                               atol=1e-6)
    np.testing.assert_allclose(float(rt.residual), float(rj.residual),
                               rtol=1e-3)


def test_unported_settings_raise():
    with pytest.raises(NotImplementedError):
        TEngine(TICPConfig(matcher="grid"))
    # Anderson acceleration is ported (tests/test_torch_anderson.py).
    TEngine(TICPConfig(anderson_m=3))
