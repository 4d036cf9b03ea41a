"""The data-point filters and the outlier filters: the port against
pgslam_tpu on the same numpy inputs. Masks and weights are held bit for
bit; descriptors within 1e-6 (normals within 1e-5: the two eigen solvers
round differently). RandomSampling's draws are not JAX's (its Threefry
bits are not reproduced), so it is held by an injected keep mask and by
its keep rate."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgslam_tpu.cloud import make_cloud as jmake
from pgslam_tpu.ops import filters as JF
from pgslam_tpu.ops import outlier as JO
from pgslam_tpu.ops.knn import Matches as JMatches
from pgslam_tpu.ops.knn import knn_brute_force
from pgslam_tpu_torch.cloud import make_cloud as tmake
from pgslam_tpu_torch.ops import filters as TF
from pgslam_tpu_torch.ops import outlier as TO
from pgslam_tpu_torch.ops.knn import Matches as TMatches
from pgslam_tpu_torch.ops.knn import knn_plain

DESC_TOL = 1e-6
NORMAL_TOL = 1e-5


def _scene(seed=0, n=600, cap=640):
    """Points on three planes and in clumps (several per voxel), a few
    masked, padded to ``cap``; unit observation directions and normals,
    some normals nearly perpendicular to them."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    pts[::3, 2] = np.round(pts[::3, 2])
    pts[n // 2:n // 2 + 60] = pts[:60] + rng.normal(0, 0.02, (60, 3))
    mask = np.ones(n, bool)
    mask[::17] = False
    obs = rng.normal(size=(n, 3)).astype(np.float32)
    obs /= np.linalg.norm(obs, axis=1, keepdims=True)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm[::4] = np.cross(obs[::4], rng.normal(size=(len(obs[::4]), 3)))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, mask, {"observationDirections": obs,
                       "normals": nrm.astype(np.float32)}, cap


def _clouds(descriptors=True, seed=0):
    pts, mask, desc, cap = _scene(seed)
    desc = desc if descriptors else None
    return (jmake(pts, mask=mask, descriptors=desc, capacity=cap),
            tmake(pts, mask=mask, descriptors=desc, capacity=cap))


# (name, constructor arguments); each is built from both packages.
FILTER_CASES = [
    ("Identity", {}),
    ("MaxPointCount", {"count": 300}),
    ("MaxDist", {"dist": 5.0, "dim": -1}),
    ("MaxDist", {"dist": 2.5, "dim": 1}),
    ("MinDist", {"dist": 3.0, "dim": -1}),
    ("MinDist", {"dist": 1.0, "dim": 2}),
    ("BoundingBox", {"xmin": -2.0, "xmax": 3.0, "ymin": -1.0, "ymax": 4.0,
                     "zmin": -3.0, "zmax": 0.5}),
    ("BoundingBox", {"xmin": -2.0, "xmax": 3.0, "remove_inside": False}),
    ("VoxelGrid", {"voxel_size": 0.7, "hash_size": 4096}),
    ("VoxelGrid", {"voxel_size": 0.7, "hash_size": 64, "method": "sort"}),
    ("ObservationDirection", {"x": 0.5, "y": -1.0, "z": 2.0}),
    ("Shadow", {"eps": 0.3}),
    ("MaxDensity", {"radius": 1.5, "max_count": 3, "hash_size": 4096}),
    ("FixStepSampling", {"step": 3}),
    ("Compact", {"capacity": 512}),
]


def _pair(name, kw):
    return getattr(JF, name)(**kw), getattr(TF, name)(**kw)


def _assert_clouds_equal(jc, tc, tol=DESC_TOL):
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.points.numpy(), np.asarray(jc.points))
    assert set(tc.descriptors) == set(jc.descriptors)
    for k, v in jc.descriptors.items():
        np.testing.assert_allclose(tc.descriptors[k].numpy(), np.asarray(v),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("case", range(len(FILTER_CASES)))
def test_filter_matches_jax(case):
    name, kw = FILTER_CASES[case]
    jcfg, tcfg = _pair(name, kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jc, tc = _clouds()
    out_j = JF._apply_one(jcfg, jc, jax.random.PRNGKey(0))
    out_t = TF.apply_one(tcfg, tc)
    _assert_clouds_equal(out_j, out_t)


def test_every_jax_filter_has_a_counterpart():
    assert [c.__name__ for c in TF.FILTERS] == \
        [c.__name__ for c in JF.FilterConfig]
    for jc, tc in zip(JF.FilterConfig, TF.FILTERS):
        assert dataclasses.asdict(jc()) == dataclasses.asdict(tc())


@pytest.mark.parametrize("hash_size", [64, 4096])
def test_voxel_sort_equals_scatter(hash_size):
    _, tc = _clouds()
    a = TF.voxel_grid(TF.VoxelGrid(0.5, hash_size, "sort"), tc)
    b = TF.voxel_grid(TF.VoxelGrid(0.5, hash_size, "scatter"), tc)
    assert torch.equal(a.mask, b.mask)
    assert 0 < int(a.mask.sum()) < int(tc.mask.sum())


def test_max_density_keeps_the_smallest_indices_per_voxel():
    """At most max_count points a voxel, the smallest valid indices, as
    in the JAX package."""
    pts = np.repeat(np.array([[0.1, 0.1, 0.1], [5.2, 0.1, 0.1]],
                             np.float32), 6, axis=0)
    mask = np.ones(12, bool)
    mask[1] = False
    cfg = dict(radius=1.0, max_count=3, hash_size=1024)
    out_t = TF.apply_one(TF.MaxDensity(**cfg), tmake(pts, mask=mask))
    out_j = JF._apply_one(JF.MaxDensity(**cfg), jmake(pts, mask=mask),
                          jax.random.PRNGKey(0))
    kept = np.nonzero(out_t.mask.numpy())[0]
    np.testing.assert_array_equal(kept, [0, 2, 3, 6, 7, 8])
    np.testing.assert_array_equal(out_t.mask.numpy(), np.asarray(out_j.mask))


def test_shadow_passes_through_without_descriptors():
    jc, tc = _clouds(descriptors=False)
    out = TF.apply_one(TF.Shadow(eps=0.9), tc)
    assert torch.equal(out.mask, tc.mask)
    _assert_clouds_equal(JF._apply_one(JF.Shadow(eps=0.9), jc,
                                       jax.random.PRNGKey(0)), out)


def test_random_sampling_with_the_jax_keep_mask():
    """The chain with RandomSampling fed JAX's own draw (fold_in of the
    key with the element's index) keeps JAX's points, bit for bit."""
    jc, tc = _clouds()
    chain_j = (JF.MaxDist(dist=7.0), JF.RandomSampling(prob=0.6),
               JF.VoxelGrid(0.4, 4096))
    key = jax.random.PRNGKey(11)
    out_j = JF.apply_chain(chain_j, jc, key)
    keep = np.array(jax.random.bernoulli(jax.random.fold_in(key, 1), 0.6,
                                         (tc.capacity,)))
    out_t = TF.apply_one(TF.MaxDist(dist=7.0), tc)
    out_t = TF.random_sampling(out_t, 0.6, keep=torch.from_numpy(keep))
    out_t = TF.apply_one(TF.VoxelGrid(0.4, 4096), out_t)
    _assert_clouds_equal(out_j, out_t)


@pytest.mark.parametrize("prob", [0.25, 0.75])
def test_random_sampling_keep_rate(prob):
    """The keep rate is within 4 sigma of the binomial's; a chain under
    one seed repeats its draw, another seed or element draws anew."""
    n = 20000
    c = tmake(np.zeros((n, 3), np.float32))
    out = TF.apply_chain((TF.RandomSampling(prob),), c, seed=7)
    kept = int(out.mask.sum())
    sigma = np.sqrt(n * prob * (1 - prob))
    assert abs(kept - n * prob) <= 4 * sigma
    again = TF.apply_chain((TF.RandomSampling(prob),), c, seed=7)
    assert torch.equal(out.mask, again.mask)
    other = TF.apply_chain((TF.RandomSampling(prob),), c, seed=8)
    assert not torch.equal(out.mask, other.mask)
    second = TF.apply_chain((TF.Identity(), TF.RandomSampling(prob)), c,
                            seed=7)
    assert not torch.equal(out.mask, second.mask)


# -- normals through K1 at k up to 16 ----------------------------------------

@pytest.mark.parametrize("k", [10, 16])
def test_knn_plain_at_large_k_matches_knn_brute_force(k):
    rng = np.random.default_rng(k)
    q = rng.uniform(-8, 8, (300, 3)).astype(np.float32)
    r = rng.uniform(-8, 8, (900, 3)).astype(np.float32)
    qm = np.ones(300, bool)
    rm = np.ones(900, bool)
    rm[700:] = False
    b = knn_brute_force(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                        jnp.asarray(rm), k=k)
    m = knn_plain(*(torch.from_numpy(a) for a in (q, qm, r, rm)), k=k)
    np.testing.assert_array_equal(m.ids.numpy(), np.asarray(b.ids))
    # d2 is |q|^2 - 2 q.r + |r|^2 in fp32, rounded in another order by
    # the JAX matrix product: the K1 tests' 1e-5 of the squared norms.
    scale = float(np.max(np.sum(q * q, 1)) + np.max(np.sum(r * r, 1)))
    np.testing.assert_allclose(m.dists2.numpy(), np.asarray(b.dists2),
                               rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("orient", [True, False])
def test_normals_at_k10_match_compute_normals(orient):
    """SurfaceNormal(knn=10), the point-to-plane YAML's reference filter:
    normals within 1e-5 (compared up to sign without observation
    directions), curvature within 1e-5, the same mask."""
    jc, tc = _clouds(descriptors=False)
    if orient:
        _, _, desc, _ = _scene()
        obs = desc["observationDirections"]
        jc = jc.with_descriptor("observationDirections",
                                jnp.asarray(np.pad(obs, ((0, 40), (0, 0)))))
        tc = tc.with_descriptor("observationDirections", torch.from_numpy(
            np.pad(obs, ((0, 40), (0, 0)))))
    out_j = JF.compute_normals(jc, knn=10, orient=orient)
    out_t = TF.apply_one(TF.SurfaceNormal(knn=10, orient=orient), tc)
    nj = np.asarray(out_j.descriptors["normals"])
    nt = out_t.descriptors["normals"].numpy()
    if not orient:
        sign = np.where(np.sum(nj * nt, axis=1, keepdims=True) < 0, -1, 1)
        nt = nt * sign
    np.testing.assert_allclose(nt, nj, rtol=0, atol=NORMAL_TOL)
    np.testing.assert_allclose(
        out_t.descriptors["surfaceCurvature"].numpy(),
        np.asarray(out_j.descriptors["surfaceCurvature"]), rtol=0,
        atol=NORMAL_TOL)
    np.testing.assert_array_equal(out_t.mask.numpy(), np.asarray(out_j.mask))


# -- outlier filters -----------------------------------------------------------

OUTLIER_CASES = [
    ("TrimmedDist", {"ratio": 0.8}),
    ("MaxDist", {"max_dist": 0.7}),
    ("MedianDist", {"factor": 1.5}),
    ("VarTrimmedDist", {}),
    ("VarTrimmedDist", {"min_ratio": 0.05, "max_ratio": 0.99, "lam": 2.35}),
    ("SurfaceNormalOutlier", {"max_angle": 0.6}),
]


def _matches(seed=3, nq=500, k=2):
    """Bimodal distances (inliers and gross outliers), a few invalid
    matches and masked queries, and normals at both ends."""
    rng = np.random.default_rng(seed)
    d2 = np.where(rng.uniform(size=(nq, k)) < 0.6,
                  rng.uniform(0, 0.05, (nq, k)),
                  rng.uniform(1.0, 9.0, (nq, k))).astype(np.float32)
    d2[::23, -1] = np.inf
    ids = rng.integers(0, 100, (nq, k)).astype(np.int32)
    qm = np.ones(nq, bool)
    qm[::31] = False
    rn = rng.normal(size=(nq, 3)).astype(np.float32)
    fn = rng.normal(size=(nq, k, 3)).astype(np.float32)
    return d2, ids, qm, rn, fn


def _weights(chain_j, chain_t, normals, k=2):
    d2, ids, qm, rn, fn = _matches(k=k)
    extra_j = (jnp.asarray(rn), jnp.asarray(fn)) if normals else (None, None)
    extra_t = (torch.from_numpy(rn), torch.from_numpy(fn)) if normals \
        else (None, None)
    wj = JO.compute_weights(chain_j, JMatches(jnp.asarray(d2),
                                              jnp.asarray(ids)),
                            jnp.asarray(qm), *extra_j)
    wt = TO.compute_weights(chain_t, TMatches(torch.from_numpy(d2),
                                              torch.from_numpy(ids)),
                            torch.from_numpy(qm), *extra_t)
    return np.asarray(wj), wt.numpy()


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("case", range(len(OUTLIER_CASES)))
def test_outlier_weights_match_jax(case, normals):
    name, kw = OUTLIER_CASES[case]
    jcfg, tcfg = getattr(JO, name)(**kw), getattr(TO, name)(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    wj, wt = _weights((jcfg,), (tcfg,), normals)
    np.testing.assert_array_equal(wt, wj)
    if name == "SurfaceNormalOutlier" and not normals:
        d2, _, qm, _, _ = _matches()
        np.testing.assert_array_equal(wt, np.isfinite(d2) & qm[:, None])


def test_outlier_chain_of_all_five_matches_jax():
    chain = [(getattr(JO, n)(**kw), getattr(TO, n)(**kw))
             for n, kw in OUTLIER_CASES[1:]]
    wj, wt = _weights(tuple(c[0] for c in chain),
                      tuple(c[1] for c in chain), True)
    np.testing.assert_array_equal(wt, wj)
    assert 0 < wt.sum() < wt.size


def test_surface_normal_outlier_passes_through_in_the_icp_loop():
    """The ICP loop weighs matches without normals (as
    pgslam_tpu/ops/icp.py:185 does), so SurfaceNormalOutlier keeps every
    valid match there: a registration with it equals one without."""
    from pgslam_tpu_torch.ops.icp import ICPConfig, icp_core
    rng = np.random.default_rng(0)
    ref = rng.uniform(-4, 4, (400, 3)).astype(np.float32)
    ref[:, 2] = np.round(ref[:, 2])
    reading = tmake(ref[:300] + np.float32([0.05, -0.03, 0.0]))
    refc = tmake(ref, descriptors={"normals": np.tile(
        np.float32([0, 0, 1]), (400, 1))})
    base = ICPConfig(outlier=(TO.TrimmedDist(0.9), TO.MaxDist(1.0)))
    with_sno = dataclasses.replace(base, outlier=base.outlier + (
        TO.SurfaceNormalOutlier(max_angle=0.01),))
    T0 = torch.eye(4)
    a = icp_core(reading, refc, T0, base)
    b = icp_core(reading, refc, T0, with_sno)
    assert torch.equal(a.T, b.T) and int(a.iterations) == int(b.iterations)
    assert float(a.overlap) == float(b.overlap)
