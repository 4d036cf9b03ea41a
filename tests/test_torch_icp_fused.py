"""K2 (a whole ICP registration): the port's plain version against the JAX
icp_core at the tolerances of tests/test_icp_fused.py, and against the
Pallas kernel in interpret mode (slow tier). The CUDA kernel is held
against the plain version in tests/test_torch_gpu.py."""

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
from pgslam_tpu.ops.icp import icp_core as j_icp_core
from pgslam_tpu_torch import se3 as tse3
from pgslam_tpu_torch.cloud import make_cloud as tmake
from pgslam_tpu_torch.cloud import stack_clouds as tstack
from pgslam_tpu_torch.convert import config_from_dict, config_to_dict
from pgslam_tpu_torch.ops.icp import ICPConfig as TICPConfig
from pgslam_tpu_torch.ops.icp import ICPEngine as TEngine
from pgslam_tpu_torch.ops.icp_fused import fused_eligible, fused_icp_register


def _cfg(**kw):
    """tests/test_icp_fused.py::_cfg for both packages."""
    base = dict(error="point_to_plane", matcher="pallas",
                outlier=(JO.TrimmedDist(0.9), JO.MaxDist(1.0)),
                reference_filters=(JF.SurfaceNormal(knn=8),),
                max_iterations=12, trans_eps=1e-4, rot_eps=1e-4,
                coarse_div=4, coarse_iterations=4)
    base.update(kw)
    j = JICPConfig(**base)
    return j, config_from_dict(TICPConfig, config_to_dict(j))


def _scene(n=420, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    pts[:, 2] = np.sign(pts[:, 2]) * 2 + \
        rng.normal(size=n).astype(np.float32) * 0.1
    return rng, pts


def _pair(jcfg, tcfg, capacity=512, dup=0):
    rng, pts = _scene()
    if dup:
        pts = np.concatenate([pts, pts[:dup]])
    off = np.asarray(jse3.exp(jnp.asarray(
        [0.2, -0.1, 0.05, 0.02, -0.03, 0.04], jnp.float32)))
    moved = ((pts - off[:3, 3]) @ off[:3, :3]).astype(np.float32)
    moved += rng.normal(size=moved.shape).astype(np.float32) * 0.01
    je, te = JEngine(jcfg), TEngine(tcfg)
    je.set_map(jmake(pts, capacity=capacity))
    te.set_map(tmake(pts, capacity=capacity))
    return (je, jmake(moved, capacity=capacity)), \
        (te, tmake(moved, capacity=capacity))


def _port(te, reading, tcfg, B=1):
    return fused_icp_register(tstack([reading] * B),
                              tstack([te.reference] * B),
                              torch.eye(4).expand(B, 4, 4).contiguous(), tcfg)


@pytest.mark.parametrize("kw", [{}, {"coarse_div": 0},
                                {"outlier": (JO.MaxDist(1.0),)},
                                {"error": "point_to_point",
                                 "reference_filters": ()}])
def test_plain_matches_icp_core(kw):
    jcfg, tcfg = _cfg(**kw)
    assert fused_eligible(tcfg)
    (je, jr), (te, tr) = _pair(jcfg, tcfg)
    rx = j_icp_core(jr, je.reference, jse3.identity(), jcfg)
    rf = _port(te, tr, tcfg, B=2)
    d = tse3.log(tse3.inverse(rf.T[0]) @ torch.from_numpy(np.array(rx.T)))
    # test_icp_fused.py's bounds: 1e-5 p2plane, 5e-5 p2point (polar vs SVD)
    assert float(d.norm()) < (5e-5 if kw.get("error") else 1e-5)
    if not kw.get("error"):
        # Point-to-point stops apart by design, as in test_icp_fused.py:
        # icp_core's arccos angle is quantized to ~3.4e-4 rad in fp32,
        # above rot_eps, while K2 reads the twist of its step.
        assert abs(int(rf.iterations[0]) - int(rx.iterations)) <= 1
        assert bool(rf.converged[0]) == bool(rx.converged)
    np.testing.assert_allclose(float(rf.overlap[0]), float(rx.overlap),
                               atol=0.02 if kw.get("error") else 0.01)
    np.testing.assert_allclose(float(rf.residual[0]), float(rx.residual),
                               rtol=0.05 if kw.get("error") else 0.02)
    cx = np.asarray(rx.cov)
    np.testing.assert_allclose(rf.cov[0].numpy(), cx,
                               atol=1e-8 + 0.05 * np.abs(cx).max())
    np.testing.assert_array_equal(rf.T[0].numpy(), rf.T[1].numpy())


def test_duplicate_references_average_to_the_same_match():
    jcfg, tcfg = _cfg()
    (je, jr), (te, tr) = _pair(jcfg, tcfg, capacity=1024, dup=80)
    rx = j_icp_core(jr, je.reference, jse3.identity(), jcfg)
    rf = _port(te, tr, tcfg)
    d = tse3.log(tse3.inverse(rf.T[0]) @ torch.from_numpy(np.array(rx.T)))
    assert float(d.norm()) < 1e-5
    assert torch.isfinite(rf.cov).all()


def test_degenerate_reading_and_bound_checker():
    jcfg, tcfg = _cfg()
    (_, _), (te, tr) = _pair(jcfg, tcfg)
    dead = tmake(np.zeros((4, 3), np.float32), mask=np.zeros(4, bool),
                 capacity=512)
    rf = _port(te, dead, tcfg)
    np.testing.assert_allclose(rf.T[0].numpy(), np.eye(4), atol=1e-6)
    assert torch.isfinite(rf.cov).all() and float(rf.overlap[0]) == 0.0
    _, tcfg = _cfg(max_correction_trans=0.01)
    rf = _port(te, tr, tcfg)
    assert bool(rf.diverged[0]) and not bool(rf.converged[0])
    np.testing.assert_allclose(rf.T[0].numpy(), np.eye(4), atol=1e-6)


def test_eligibility_gate():
    from pgslam_tpu.ops.icp_pallas import fused_eligible as j_eligible
    assert fused_eligible(_cfg(error="point_to_point")[1])
    # Anderson windows as the JAX package takes them: m <= 4 in-kernel.
    for m, ok in ((3, True), (4, True), (5, False)):
        jcfg, tcfg = _cfg(anderson_m=m)
        assert fused_eligible(tcfg) == j_eligible(jcfg) == ok, m
    assert not fused_eligible(_cfg(knn=2)[1])
    # The JAX package's gate: two filters of one kind and any checker
    # window run K2.
    for kw in ({"outlier": (JO.TrimmedDist(0.9), JO.TrimmedDist(0.8))},
               {"outlier": (JO.MaxDist(1.0), JO.MaxDist(0.5))},
               {"smooth_length": 12}):
        jcfg, tcfg = _cfg(**kw)
        assert fused_eligible(tcfg) == j_eligible(jcfg) == True, kw  # noqa
    with pytest.raises(ValueError):
        fused_icp_register(None, None, None, _cfg(knn=2)[1])


CHAIN4 = (JO.TrimmedDist(0.95), JO.MaxDist(1.5), JO.TrimmedDist(0.9),
          JO.MaxDist(-1.0))


def test_outlier_chain_reduces_to_one_filter_of_each_kind():
    """Two TrimmedDist and two MaxDist give the weights of the smallest
    ratio and the smallest distance, bit for bit: filter by filter on
    one set of distances, and through K2's plain version."""
    from pgslam_tpu_torch.ops import outlier as TO
    from pgslam_tpu_torch.ops.icp_fused import _outlier_params, _weights
    _, tcfg4 = _cfg(outlier=CHAIN4)
    assert _outlier_params(tcfg4) == (0.9, 1.0)
    rng = np.random.default_rng(3)
    d2 = torch.as_tensor(rng.exponential(0.6, 500), dtype=torch.float32)
    hit = torch.as_tensor(rng.random(500) > 0.1)
    d2 = torch.where(hit, d2, float("inf"))
    chained = hit.float()
    for f in tcfg4.outlier:
        if isinstance(f, TO.TrimmedDist):
            chained = chained * (d2 <= TO.trimmed_threshold(d2, hit, f.ratio)
                                 ).float()
        else:
            chained = chained * (d2 <= f.max_dist * f.max_dist).float()
    assert 0 < int(chained.sum()) < int(hit.sum())
    assert torch.equal(_weights(d2, hit, *_outlier_params(tcfg4)), chained)
    _, tcfg2 = _cfg()
    (_, _), (te, tr) = _pair(*_cfg())
    assert torch.equal(_port(te, tr, tcfg4).T, _port(te, tr, tcfg2).T)


def test_plain_with_chain_of_four_matches_icp_core():
    """test_plain_matches_icp_core's comparison with the chain of four."""
    jcfg, tcfg = _cfg(outlier=CHAIN4)
    (je, jr), (te, tr) = _pair(jcfg, tcfg)
    rx = j_icp_core(jr, je.reference, jse3.identity(), jcfg)
    rf = _port(te, tr, tcfg)
    d = tse3.log(tse3.inverse(rf.T[0]) @ torch.from_numpy(np.array(rx.T)))
    assert float(d.norm()) < 1e-5
    np.testing.assert_allclose(float(rf.overlap[0]), float(rx.overlap),
                               atol=0.02)
    np.testing.assert_allclose(float(rf.residual[0]), float(rx.residual),
                               rtol=0.05)


@pytest.mark.slow
def test_plain_matches_fused_pallas_interpret():
    from pgslam_tpu.ops.icp_pallas import fused_icp_register as pallas_reg
    jcfg, tcfg = _cfg(coarse_div=0)
    (je, jr), (te, tr) = _pair(jcfg, tcfg)
    rp = pallas_reg(jstack([jr]), jstack([je.reference]),
                    jnp.tile(jse3.identity(), (1, 1, 1)), jcfg, tile_r=256)
    rf = _port(te, tr, tcfg)
    d = tse3.log(tse3.inverse(rf.T[0]) @ torch.from_numpy(np.array(rp.T[0])))
    assert float(d.norm()) < 1e-5
    assert abs(int(rf.iterations[0]) - int(rp.iterations[0])) <= 1
    np.testing.assert_allclose(float(rf.overlap[0]), float(rp.overlap[0]),
                               atol=0.01)


# -- the kernel's pieces, mirrored on the CPU ---------------------------------

def _threshold_case(kind, n, seed):
    """Squared distances with heavy ties, zeros, subnormals and misses."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        d2 = rng.integers(0, 5, n).astype(np.float32) * np.float32(0.25)
    elif kind == "zeros":
        d2 = np.where(rng.random(n) < 0.5, 0.0, rng.exponential(1, n))
    elif kind == "subnormal":
        d2 = rng.integers(1, 50, n) * np.float32(1e-45)
    else:
        d2 = rng.exponential(1.0, n) * 10.0 ** rng.integers(-30, 30, n)
    d2 = torch.as_tensor(np.asarray(d2, np.float32))
    hit = torch.as_tensor(rng.random(n) > 0.15)
    hit[0] = True
    return torch.where(hit, d2, float("inf")), hit


@pytest.mark.parametrize("kind", ["ties", "zeros", "subnormal", "wide"])
@pytest.mark.parametrize("ratio", ["k=1", 0.3, 0.85, "k=n"])
def test_radix_threshold_equals_sort(kind, ratio):
    """The kernel's radix select (four 8-bit passes over the float bits)
    finds the sort's kth-smallest hit distance, bit for bit."""
    from pgslam_tpu_torch.ops import outlier as TO
    from pgslam_tpu_torch.ops.icp_fused import radix_threshold
    for seed, n in ((0, 1), (1, 37), (2, 700), (3, 4096)):
        d2, hit = _threshold_case(kind, n, seed)
        n_hit = int(hit.sum())
        r = {"k=1": 1.0 / n_hit if n_hit > 1 else 1.0,
             "k=n": 1.0}.get(ratio, ratio)
        got = radix_threshold(d2, hit, r)
        want = TO.trimmed_threshold(d2, hit, r)
        assert got.view(torch.int32) == want.view(torch.int32), (n, r)
    assert radix_threshold(d2, torch.zeros_like(hit), 0.5) == float("inf")


LAYOUT_SHAPES = {"headline": (1024, 8192, 128),
                 "verification": (2048, 8192, 1),
                 "loop_replay": (512, 2048, 1),
                 "fleet": (1024, 4096, 16),
                 "fleet_verification": (1024, 8192, 17),
                 "velodyne_keyframes": (65536, 8192, 16)}


@pytest.mark.parametrize("shape", list(LAYOUT_SHAPES))
def test_k2_layout_fits_and_covers_every_point_once(shape):
    """At the main path's shapes: C <= 16 and a divisor of the tree's 16
    slot chunks, each CTA within the H100's 232,448 bytes, every reading
    point of both stages matched exactly once against every map point,
    and the reduction order a function of nothing."""
    from pgslam_tpu_torch.ops import icp_fused as K
    nq, nr, batch = LAYOUT_SHAPES[shape]
    lay = K.k2_layout(nq, nr, batch)
    assert lay.clusters in (1, 2, 4, 8, 16) and lay.clusters <= 16
    need = K.cta_bytes(lay.map_cap, lay.local_chunks, lay.slices)
    assert need <= lay.smem_bytes <= 232448
    waves = -(-batch // K.H100_ACTIVE_CLUSTERS[lay.clusters])
    # one wave, unless the batch exceeds the card even at C = 1 or the
    # reading needed a wider cluster to fit (the map then streams)
    assert waves == 1 or lay.clusters == 1 or lay.map_cap < nr
    if waves == 1:                            # one CTA per SM
        assert 2 * (lay.smem_bytes + 1024) > 228 * 1024
    for n, coarse in ((nq, False), (-(-nq // 8), True)):
        pairs = np.zeros(n, np.int64)
        for rank in range(lay.clusters):
            for idx, (lo, hi) in K.k2_items(lay, n, nr, rank, coarse):
                idx = np.asarray(idx)
                real = idx[idx < n]
                # only the tail of the stage's last chunk lies past n
                assert len(real) > len(idx) - K.CHUNK
                pairs[real] += hi - lo
        # each point meets every map point once over slices and passes
        assert (pairs == nr).all()
    for other in (1, 16, 128, 1000):
        o = K.k2_layout(nq, nr, other)
        assert (o.chunk, o.tree) == (lay.chunk, lay.tree) == (32, 512)
    assert K.k2_layout(nq, nr, batch, budget=10**9).map_cap == nr


def test_k2_layout_forced_and_refused():
    from pgslam_tpu_torch.ops.icp_fused import k2_layout
    lay = k2_layout(640, 640, 3, clusters=4, slices=5)
    assert (lay.clusters, lay.slices) == (4, 5)
    with pytest.raises(ValueError):
        k2_layout(640, 640, 3, clusters=3)
    with pytest.raises(ValueError):
        k2_layout(10**6, 8192, 1)
    # the largest cluster whose batch fits the card at once
    assert [k2_layout(1024, 8192, b).clusters
            for b in (1, 7, 8, 15, 16, 30, 31, 66, 67, 128, 300)] == \
        [16, 16, 8, 8, 4, 4, 2, 2, 1, 1, 1]


@pytest.mark.parametrize("error", ["point_to_plane", "point_to_point"])
def test_plain_averages_ties_across_map_slices(error):
    """The card test's scene (test_torch_gpu.py::_slice_tie_scene): each
    of 128 map points repeats 512 indices later with another normal; the
    plain version averages the two, which is map B's registration (the
    repeats masked, the mean normal in place) bit for bit, and not that of
    the first copy alone."""
    from test_torch_gpu import _slice_tie_scene
    from pgslam_tpu_torch.ops.icp import ICPConfig
    from pgslam_tpu_torch.ops import outlier as TO
    from pgslam_tpu_torch.ops.icp_fused import fused_icp_register_plain
    rd, A, B = _slice_tie_scene("cpu")
    cfg = ICPConfig(error=error, outlier=(TO.TrimmedDist(0.9),
                                          TO.MaxDist(1.0)),
                    max_iterations=12, coarse_div=0)
    T0 = torch.eye(4)[None]
    a = fused_icp_register_plain(rd, A, T0, cfg)
    assert torch.equal(a, fused_icp_register_plain(rd, B, T0, cfg))
    first_only = B.replace(descriptors={"normals": A.descriptors["normals"]})
    if error == "point_to_plane":
        assert not torch.equal(
            a, fused_icp_register_plain(rd, first_only, T0, cfg))
