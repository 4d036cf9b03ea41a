"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the slice on the card. Every test here needs an NVIDIA GPU and
skips without one; the file imports torch and the port only, so it runs
where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from pgslam_tpu_torch import se3
from pgslam_tpu_torch.cloud import make_cloud, stack_clouds
from pgslam_tpu_torch.ops import filters as F
from pgslam_tpu_torch.ops import outlier as O
from pgslam_tpu_torch.ops.icp import ICPConfig
from pgslam_tpu_torch.ops.icp_fused import (fused_icp_register,
                                            fused_icp_register_plain)
from pgslam_tpu_torch.ops.knn import THREADS, k1_layout, knn, knn_plain
from pgslam_tpu_torch.optim import pgo
from pgslam_tpu_torch.optim.lm import lm_optimize
from pgslam_tpu_torch.optim.pcg import k4_plan, pcg_solve
from pgslam_tpu_torch.optim.pgo import PGOConfig, lm_optimize_plain
from pgslam_tpu_torch.pgo_problems import bucketed_problem, pose_graph_problem

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels are CUDA")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [1, 8])
def test_k1_matches_plain(cuda, k):
    rng = np.random.default_rng(7)
    q = torch.as_tensor(rng.uniform(-40, 40, (3000, 3)), dtype=torch.float32,
                        device=cuda)
    r = torch.as_tensor(rng.uniform(-40, 40, (5000, 3)), dtype=torch.float32,
                        device=cuda)
    qm = torch.ones(3000, dtype=torch.bool, device=cuda)
    qm[1] = False
    rm = torch.ones(5000, dtype=torch.bool, device=cuda)
    rm[4500:] = False
    before = knn.launches
    mk = knn(q, qm, r, rm, k=k)
    mp = knn_plain(q, qm, r, rm, k=k)
    torch.cuda.synchronize()
    assert knn.launches == before + 1
    assert torch.equal(mk.ids, mp.ids)
    fin = torch.isfinite(mp.dists2)
    assert torch.equal(fin, torch.isfinite(mk.dists2))
    assert float((mk.dists2[fin] - mp.dists2[fin]).abs().max()) < 1e-3


def _k1_inputs(cuda, nq, nr, seed=3):
    """Scan-like inputs: references on a few planes with duplicates far
    apart in id, queries near them, some of each masked."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-30, 30, (nr, 3)).astype(np.float32)
    r[::3, 2] = np.round(r[::3, 2] / 5) * 5
    r[nr - nr // 8:] = r[:nr // 8]
    q = (r[rng.integers(0, nr, nq)] + rng.normal(0, 0.05, (nq, 3))
         ).astype(np.float32)
    qm = np.ones(nq, bool)
    qm[::97] = False
    rm = np.ones(nr, bool)
    rm[nr // 3:nr // 3 + nr // 16] = False
    return tuple(torch.as_tensor(a, device=cuda) for a in (q, qm, r, rm))


@pytest.mark.parametrize("S", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("nq,nr,k", [(512, 3000, 1), (2048, 8192, 1),
                                     (8192, 8192, 8)])
def test_k1_forced_layouts_match_plain(cuda, nq, nr, k, S):
    """Every forced slice count and threads a CTA gives knn_plain's ids
    and finite pattern, and d2 within 1e-5 of its scale."""
    q, qm, r, rm = _k1_inputs(cuda, nq, nr)
    mp = knn_plain(q, qm, r, rm, k=k)
    fin = torch.isfinite(mp.dists2)
    for T in THREADS:
        lay = k1_layout(nq, nr, k, 132, slices=S, threads=T)
        mk = knn(q, qm, r, rm, k=k, layout=lay)
        torch.cuda.synchronize()
        assert knn.layout == lay
        assert torch.equal(mk.ids, mp.ids), lay
        assert torch.equal(torch.isfinite(mk.dists2), fin), lay
        scale = float(mp.dists2[fin].abs().max())
        assert float((mk.dists2[fin] - mp.dists2[fin]).abs().max()) \
            <= 1e-5 * max(1.0, scale), lay


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("S", [2, 4, 16])
def test_k1_ties_across_slices_as_on_the_cpu(cuda, S, k):
    """Exact duplicates k copies deep, spread over the slices, queries on
    lattice points equidistant from several references, a fully masked
    slice and masked queries: the card's ids are the CPU's."""
    rng = np.random.default_rng(S + k)
    base = np.round(rng.uniform(-4, 4, (300, 3))).astype(np.float32)
    r = np.tile(base, (k, 1))
    q = np.concatenate([base[::7], np.round(rng.uniform(-4, 4, (200, 3)))
                        ]).astype(np.float32)
    qm = np.ones(len(q), bool)
    qm[5::11] = False
    rm = np.ones(len(r), bool)
    rm[len(r) // S:2 * len(r) // S] = False
    cpu = knn_plain(*(torch.from_numpy(a) for a in (q, qm, r, rm)), k=k)
    lay = k1_layout(len(q), len(r), k, 132, slices=S)
    mk = knn(*(torch.as_tensor(a, device=cuda) for a in (q, qm, r, rm)), k=k,
             layout=lay)
    assert torch.equal(mk.ids.cpu(), cpu.ids)
    assert torch.equal(mk.dists2.cpu(), cpu.dists2)


def test_k1_rejects_non_contiguous(cuda):
    q = torch.zeros((16, 3), device=cuda)[::2]
    m = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        knn(q, m, q, m)


def _icp_pair(cuda, error):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (420, 3)).astype(np.float32)
    pts[:, 2] = np.sign(pts[:, 2]) * 2 + rng.normal(size=420) * 0.1
    off = se3.exp(torch.tensor([0.2, -0.1, 0.05, 0.02, -0.03, 0.04])).numpy()
    moved = ((pts - off[:3, 3]) @ off[:3, :3]
             + rng.normal(size=pts.shape) * 0.01).astype(np.float32)
    cfg = ICPConfig(error=error, outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)),
                    max_iterations=12, coarse_div=4, coarse_iterations=4)
    ref = make_cloud(pts, capacity=512, device=cuda)
    if error == "point_to_plane":
        ref = F.compute_normals(ref)
    reading = make_cloud(moved, capacity=512, device=cuda)
    return cfg, stack_clouds([reading] * 3), stack_clouds([ref] * 3)


def _assert_k2_matches_plain(res, rows):
    """Phase k2's limits, per entry."""
    B = rows.shape[0]
    assert float((res.T - rows[:, :16].reshape(B, 4, 4)).abs().max()) < 1e-4
    assert torch.equal(res.iterations, rows[:, 16].to(torch.int32))
    assert torch.equal(res.converged, rows[:, 17] > 0.5)
    torch.testing.assert_close(res.overlap, rows[:, 18], atol=1e-4, rtol=0)
    torch.testing.assert_close(res.residual, rows[:, 19], atol=0, rtol=1e-4)
    cov = rows[:, 20:56].reshape(B, 6, 6)
    scale = cov.abs().amax(dim=(1, 2), keepdim=True)
    assert bool(((res.cov - cov).abs() <= 1e-3 * scale).all())


@pytest.mark.parametrize("error", ["point_to_plane", "point_to_point"])
def test_k2_matches_plain(cuda, error):
    cfg, rd, rf = _icp_pair(cuda, error)
    T0 = torch.eye(4, device=cuda).expand(3, 4, 4).contiguous()
    before = fused_icp_register.launches
    res = fused_icp_register(rd, rf, T0, cfg)
    rows = fused_icp_register_plain(rd, rf, T0, cfg)
    torch.cuda.synchronize()
    assert fused_icp_register.launches == before + 1
    _assert_k2_matches_plain(res, rows)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_k2_anderson_matches_plain(cuda, m):
    """The AA stage in K2 against the plain version's _stage_aa, which
    solves the window's system in the same closed form."""
    import dataclasses
    cfg, rd, rf = _icp_pair(cuda, "point_to_plane")
    cfg = dataclasses.replace(cfg, anderson_m=m, trans_eps=1e-4,
                              rot_eps=1e-4)
    T0 = torch.eye(4, device=cuda).expand(3, 4, 4).contiguous()
    res = fused_icp_register(rd, rf, T0, cfg)
    rows = fused_icp_register_plain(rd, rf, T0, cfg)
    _assert_k2_matches_plain(res, rows)


def test_k2_long_checker_window_matches_plain(cuda):
    """A checker window of 12 steps (any length runs K2, as in the JAX
    package), with room to converge, against the plain version."""
    import dataclasses
    cfg, rd, rf = _icp_pair(cuda, "point_to_plane")
    cfg = dataclasses.replace(cfg, smooth_length=12, max_iterations=40)
    T0 = torch.eye(4, device=cuda).expand(3, 4, 4).contiguous()
    res = fused_icp_register(rd, rf, T0, cfg)
    rows = fused_icp_register_plain(rd, rf, T0, cfg)
    assert int(res.iterations[0]) >= 12
    _assert_k2_matches_plain(res, rows)


def _box_problems(cuda, n_distinct, seed=0, capacity=(640, 640)):
    """Distinct registrations: points on the faces of a box, each moved by
    its own odometry-sized offset (bench.py's twist scales), in clouds of
    the given (reading, reference) capacities."""
    rng = np.random.default_rng(seed)
    half = np.array([4.0, 3.0, 2.0])
    rds, rfs = [], []
    for _ in range(n_distinct):
        pts = rng.uniform(-1, 1, (600, 3)) * half
        face = rng.integers(0, 6, 600)
        axis = face % 3
        pts[np.arange(600), axis] = (np.where(face < 3, 1.0, -1.0)
                                     * half[axis]
                                     + rng.normal(size=600) * 0.02)
        off = se3.exp(torch.as_tensor(
            rng.normal(size=6) * [0.15, 0.15, 0.03, 0.005, 0.005, 0.02],
            dtype=torch.float32)).numpy()
        moved = ((pts - off[:3, 3]) @ off[:3, :3]
                 + rng.normal(size=pts.shape) * 0.01).astype(np.float32)
        rfs.append(F.compute_normals(make_cloud(
            pts.astype(np.float32), capacity=capacity[1], device=cuda)))
        rds.append(make_cloud(moved, capacity=capacity[0], device=cuda))
    return rds, rfs


def test_k2_batch_entries_are_independent(cuda):
    """B = 16 (the fleet's batch): 12 distinct problems and 4 duplicates.
    Each entry gives the bits of its own B = 1 launch, duplicates equal
    their originals, and every entry holds phase k2's limits against the
    plain version."""
    rds, rfs = _box_problems(cuda, 12)
    rds, rfs = rds + rds[:4], rfs + rfs[:4]
    cfg = ICPConfig(outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)),
                    max_iterations=12, coarse_div=4, coarse_iterations=4)
    rd, rf = stack_clouds(rds), stack_clouds(rfs)
    T0 = torch.eye(4, device=cuda).expand(16, 4, 4).contiguous()
    before = fused_icp_register.batch_sizes[16]
    res = fused_icp_register(rd, rf, T0, cfg)
    assert fused_icp_register.batch_sizes[16] == before + 1
    fields = ("T", "iterations", "converged", "overlap", "residual", "cov")
    for b in range(16):
        one = fused_icp_register(stack_clouds([rds[b]]),
                                 stack_clouds([rfs[b]]), T0[:1], cfg)
        for f in fields:
            assert torch.equal(getattr(res, f)[b], getattr(one, f)[0]), (b, f)
    for b in range(4):
        for f in fields:
            assert torch.equal(getattr(res, f)[b], getattr(res, f)[12 + b])
    _assert_k2_matches_plain(res, fused_icp_register_plain(rd, rf, T0, cfg))


def _forced_layouts(nq, nr, B):
    """K2 layouts at several cluster sizes C and map slice counts S, and
    one whose map streams through the CTA in passes of 160 points."""
    import dataclasses
    from pgslam_tpu_torch.ops.icp_fused import cta_bytes, k2_layout
    out = [k2_layout(nq, nr, B, clusters=C, slices=S)
           for C, S in ((1, 1), (2, 1), (1, 4), (4, 2), (8, 5), (16, 16))]
    lay = k2_layout(nq, nr, B, clusters=2, slices=2)
    out.append(dataclasses.replace(lay, map_cap=160, smem_bytes=cta_bytes(
        160, lay.local_chunks, lay.slices)))
    return out


K2_BIT_FIELDS = ("T", "iterations", "converged", "overlap", "residual",
                 "cov")


@pytest.mark.parametrize("error,m", [("point_to_plane", 0),
                                     ("point_to_point", 0),
                                     ("point_to_plane", 3)])
def test_k2_bits_do_not_depend_on_the_layout(cuda, error, m):
    """Forced cluster sizes (1-16), map slices (1-16) and a streamed map
    give the bits of the layout K2 chooses, entry by entry, with a
    reading of 650 slots (its last chunk and the coarse stage's partly
    empty)."""
    rds, rfs = _box_problems(cuda, 3, capacity=(650, 700))
    rd, rf = stack_clouds(rds), stack_clouds(rfs)
    cfg = ICPConfig(error=error, outlier=(O.TrimmedDist(0.9),
                                          O.MaxDist(1.0)),
                    max_iterations=12, coarse_div=4, coarse_iterations=4,
                    anderson_m=m)
    T0 = torch.eye(4, device=cuda).expand(3, 4, 4).contiguous()
    res = fused_icp_register(rd, rf, T0, cfg)
    layouts = _forced_layouts(650, 700, 3)
    assert fused_icp_register.layout not in layouts
    for lay in layouts:
        forced = fused_icp_register(rd, rf, T0, cfg, layout=lay)
        assert fused_icp_register.layout == lay
        for f in K2_BIT_FIELDS:
            assert torch.equal(getattr(res, f), getattr(forced, f)), (lay, f)
    _assert_k2_matches_plain(res, fused_icp_register_plain(rd, rf, T0, cfg))


def _slice_tie_scene(device, seed=0):
    """Two maps for one reading. Map A: 512 box points with their normals,
    then its first 128 points again (indices 512-639) with other unit
    normals, so that each repeat ties its original exactly and lies in
    another map slice. Map B: the same with the repeats masked and each
    original's normal the fp32 mean of the two. Tie averaging makes A and
    B the same registration, bit for bit. Returns (reading, A, B), each a
    batch of one."""
    rng = np.random.default_rng(seed)
    half = np.array([4.0, 3.0, 2.0])
    pts = rng.uniform(-1, 1, (512, 3)) * half
    face = rng.integers(0, 6, 512)
    axis = face % 3
    pts[np.arange(512), axis] = (np.where(face < 3, 1.0, -1.0) * half[axis]
                                 + rng.normal(size=512) * 0.02)
    pts = pts.astype(np.float32)
    n1 = F.compute_normals(make_cloud(pts)).descriptors["normals"].numpy()
    n2 = n1[:128] + rng.normal(size=(128, 3)).astype(np.float32) * 0.3
    n2 = (n2 / np.linalg.norm(n2, axis=1, keepdims=True)).astype(np.float32)
    ptsA = np.concatenate([pts, pts[:128]])
    nA = np.concatenate([n1, n2])
    nB = nA.copy()
    nB[:128] = (n1[:128] + n2) / np.float32(2)
    mB = np.ones(640, bool)
    mB[512:] = False
    off = se3.exp(torch.tensor([0.1, -0.08, 0.03, 0.01, -0.02, 0.03])).numpy()
    moved = ((pts - off[:3, 3]) @ off[:3, :3]
             + rng.normal(size=pts.shape) * 0.01).astype(np.float32)
    lift = lambda c: stack_clouds([c])
    reading = lift(make_cloud(moved, device=device))
    A = lift(make_cloud(ptsA, descriptors={"normals": nA}, device=device))
    B = lift(make_cloud(ptsA, mask=mB, descriptors={"normals": nB},
                        device=device))
    return reading, A, B


@pytest.mark.parametrize("error", ["point_to_plane", "point_to_point"])
def test_k2_averages_ties_across_map_slices(cuda, error):
    """Each repeated map point lies in another slice than its original
    (S = 2 splits the map at 320, S = 5 at multiples of 128): K2 averages
    the two, and gives map B's bits in every layout."""
    rd, A, B = _slice_tie_scene(cuda)
    cfg = ICPConfig(error=error, outlier=(O.TrimmedDist(0.9),
                                          O.MaxDist(1.0)),
                    max_iterations=12, coarse_div=0)
    T0 = torch.eye(4, device=cuda)[None]
    want = fused_icp_register(rd, B, T0, cfg)
    for lay in [None] + _forced_layouts(512, 640, 1)[1:]:
        got = fused_icp_register(rd, A, T0, cfg, layout=lay)
        for f in K2_BIT_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (lay, f)
    _assert_k2_matches_plain(want, fused_icp_register_plain(rd, A, T0, cfg))


def test_k2_takes_a_velodyne_size_reading(cuda):
    """65,536 reading points (a Velodyne keyframe's capacity) against an
    8192-point map: a cluster of 16 CTAs with the map streaming through
    each, held to phase k2's limits of the plain version."""
    rng = np.random.default_rng(3)
    half = np.array([4.0, 3.0, 2.0])

    def box(n):
        pts = rng.uniform(-1, 1, (n, 3)) * half
        face = rng.integers(0, 6, n)
        axis = face % 3
        pts[np.arange(n), axis] = (np.where(face < 3, 1.0, -1.0)
                                   * half[axis] + rng.normal(size=n) * 0.02)
        return pts.astype(np.float32)

    off = se3.exp(torch.tensor([0.1, -0.05, 0.02, 0.01, -0.01, 0.02])).numpy()
    moved = ((box(65536) - off[:3, 3]) @ off[:3, :3]).astype(np.float32)
    rf = stack_clouds([F.compute_normals(make_cloud(box(8192), device=cuda))])
    rd = stack_clouds([make_cloud(moved, device=cuda)])
    cfg = ICPConfig(outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)),
                    max_iterations=4, coarse_div=8, coarse_iterations=2,
                    trans_eps=0.0, rot_eps=0.0)
    T0 = torch.eye(4, device=cuda)[None]
    res = fused_icp_register(rd, rf, T0, cfg)
    assert fused_icp_register.layout.clusters == 16
    assert fused_icp_register.layout.map_cap < 8192
    _assert_k2_matches_plain(res, fused_icp_register_plain(rd, rf, T0, cfg))


def test_batched_register_routes_to_k2_on_the_card(cuda):
    from pgslam_tpu_torch.parallel.batched import batched_register
    rds, rfs = _box_problems(cuda, 3)
    rd, rf = stack_clouds(rds), stack_clouds(rfs)
    T0 = torch.eye(4, device=cuda).expand(3, 4, 4).contiguous()
    cfg = ICPConfig(outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)),
                    max_iterations=12)
    before = fused_icp_register.launches
    fused = batched_register(rd, rf, T0, cfg)
    assert fused_icp_register.launches == before + 1
    plain = batched_register(rd, rf, T0, cfg, fused="off")
    assert fused_icp_register.launches == before + 1
    # K2 and icp_core differ by design (tie averaging, closed-form step)
    assert float((fused.T - plain.T).abs().max()) < 1e-3


def test_fleet_on_the_card(cuda):
    """tests/test_multi_agent.py::test_two_agents_share_graph's scene on
    the card: the fleet registers through K2 at its batch size."""
    from pgslam_tpu_torch.datasets import corridor_sequence
    from pgslam_tpu_torch.fleet_problems import fleet_config
    from pgslam_tpu_torch.parallel.multi_agent import MultiAgentSlam
    scans, odom, truth = corridor_sequence(
        np.random.default_rng(7), n_scans=12, scan_points=512, step=0.4,
        noise=0.003, odom_noise=0.005, length=30.0)
    fleet = MultiAgentSlam(fleet_config(), n_agents=2)
    before = fused_icp_register.batch_sizes[2]
    T_rs = np.eye(4, dtype=np.float32)
    for i in range(10):
        fleet.add_data_batch(i, "world", np.stack([odom[i], odom[i + 1]]),
                             T_rs, [scans[i], scans[i + 1]])
    assert fused_icp_register.batch_sizes[2] > before
    for b, i in ((0, 9), (1, 10)):
        assert np.linalg.norm(fleet.poses()[b][:3, 3]
                              - truth[i][:3, 3]) < 0.25
    assert fleet.get_graph().n_vertices >= 3


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_fleet_batched_preparation_has_each_agents_bits(cuda, dtype):
    """The fleet's input preparation at ``fleet16``'s shape on the card
    (16 scans of 512 and 768 points, sensor capacity 768, keyframe
    capacity 512; one pinned upload, then compaction and one batched
    transform): each agent's points and mask bit for bit those of
    ``make_cloud`` and ``prepare_input`` on its own cloud."""
    from pgslam_tpu_torch.cloud import make_cloud_batch
    from pgslam_tpu_torch.localizer import prepare_input, prepare_input_batched
    rng = np.random.default_rng(22)
    pts = [rng.normal(0, 5.0, (512 if b % 2 else 768, 3)) for b in range(16)]
    pts = [np.round(p * 1000).astype(np.int16) if dtype == "int16"
           else p.astype(np.float32) for p in pts]
    Ts = np.stack([se3.exp(torch.as_tensor(rng.normal(0, 0.5, 6),
                                           dtype=torch.float32)).numpy()
                   for _ in range(16)])
    raw, (T_dev,) = make_cloud_batch(pts, 768, cuda, riders=[Ts])
    prep = prepare_input_batched((), 512, raw, T_dev)
    assert prep.reading_batch is not None
    for b in range(16):
        one = make_cloud(pts[b], capacity=768, device=cuda)
        assert torch.equal(raw.points[b], one.points)
        assert torch.equal(raw.mask[b], one.mask)
        want = prepare_input((), 512, one, torch.as_tensor(Ts[b],
                                                           device=cuda))
        assert torch.equal(prep.clouds[b].points, want.points), b
        assert torch.equal(prep.clouds[b].mask, want.mask), b


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 8])
def test_merged_match_equals_k1_over_the_whole_reference(cuda, tp, k):
    """K1 on each of tp reference shards, merged (the sharded
    registration's match): ids, d2 and candidate points bit for bit those
    of K1 over the whole reference."""
    from pgslam_tpu_torch.parallel.multichip import shard_match
    q, qm, r, rm = _k1_inputs(cuda, 512, 1536)
    whole = knn(q, qm, r, rm, k=k)
    m = r.shape[0] // tp
    shards = [(r[j * m:(j + 1) * m], rm[j * m:(j + 1) * m], None)
              for j in range(tp)]
    got, pts, _ = shard_match(q, qm, shards, k, cuda)
    assert torch.equal(got.ids, whole.ids)
    assert torch.equal(got.dists2, whole.dists2)
    assert torch.equal(pts, r[whole.ids.long()])


def test_sharded_register_b1_equals_icp_core_on_the_card(cuda):
    """One agent a dp group on a one-card mesh: the sharded registration
    is the port's icp_core on the card, every field bit for bit."""
    from pgslam_tpu_torch.ops.icp import icp_core
    from pgslam_tpu_torch.parallel.multichip import make_mesh
    from pgslam_tpu_torch.parallel.sharded_icp import make_sharded_register
    rng = np.random.default_rng(5)
    B, N, M = 2, 256, 1024
    ref = rng.uniform(-3, 3, (B, M, 3)).astype(np.float32)
    ref[..., 2] = 0.3 * np.sin(ref[..., 0])
    rd = (ref[:, :N] + rng.normal(0, 0.02, (B, N, 3))).astype(np.float32)
    cfg = ICPConfig(max_iterations=20,
                    outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)))
    rdc = stack_clouds([make_cloud(rd[b], device=cuda) for b in range(B)])
    rfc = stack_clouds([make_cloud(ref[b], device=cuda) for b in range(B)])
    T0 = se3.exp(torch.full((B, 6), 0.02, device=cuda))
    mesh = make_mesh(2 * B, tp=2, devices=[cuda] * (2 * B))
    res = make_sharded_register(mesh, cfg)(rdc, rfc, T0)
    for b in range(B):
        one = icp_core(rdc.map(lambda a: a[b]), rfc.map(lambda a: a[b]),
                       T0[b], cfg)
        for name, v in vars(one).items():
            assert torch.equal(getattr(res, name)[b], v), (b, name)


def test_sharded_register_across_two_cards_equals_one_card(cuda):
    """A dp = 4 x tp = 2 mesh whose tp pairs span cuda:0 and cuda:1: K1
    launches on each shard's card, and the result is the one-card mesh's
    bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    from pgslam_tpu_torch.parallel.multichip import make_mesh
    from pgslam_tpu_torch.parallel.sharded_icp import make_sharded_register
    rng = np.random.default_rng(9)
    B, N, M = 4, 256, 1024
    ref = rng.uniform(-3, 3, (B, M, 3)).astype(np.float32)
    ref[..., 2] = 0.3 * np.sin(ref[..., 0])
    rd = (ref[:, :N] + rng.normal(0, 0.02, (B, N, 3))).astype(np.float32)
    cfg = ICPConfig(max_iterations=20,
                    outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)))
    rdc = stack_clouds([make_cloud(rd[b], device=cuda) for b in range(B)])
    rfc = stack_clouds([make_cloud(ref[b], device=cuda) for b in range(B)])
    T0 = se3.exp(torch.full((B, 6), 0.02, device=cuda))
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    one = make_sharded_register(make_mesh(8, tp=2, devices=cards[:1] * 8),
                                cfg)(rdc, rfc, T0)
    two = make_sharded_register(make_mesh(8, tp=2, devices=cards * 4),
                                cfg)(rdc, rfc, T0)
    for name, v in vars(one).items():
        assert torch.equal(getattr(two, name), v), name


def test_tp1_route_across_two_cards_equals_one_batch(cuda):
    """The tp = 1 mesh route: shard_batch puts the dp chunks on cuda:0
    and cuda:1, K2 launches once per chunk on its card, and the
    concatenated result is the unchunked K2 batch's bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    from pgslam_tpu_torch.ops.icp_fused import fused_icp_register
    from pgslam_tpu_torch.parallel.batched import (batched_register,
                                                   concat_results,
                                                   shard_batch)
    from pgslam_tpu_torch.parallel.multichip import make_mesh
    rdc, rfc = (stack_clouds(c) for c in _box_problems(cuda, 4))
    T0 = torch.eye(4, device=cuda).repeat(4, 1, 1)
    cfg = ICPConfig(outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)),
                    max_iterations=12)
    whole = batched_register(rdc, rfc, T0, cfg, fused="on")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    chunks = shard_batch(make_mesh(4, tp=1, devices=cards * 2))(
        (rdc, rfc, T0))
    assert [c[0].points.device for c in chunks] == cards * 2
    before = fused_icp_register.launches
    split = concat_results([batched_register(*c, cfg, fused="on")
                            for c in chunks], cuda)
    assert fused_icp_register.launches - before == 4
    for name, v in vars(whole).items():
        if v is not None:
            assert torch.equal(getattr(split, name), v), name


def _ring(cuda, V=40, seed=1):
    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(V) / V
    R = se3.exp_so3(torch.as_tensor(np.stack([0 * a, 0 * a, a], -1),
                                    dtype=torch.float32))
    t = torch.as_tensor(np.stack([10 * np.cos(a), 10 * np.sin(a), 0 * a], -1),
                        dtype=torch.float32)
    poses = se3.make(R, t)
    ef = np.concatenate([np.arange(V - 1), rng.integers(0, V, 33)])
    et = np.concatenate([np.arange(1, V), rng.integers(0, V, 33)])
    et[ef == et] = (et[ef == et] + 1) % V
    Ts = se3.inverse(poses[ef]) @ poses[et]
    init = poses.clone()
    init[1:] = init[1:] @ se3.exp(torch.as_tensor(
        rng.normal(size=(V - 1, 6)) * 0.05, dtype=torch.float32))
    E = len(ef)
    args = (init, torch.ones(V, dtype=torch.bool),
            torch.as_tensor(ef, dtype=torch.int32),
            torch.as_tensor(et, dtype=torch.int32), Ts,
            torch.eye(6).repeat(E, 1, 1) * 0.01,
            torch.ones(E, dtype=torch.bool))
    return tuple(x.to(cuda) for x in args) + (0,)


@pytest.mark.parametrize("robust", ["none", "huber"])
def test_k3_matches_plain(cuda, robust):
    args = _ring(cuda)
    rmask = torch.zeros(args[2].shape[0], dtype=torch.bool, device=cuda)
    rmask[39:] = True
    cfg = PGOConfig(max_iterations=4, cg_iterations=16, cg_tol=1e-3,
                    robust=robust)
    rm = None if robust == "none" else rmask
    before = lm_optimize.launches
    pk, sk = lm_optimize(*args, rm, config=cfg)
    pp, sp = lm_optimize_plain(*args, rm, config=cfg)
    torch.cuda.synchronize()
    assert lm_optimize.launches == before + 1
    assert float((pk[:, :3, 3] - pp[:, :3, 3]).norm(dim=1).max()) < 1e-4
    assert float((pk[:, :3, :3] - pp[:, :3, :3]).abs().max()) < 1e-4
    assert int(sk["iterations"]) == int(sp["iterations"])
    for key in ("initial_cost", "final_cost"):
        torch.testing.assert_close(sk[key], sp[key], atol=0, rtol=1e-3)


@pytest.mark.parametrize("robust", ["cauchy", "gm"])
def test_k3_in_a_cluster_matches_plain(cuda, robust):
    """test_k3_matches_plain on a graph that spreads over several CTAs,
    with the robust kernels that test does not take."""
    args, _ = pose_graph_problem(1024, 1025, device=cuda)
    rmask = torch.zeros(args[2].shape[0], dtype=torch.bool, device=cuda)
    rmask[1023:] = True
    cfg = PGOConfig(max_iterations=4, cg_iterations=16, cg_tol=1e-3,
                    robust=robust)
    pk, sk = lm_optimize(*args, rmask, config=cfg)
    assert lm_optimize.layout.clusters > 1
    # The yardstick runs on CPU copies, where index_add_ sums in order: on
    # the card it sums with atomics, and its costs do not repeat.
    cpu = [a.cpu() if torch.is_tensor(a) else a for a in (*args, rmask)]
    pp, sp = lm_optimize_plain(*cpu, config=cfg)
    pk, sk = pk.cpu(), {key: v.cpu() for key, v in sk.items()}
    assert float((pk[:, :3, 3] - pp[:, :3, 3]).norm(dim=1).max()) < 1e-4
    assert float((pk[:, :3, :3] - pp[:, :3, :3]).abs().max()) < 1e-4
    assert int(sk["iterations"]) == int(sp["iterations"])
    for key in ("initial_cost", "final_cost"):
        torch.testing.assert_close(sk[key], sp[key], atol=0, rtol=1e-3)


def _same_result(a, b):
    (pa, sa), (pb, sb) = a, b
    return torch.equal(pa, pb) and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_k3_repeats_bitwise_in_a_cluster(cuda):
    """pgo_1k's graph spreads over a cluster of several CTAs; three
    launches give the same bits, and the global-scratch placement at the
    same cluster size gives the bits of the shared-memory one."""
    from pgslam_tpu_torch.optim import lm
    args, _ = pose_graph_problem(1024, 1025, device=cuda)
    cfg = PGOConfig(max_iterations=6)
    runs = [lm_optimize(*args, config=cfg) for _ in range(3)]
    layout = lm_optimize.layout
    assert layout.clusters > 1 and layout.in_smem
    assert all(_same_result(runs[0], r) for r in runs[1:])
    in_global = lm._launch(*args, None, cfg, in_smem=False)
    assert not lm_optimize.layout.in_smem
    assert lm_optimize.layout.clusters == layout.clusters
    assert _same_result(runs[0], in_global)


def _k4_system(cuda, V, n_loop):
    """One LM step's system at the problem's initial poses."""
    args, _ = pose_graph_problem(V, n_loop, device=cuda)
    prob = pgo.LMProblem(*args)
    blocks, b, D = prob.system(args[0])
    P_inv, damp = pgo.block_jacobi(D, torch.tensor(1e-6, device=cuda),
                                   args[1])
    return (blocks, P_inv, damp, b, prob.prior_info, 0, prob.ef, prob.et)


K4_CG = dict(cg_iterations=64, cg_tol=1e-4)


@pytest.mark.parametrize("V,n_loop", [(40, 33), (1024, 1025)])
def test_k4_matches_plain(cuda, V, n_loop):
    sysargs = _k4_system(cuda, V, n_loop)
    before = pcg_solve.launches
    xk, sk = pcg_solve(*sysargs, **K4_CG, return_iterations=True)
    xp, sp = pgo.pcg_solve_plain(*sysargs, **K4_CG, return_iterations=True)
    torch.cuda.synchronize()
    assert pcg_solve.launches == before + 1
    assert int(sk) == sp
    # fp32 CG with another summation order
    assert float((xk - xp).abs().max()) <= 1e-3 * float(xp.abs().max())


def test_k4_repeats_bitwise(cuda):
    sysargs = _k4_system(cuda, 1024, 1025)
    x1 = pcg_solve(*sysargs, **K4_CG)
    x2 = pcg_solve(*sysargs, **K4_CG)
    assert torch.equal(x1, x2)
    assert pcg_solve.layout.ctas > 1


def test_k4_adds_its_cg_steps_to_the_total(cuda):
    sysargs = _k4_system(cuda, 1024, 1025)
    x, _ = pcg_solve(*sysargs, **K4_CG, return_iterations=True)
    total = pcg_solve.cg_steps[x.device.index]
    before = int(total)
    _, steps = pcg_solve(*sysargs, **K4_CG, return_iterations=True)
    assert int(steps) > 0 and int(total) == before + int(steps)


K4_LAYOUTS = [dict(ctas=4), dict(ctas=16), dict(ctas=8, cluster=8),
              dict(ctas=16, cluster=4), dict(ctas=12, cluster=1),
              dict(ctas=32, cluster=8), dict(ctas=32, cluster=2),
              dict(barrier="cluster"),
              dict(ctas=8, cluster=1, barrier="cluster"),
              dict(ctas=16, cluster=4, barrier="cluster"),
              dict(ctas=16, cluster=16, barrier="cluster")]


@pytest.mark.parametrize("forced", K4_LAYOUTS)
def test_k4_bits_do_not_depend_on_the_layout(cuda, forced):
    """Every CTA count, cluster size and barrier gives the bits of the
    layout k4_layout chooses (32 CTAs, one a vertex tile, at this size;
    4 CTAs do not fit shared memory and run from global scratch)."""
    sysargs = _k4_system(cuda, 1024, 1025)
    V = sysargs[3].shape[0]
    want = pcg_solve(*sysargs, **K4_CG)
    chosen = pcg_solve.layout
    plan = k4_plan(sysargs[6], sysargs[7], V, **forced)
    got = pcg_solve(*sysargs, **K4_CG, plan=plan)
    assert pcg_solve.layout == plan.layout != chosen
    for key, value in forced.items():
        assert getattr(plan.layout, key) == value
    assert torch.equal(got, want)


@pytest.mark.parametrize("forced", [{}, dict(ctas=16, cluster=4),
                                    dict(barrier="cluster")])
def test_k4_global_placement_gives_the_shared_bits(cuda, forced):
    sysargs = _k4_system(cuda, 1024, 1025)
    V = sysargs[3].shape[0]
    shared = k4_plan(sysargs[6], sysargs[7], V, **forced)
    in_global = k4_plan(sysargs[6], sysargs[7], V, in_smem=False, **forced)
    assert shared.layout.in_smem and not in_global.layout.in_smem
    x_shared = pcg_solve(*sysargs, **K4_CG, plan=shared)
    x_global = pcg_solve(*sysargs, **K4_CG, plan=in_global)
    assert torch.equal(x_shared, x_global)


def test_k4_at_pgo_16k_matches_plain(cuda):
    """The pgo_16k graph spreads over several clusters; the solve at its
    initial poses agrees with the plain version as test_k4_matches_plain
    asks, and the plan made once serves launches with the same bits."""
    sysargs = _k4_system(cuda, 16384, 4096)
    V = sysargs[3].shape[0]
    plan = k4_plan(sysargs[6], sysargs[7], V)
    xk, sk = pcg_solve(*sysargs, **K4_CG, plan=plan, return_iterations=True)
    xp, sp = pgo.pcg_solve_plain(*sysargs, **K4_CG, return_iterations=True)
    assert plan.layout.ctas > plan.layout.cluster and plan.layout.in_smem
    assert int(sk) == sp
    assert float((xk - xp).abs().max()) <= 1e-3 * float(xp.abs().max())
    assert torch.equal(xk, pcg_solve(*sysargs, **K4_CG, plan=plan))


def test_k4_raises_on_a_layout_that_would_not_be_resident(cuda):
    """1024 CTAs of 512 threads do not fit an H100 at once: the plan
    raises instead of launching a solve whose barriers never return."""
    V = 32768
    ef = torch.arange(V - 1, device=cuda)
    with pytest.raises(RuntimeError):
        k4_plan(ef, ef + 1, V, ctas=1024, cluster=1)


def test_k4_rejects_bad_input(cuda):
    blocks, P_inv, damp, b, prior, fixed, ef, et = _k4_system(cuda, 40, 33)
    bad = [((blocks[0].double(),) + blocks[1:], P_inv, b),
           (blocks, P_inv[:-1], b),
           (blocks, P_inv, torch.zeros((6, 40), device=cuda).T)]
    for blk, Pi, bb in bad:
        with pytest.raises(ValueError):
            pcg_solve(blk, Pi, damp, bb, prior, fixed, ef, et, **K4_CG)


def test_padded_edges_left_out_of_csr_exactly(cuda):
    """Padded edges carry zero blocks, so K4 gives the same bits with them
    out of its CSR lists, and K3 (which leaves them out) still agrees with
    its plain version on a padded graph."""
    args, _ = bucketed_problem(768, 128, device=cuda)
    V, emask = args[0].shape[0], args[6]
    assert not bool(emask.all())
    prob = pgo.LMProblem(*args)
    blocks, b, D = prob.system(args[0])
    P_inv, damp = pgo.block_jacobi(D, torch.tensor(1e-6, device=cuda),
                                   args[1])
    sysargs = (blocks, P_inv, damp, b, prob.prior_info, 0, prob.ef, prob.et)
    x_all = pcg_solve(*sysargs, **K4_CG, plan=k4_plan(prob.ef, prob.et, V))
    x_valid = pcg_solve(*sysargs, **K4_CG,
                        plan=k4_plan(prob.ef, prob.et, V, emask))
    assert torch.equal(x_all, x_valid)
    cfg = PGOConfig(max_iterations=4, cg_iterations=16, cg_tol=1e-3)
    pk, sk = lm_optimize(*args, config=cfg)
    pp, sp = lm_optimize_plain(*args, config=cfg)
    assert float((pk[:, :3, 3] - pp[:, :3, 3]).norm(dim=1).max()) < 1e-4
    assert int(sk["iterations"]) == int(sp["iterations"])


def test_pcg_routes_to_k4_above_threshold(cuda):
    """The padded shapes of a 3072-pose run (V = E = 4096, at the gate)
    stay on K3, in a cluster's shared memory, and those of a 4096-pose
    run with 4097 loop edges (V = 4096, E = 8192) go to the loop with
    K4."""
    cfg = PGOConfig(max_iterations=2, cg_iterations=16, cg_tol=1e-3)
    for (n, n_loop), kernel in (((3072, 512), lm_optimize),
                                ((4096, 4097), pcg_solve)):
        args, _ = bucketed_problem(n, n_loop, device=cuda)
        V, E = args[0].shape[0], args[2].shape[0]
        assert (V + E <= pgo.K3_MAX_SIZE) == (kernel is lm_optimize)
        before = (lm_optimize.launches, pcg_solve.launches)
        out, stats = pgo.optimize_pose_graph(*args, config=cfg)
        torch.cuda.synchronize()
        after = (lm_optimize.launches, pcg_solve.launches)
        ran = [a > b for a, b in zip(after, before)]
        assert ran == [kernel is lm_optimize, kernel is pcg_solve]
        if kernel is lm_optimize:
            assert lm_optimize.layout.in_smem
        assert torch.isfinite(out).all()
        assert float(stats["final_cost"]) < float(stats["initial_cost"])


def test_loop_replay_launches_every_kernel(cuda):
    from pgslam_tpu_torch import replays
    before = (knn.launches, fused_icp_register.launches,
              lm_optimize.launches)
    per_scan, trajectory, stats = replays.run_replay("loop", device=cuda)
    gold = replays.fixture("loop")["per_scan_poses"]
    assert replays.max_pose_gap(per_scan, gold) < 0.10
    assert stats["n_keyframes"] == 20 and stats["n_loops"] == 1
    after = (knn.launches, fused_icp_register.launches,
             lm_optimize.launches)
    assert all(a > b for a, b in zip(after, before))


def test_host_fetch_lands_the_packed_result(cuda):
    """One packed result goes to pinned host memory without a blocking
    copy; get() waits on its event and gives each field's own copy's
    bits."""
    from pgslam_tpu_torch.ops.icp import (HostFetch, pack_result,
                                          unpack_result)
    rds, rfs = _box_problems(cuda, 1)
    cfg = ICPConfig(outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)),
                    max_iterations=12)
    res = fused_icp_register(stack_clouds(rds), stack_clouds(rfs),
                             torch.eye(4, device=cuda)[None], cfg)
    fetch = HostFetch(pack_result(res, torch.tensor([0.5], device=cuda)))
    assert fetch._host.is_pinned()
    got, extra = unpack_result(fetch.get()[0])
    for f in ("T", "cov", "overlap", "residual", "iterations", "converged"):
        np.testing.assert_array_equal(getattr(got, f),
                                      getattr(res, f)[0].cpu().numpy())
    assert extra == 0.5


def test_k2_against_one_shared_map_matches_b1(cuda):
    """The streaming path's batch: B readings against B materialized
    copies of one local map, one K2 launch at B, each entry bit-equal to
    its own B = 1 launch."""
    from pgslam_tpu_torch.localizer import prepare_register_stream
    from pgslam_tpu_torch.ops.icp import unpack_result
    from pgslam_tpu_torch.replays import loop_config, loop_sequence_golden
    cfg = loop_config().localizer
    scans, odom, _ = loop_sequence_golden()
    inv = np.linalg.inv(np.asarray(odom[2], np.float64))
    rel = [(inv @ np.asarray(o, np.float64)).astype(np.float32)
           for o in odom[:7]]
    local = np.concatenate([s @ T[:3, :3].T + T[:3, 3]
                            for s, T in zip(scans[:3], rel[:3])])
    ref = make_cloud(local.astype(np.float32), capacity=1536, device=cuda)
    clouds = [make_cloud(scans[3 + j], capacity=512, device=cuda)
              for j in range(4)]
    T_rs = [torch.eye(4, device=cuda)] * 4
    T0s = torch.as_tensor(np.stack(rel[3:7]), device=cuda)
    before = fused_icp_register.batch_sizes[4]
    _, readings, packed = prepare_register_stream(
        (), cfg.keyframe_cloud_capacity, cfg.icp, clouds, T_rs, ref, T0s)
    assert fused_icp_register.batch_sizes[4] == before + 1
    for j in range(4):
        one = fused_icp_register(
            readings[j].map(lambda a: a[None]),
            ref.map(lambda a: a[None].contiguous()), T0s[j:j + 1], cfg.icp)
        got, _ = unpack_result(packed[j].cpu().numpy())
        np.testing.assert_array_equal(got.T, one.T[0].cpu().numpy())
        assert int(got.iterations) == int(one.iterations[0])


@pytest.mark.parametrize("k", [10, 16])
@pytest.mark.parametrize("nq,nr", [(3072, 3072), (1024, 3072), (700, 5000)])
def test_k1_large_k_forced_layouts_match_plain(cuda, nq, nr, k):
    """K1 at k = 10 (the point-to-plane YAML's normals) and k = 16 at every
    forced layout: knn_plain's ids and finite pattern, d2 within 1e-5 of
    its scale."""
    q, qm, r, rm = _k1_inputs(cuda, nq, nr, seed=k)
    mp = knn_plain(q, qm, r, rm, k=k)
    fin = torch.isfinite(mp.dists2)
    scale = max(1.0, float(mp.dists2[fin].abs().max()))
    for S in (1, 2, 4, 8, 16):
        for T in THREADS:
            lay = k1_layout(nq, nr, k, 132, slices=S, threads=T)
            mk = knn(q, qm, r, rm, k=k, layout=lay)
            torch.cuda.synchronize()
            assert torch.equal(mk.ids, mp.ids), lay
            assert torch.equal(torch.isfinite(mk.dists2), fin), lay
            assert float((mk.dists2[fin] - mp.dists2[fin]).abs().max()) \
                <= 1e-5 * scale, lay


@pytest.mark.parametrize("k", [1, 3])
def test_grid_knn_on_the_card_equals_the_cpu(cuda, k):
    """The grid matcher is plain PyTorch on either device: its index and
    matches on the card equal the CPU's bit for bit."""
    from pgslam_tpu_torch.ops.gridknn import build_grid_index, grid_knn
    q, qm, r, rm = _k1_inputs(cuda, 2000, 6000, seed=11)
    cpu = [t.cpu() for t in (q, qm, r, rm)]
    gi = build_grid_index(r, rm, cell_size=0.8, bucket_cap=8)
    ci = build_grid_index(cpu[2], cpu[3], cell_size=0.8, bucket_cap=8)
    assert torch.equal(gi.table.cpu(), ci.table)
    assert int(gi.overflow_count) == int(ci.overflow_count)
    gm, cm = grid_knn(q, qm, gi, k=k), grid_knn(cpu[0], cpu[1], ci, k=k)
    assert torch.equal(gm.ids.cpu(), cm.ids)
    assert torch.equal(gm.dists2.cpu(), cm.dists2)


def test_from_yaml_on_the_card_launches_k1_and_k3(cuda):
    """examples/slam_config.yaml through from_yaml on the card: the clover
    replay's first closure is optimized by K3, and every match is K1's."""
    from pgslam_tpu_torch import replays
    from pgslam_tpu_torch.optim.lm import lm_optimize
    from pgslam_tpu_torch.slam import PoseGraphSlam
    slam = PoseGraphSlam.from_yaml(replays.SLAM_YAML)
    assert slam.device.type == "cuda"
    assert slam.config == replays.yaml_config()
    k1, k3 = knn.launches, lm_optimize.launches
    scans, odom, _ = replays.yaml_clover_sequence()
    eye = np.eye(4, dtype=np.float32)
    for i, (scan, T) in enumerate(zip(scans, odom)):
        slam.add_data(i, "world", T, eye, scan)
    torch.cuda.synchronize()
    assert slam.n_loop_edges() >= 1
    assert knn.launches > k1 and lm_optimize.launches > k3


def _loop_scans(device, n, route_on, monkeypatch):
    """The first ``n`` scans of the golden loop with the single-scan route
    on or off; (per-scan poses, K2 launches)."""
    from pgslam_tpu_torch import localizer as L
    from pgslam_tpu_torch import replays
    from pgslam_tpu_torch.slam import PoseGraphSlam
    monkeypatch.setattr(L, "FUSED_SINGLE", route_on)
    monkeypatch.setattr(L, "FUSED_SINGLE_DEVICES", ("cuda", "cpu"))
    scans, odom, _ = replays.loop_sequence_golden()
    slam = PoseGraphSlam(replays.loop_config(), device=device)
    T_rs = np.eye(4, dtype=np.float32)
    before, poses = fused_icp_register.launches, []
    for i in range(n):
        slam.add_data(i, "world", odom[i], T_rs, scans[i])
        poses.append(slam.localizer.T_world_robot.copy())
    return np.stack(poses), fused_icp_register.launches - before


def test_single_route_launches_k2_once_a_scan(cuda, monkeypatch):
    """PGSLAM_FUSED_SINGLE on the card: one K2 launch a scan, poses within
    1 mm of the route's plain version on the CPU over the first scans."""
    card, launches = _loop_scans(cuda, 12, True, monkeypatch)
    assert launches == 11
    cpu, _ = _loop_scans("cpu", 12, True, monkeypatch)
    gap = np.linalg.norm(card[:, :3, 3] - cpu[:, :3, 3], axis=1)
    assert gap.max() < 1e-3, gap
    _, off = _loop_scans(cuda, 12, False, monkeypatch)
    assert off == 0


@pytest.mark.parametrize("env,launches", [(None, 1), ("0", 0), ("1", 1)])
def test_verify_route_on_card(cuda, monkeypatch, env, launches):
    """The synchronous verification on the card: K2 under "auto" and "1",
    ``icp_core`` under PGSLAM_FUSED_BATCHED=0."""
    from pgslam_tpu_torch import replays
    from pgslam_tpu_torch.loopcloser import verify
    if env is None:
        monkeypatch.delenv("PGSLAM_FUSED_BATCHED", raising=False)
    else:
        monkeypatch.setenv("PGSLAM_FUSED_BATCHED", env)
    scans, odom, _ = replays.loop_sequence_golden()
    T0 = (np.linalg.inv(odom[39].astype(np.float64))
          @ odom[40].astype(np.float64)).astype(np.float32)
    before = fused_icp_register.launches
    packed = verify(make_cloud(scans[40], device=cuda),
                    make_cloud(scans[39], device=cuda),
                    torch.as_tensor(T0, device=cuda),
                    replays.loop_config().loop_closer.icp)
    torch.cuda.synchronize()
    assert fused_icp_register.launches - before == launches
    assert bool(torch.isfinite(packed[:57]).all())


def test_k3_with_host_ptr_is_bit_equal(cuda):
    """K3 given the host's incidence pointer (as the resident optimizer
    gives it) launches the same layout and gives the same bits as K3
    reading it back from the card."""
    from pgslam_tpu_torch.optim.lm import edge_csr_ptr_host
    args, _ = bucketed_problem(1000, 1000, device=cuda)
    cfg = PGOConfig(max_iterations=4, cg_iterations=16, cg_tol=1e-3)
    ptr = edge_csr_ptr_host(args[2].cpu().numpy(), args[3].cpu().numpy(),
                            args[0].shape[0], args[6].cpu().numpy())
    pa, sa = lm_optimize(*args, config=cfg)
    lay_a = lm_optimize.layout
    pb, sb = lm_optimize(*args, config=cfg, ptr_host=ptr)
    torch.cuda.synchronize()
    assert lm_optimize.layout == lay_a
    assert torch.equal(pa, pb)
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
    with pytest.raises(ValueError):
        lm_optimize(*args, config=cfg, ptr_host=ptr[:-1])


def test_kernel_wrappers_raise_on_fp64(cuda):
    """No wrapper casts: an fp64 tensor that reaches a kernel on the card
    raises a TypeError naming the kernel (fp64 runs on the CPU only)."""
    from pgslam_tpu_torch._build import KernelDtypeError
    q = torch.zeros((16, 3), dtype=torch.float64, device=cuda)
    m = torch.ones(16, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="K1"):
        knn(q, m, q, m)
    cfg = ICPConfig(error="point_to_point", outlier=(O.TrimmedDist(0.9),))
    pts = torch.as_tensor(np.random.default_rng(0).normal(size=(1, 64, 3)),
                          dtype=torch.float32, device=cuda)
    cloud = make_cloud(pts[0].cpu().numpy(), device=cuda).map(
        lambda a: a[None])
    T64 = torch.eye(4, dtype=torch.float64, device=cuda)[None]
    with pytest.raises(TypeError, match="K2"):
        fused_icp_register(cloud, cloud, T64, cfg)
    args = _ring(cuda)
    for i in (0, 4, 5):          # poses, edge_T, edge_cov
        bad = list(args)
        bad[i] = bad[i].double()
        with pytest.raises(KernelDtypeError, match="K3"):
            lm_optimize(*bad, config=PGOConfig(max_iterations=1))
    blocks, P_inv, damp, b, prior, fixed, ef, et = _k4_system(cuda, 40, 33)
    with pytest.raises(TypeError, match="K4"):
        pcg_solve(blocks, P_inv, damp, b.double(), prior, fixed, ef, et,
                  **K4_CG)


def test_resident_optimizer_equals_classic(cuda):
    """The default optimize path (the resident mirror) against the
    classic upload on one growing graph: the same K3 launches and the
    same poses after every optimize, bit for bit."""
    from pgslam_tpu_torch.graph.pose_graph import MapManager
    from pgslam_tpu_torch.optimizer import Optimizer, OptimizerConfig
    args, truth = pose_graph_problem(300, 1, device="cpu")
    init = args[0].numpy()
    cloud = make_cloud(np.zeros((1, 3), np.float32), device=cuda)
    cov = np.eye(6, dtype=np.float32) * 0.01
    rel = lambda a, b: (np.linalg.inv(truth[a]) @ truth[b]).astype(
        np.float32)

    def run(mode):
        mm = MapManager()
        opt = Optimizer(mm, OptimizerConfig(resident=mode), device=cuda)
        mm.add_first_keyframe(cloud, init[0])
        out, launches = [], lm_optimize.launches
        for n, (a, b) in ((100, (3, 90)), (200, (50, 180)),
                          (300, (10, 290))):
            while mm.get_graph().n_vertices < n:
                v = mm.get_graph().n_vertices
                mm.add_new_keyframe(v - 1, init[v], rel(v - 1, v), cov, cloud)
            opt.add_new_data(a, b, rel(a, b), cov)
            g = mm.get_graph()
            out.append(g.optimized_poses[:g.n_vertices].copy())
        return out, lm_optimize.launches - launches, opt

    res, k3_res, opt = run("auto")
    cls, k3_cls, _ = run("off")
    assert opt._mirror is not None and opt._mirror._st is not None
    assert k3_res == k3_cls == 3
    for a, b in zip(res, cls):
        np.testing.assert_array_equal(a, b)


# -- icp_core as CUDA graph replays (ops/icp_graph.py) ----------------------

def _velodyne_cell(n_scans, seed):
    """The velodyne64 cell's configuration (built) and a session of its
    corridor mix cut to ``n_scans`` scans."""
    import copy
    import os
    from slambench import run as R
    from slambench.core import slamconfig, traffic
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = R.load_json(os.path.join(root, "BENCHMARK.json"))
    _, _, cfg, mix = R.resolve(bench, "velodyne64.corridor", root)
    mix = copy.deepcopy(mix)
    mix["sequence"]["n_scans"] = mix["steps"] = n_scans
    return slamconfig.build(cfg), traffic.make_session(mix, 1, seed)


def _velodyne_front(cuda, n_scans=6):
    """The cell's front-end config, its first scan's map on the card,
    and the next scans as (prepared reading, T0 from odometry) pairs:
    2,048 vs 8,192 points, point-to-plane, coarse_div 8."""
    from pgslam_tpu_torch.ops.icp import ICPEngine
    config, session = _velodyne_cell(n_scans, 2900000017)
    engine = ICPEngine(config.localizer.icp)
    engine.set_map(make_cloud(session.scans[0], device=cuda))
    pairs = []
    for i in range(1, n_scans):
        rel = np.linalg.inv(session.odom[0, 0].astype(np.float64)) \
            @ session.odom[i, 0]
        pairs.append((engine.prepare_reading(
            make_cloud(session.scans[i], device=cuda)),
            torch.tensor(rel, dtype=torch.float32, device=cuda)))
    return config.localizer.icp, engine, pairs


def test_icp_graph_route_equals_host_loop_at_velodyne_shapes(cuda):
    """Point-to-plane at 2,048 vs 8,192 with a coarse stage: the graph
    route gives the eager run's result (each stage left once it has
    converged), every field bit for bit, scan after scan (the graphs
    captured at the first)."""
    from pgslam_tpu_torch.ops import icp_graph
    from pgslam_tpu_torch.ops.icp import icp_core
    cfg, engine, pairs = _velodyne_front(cuda)
    assert cfg.error == "point_to_plane" and cfg.coarse_div == 8
    ref = engine.reference
    assert ref.points.shape[0] == 8192
    for reading, T0 in pairs:
        assert reading.points.shape[0] == 2048
        assert icp_graph.graph_route(reading, ref, T0, cfg)
        got = icp_core(reading, ref, T0, cfg)
        want = icp_graph.register_eager(reading, ref, T0, cfg)
        for name, v in vars(want).items():
            assert torch.equal(getattr(got, name), v), name
    assert icp_graph.registration(pairs[0][0], ref, cfg).graphs is not None


def test_icp_graph_second_slam_object_captures_nothing(cuda):
    """The graphs are the process's: a second SLAM object at the same
    shapes replays them, and the recording counts its registrations as
    graph ones, with no convergence read on the host."""
    from torch.profiler import ProfilerActivity, profile
    from pgslam_tpu_torch import PoseGraphSlam
    from pgslam_tpu_torch.ops import icp_graph
    from pgslam_tpu_torch.utils import timing
    config, session = _velodyne_cell(5, 2900000023)
    T_rs = np.eye(4, dtype=np.float32)

    def feed():
        slam = PoseGraphSlam(config, device=cuda)
        for i in range(5):
            slam.add_data(i, "world", session.odom[i, 0], T_rs,
                          session.scans[i])
        torch.cuda.synchronize()

    feed()
    cached = len(icp_graph._CACHE)
    with profile(activities=[ProfilerActivity.CPU]):
        feed()
    rec = timing.recording()
    assert len(icp_graph._CACHE) == cached
    assert rec.counters.get("icp.graph.captures", 0) == 0
    assert rec.counters["icp.graph.registrations"] == 4
    assert rec.counters.get("icp.eager.registrations", 0) == 0
    assert "icp.converged" not in rec.sites


def test_icp_graph_result_keeps_its_values_after_the_next_call(cuda):
    """A result does not alias the graphs' buffers: the next
    registration of the shape leaves it as it was."""
    from pgslam_tpu_torch.ops.icp import icp_core
    cfg, engine, pairs = _velodyne_front(cuda, n_scans=3)
    first = icp_core(pairs[0][0], engine.reference, pairs[0][1], cfg)
    kept = {k: v.clone() for k, v in vars(first).items()}
    second = icp_core(pairs[1][0], engine.reference, pairs[1][1], cfg)
    torch.cuda.synchronize()
    assert not torch.equal(second.T, first.T)
    for name, v in kept.items():
        assert torch.equal(getattr(first, name), v), name


def test_icp_graph_registrations_from_threads_keep_their_results(cuda):
    """Eight threads register at one shape at once, with a short switch
    interval: each result is the one a single thread gets (a shape's
    buffers serve one registration at a time)."""
    import sys
    import threading
    from pgslam_tpu_torch.ops.icp import icp_core
    cfg, engine, pairs = _velodyne_front(cuda, n_scans=5)
    ref = engine.reference
    want = [icp_core(r, ref, T0, cfg).T for r, T0 in pairs]
    got, errors = [], []

    def work(t):
        try:
            for j in range(6):
                i = (t + j) % len(pairs)
                got.append((i, icp_core(pairs[i][0], ref, pairs[i][1],
                                        cfg).T))
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    torch.cuda.synchronize()
    assert len(got) == 48
    for i, T in got:
        assert torch.equal(T, want[i]), i


@pytest.mark.parametrize("matcher,k,m,coarse", [
    ("pallas", 1, 0, 0), ("pallas", 3, 0, 4), ("grid", 1, 0, 0),
    ("grid", 3, 3, 4), ("pallas", 1, 3, 4)])
def test_icp_graph_route_takes_every_point_to_plane_config(cuda, matcher,
                                                           k, m, coarse):
    """k > 1, Anderson acceleration and the grid matcher ride the graph
    route too, with the eager run's bits; point-to-point runs eagerly."""
    import dataclasses
    from pgslam_tpu_torch.ops import icp_graph
    from pgslam_tpu_torch.ops.icp import ICPEngine, icp_core
    from pgslam_tpu_torch.utils import timing
    from torch.profiler import ProfilerActivity, profile
    rds, rfs = _box_problems(cuda, 2)
    cfg = ICPConfig(error="point_to_plane", matcher=matcher, knn=k,
                    anderson_m=m, coarse_div=coarse, coarse_iterations=6,
                    max_iterations=20,
                    outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)))
    T0 = se3.exp(torch.tensor([0.03, -0.02, 0.01, 0.01, 0.0, -0.01],
                              device=cuda))
    for rd, rf in zip(rds, rfs):
        engine = ICPEngine(cfg)
        engine.set_map(rf)
        ref = engine.reference
        assert icp_graph.graph_route(rd, ref, T0, cfg)
        with profile(activities=[ProfilerActivity.CPU]):
            got = icp_core(rd, ref, T0, cfg, engine.index)
        assert timing.recording().counters["icp.graph.registrations"] == 1
        want = icp_graph.register_eager(rd, ref, T0, cfg, engine.index)
        for name, v in vars(want).items():
            assert torch.equal(getattr(got, name), v), name
    p2p = dataclasses.replace(cfg, error="point_to_point")
    assert not icp_graph.graph_route(rd, ref, T0, p2p)
