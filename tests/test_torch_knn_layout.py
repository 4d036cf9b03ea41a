"""K1's slices and layout on the CPU: ``merge_slices`` (the merge the
kernel does across the CTAs of a cluster) over ``knn_plain`` run slice by
slice gives ``knn_plain``'s result bit for bit, and ``k1_layout`` fills
the card. The kernel itself is held to ``knn_plain`` at forced layouts in
tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from pgslam_tpu_torch.ops.knn import (INF, MIN_SLICE, SLICES, THREADS,
                                      K1Layout, Matches, k1_layout,
                                      knn_plain, merge_slices)

H100_SMS = 132


def _sliced(q, qm, r, rm, k, S):
    """knn_plain on each of the S contiguous slices the kernel scans
    (``[nr * s // S, nr * (s + 1) // S)``), ids made global, then the
    merge."""
    nr = r.shape[0]
    parts = []
    for s in range(S):
        r0, r1 = nr * s // S, nr * (s + 1) // S
        if r1 == r0:
            parts.append(Matches(dists2=torch.full((q.shape[0], k), INF),
                                 ids=torch.zeros((q.shape[0], k),
                                                 dtype=torch.int32)))
            continue
        m = knn_plain(q, qm, r[r0:r1], rm[r0:r1], k)
        ids = torch.where(torch.isfinite(m.dists2), m.ids + r0, 0)
        parts.append(Matches(dists2=m.dists2, ids=ids.to(torch.int32)))
    return merge_slices(parts, k)


def _assert_bit_equal(got, want):
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.dists2, want.dists2)


def _case(nq, nr, seed, S):
    """Queries on and near the references, exact duplicates of the first
    references at the end (another slice for S > 1), six references
    exactly 1 from one query spread over the slices, masked queries, and
    slice 1 of S fully masked."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-5, 5, (nr, 3)).astype(np.float32)
    dup = min(10, nr // 2)
    r[nr - dup:] = r[:dup]
    q = np.concatenate([r[np.arange(nq // 2) % nr], rng.uniform(-5, 5, (nq - nq // 2, 3))
                        ]).astype(np.float32)
    q[nq // 2] = 1.0
    for i, d in zip((min(20, nr - 1), nr // 3, nr // 2, 2 * nr // 3,
                     3 * nr // 4, nr - dup - 1),
                    ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
                     (0, 0, -1))):
        r[i] = np.add(1.0, d)
    qm = np.ones(nq, bool)
    qm[[3, nq - 2]] = False
    rm = np.ones(nr, bool)
    if S > 1:
        rm[nr // S:2 * nr // S] = False
    return tuple(torch.from_numpy(a) for a in (q, qm, r, rm))


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 16])
def test_merged_slices_equal_plain(S, k):
    q, qm, r, rm = _case(64, 1000, S, S)     # 1000 is not divisible by S
    _assert_bit_equal(_sliced(q, qm, r, rm, k, S), knn_plain(q, qm, r, rm, k))


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("S", [2, 4, 16])
def test_merge_takes_the_lowest_id_among_duplicates(S, k):
    """Every reference duplicated k times, the copies spread over the
    slices: the lowest id wins, then the next."""
    rng = np.random.default_rng(k)
    base = rng.uniform(-3, 3, (40, 3)).astype(np.float32)
    r = torch.from_numpy(np.tile(base, (k, 1)))
    q = torch.from_numpy(base[::3].copy())
    qm = torch.ones(q.shape[0], dtype=torch.bool)
    rm = torch.ones(r.shape[0], dtype=torch.bool)
    want = knn_plain(q, qm, r, rm, k)
    _assert_bit_equal(_sliced(q, qm, r, rm, k, S), want)
    assert (want.dists2 == want.dists2[:, :1]).all()
    expect = torch.arange(0, 40, 3)[:, None] + 40 * torch.arange(k)[None]
    assert torch.equal(want.ids, expect.to(torch.int32))


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("nr", [1, 3, 5])
def test_merge_with_fewer_references_than_k_or_slices(nr, k):
    q, qm, r, rm = _case(16, nr, 9, 1)
    want = knn_plain(q, qm, r, rm, k)
    for S in SLICES:
        _assert_bit_equal(_sliced(q, qm, r, rm, k, S), want)
    assert not torch.isfinite(want.dists2[:, nr:]).any()
    assert (want.ids[:, nr:] == 0).all()


@pytest.mark.parametrize("k", [1, 8])
def test_merge_with_every_reference_masked(k):
    q, qm, r, _ = _case(16, 300, 4, 1)
    rm = torch.zeros(300, dtype=torch.bool)
    got = _sliced(q, qm, r, rm, k, 4)
    _assert_bit_equal(got, knn_plain(q, qm, r, rm, k))
    assert not torch.isfinite(got.dists2).any() and (got.ids == 0).all()


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("nq,nr", [(512, 2048), (2048, 8192), (8192, 8192)])
def test_layout_fills_one_wave(nq, nr, k):
    lay = k1_layout(nq, nr, k, H100_SMS)
    assert lay.ctas(nq) >= H100_SMS
    assert nr // lay.slices >= MIN_SLICE


@pytest.mark.parametrize("nq,nr,k", [(512, 1536, 1), (2048, 8192, 1),
                                     (8192, 8192, 8), (65536, 65536, 1),
                                     (7, 100000, 1), (100000, 7, 8)])
def test_layout_slices_hold_min_slice(nq, nr, k):
    lay = k1_layout(nq, nr, k, H100_SMS)
    assert lay.slices == 1 or nr // lay.slices >= MIN_SLICE
    assert lay.slices in SLICES
    assert lay.threads in THREADS


@pytest.mark.parametrize("nr", [1, 100, MIN_SLICE, 2 * MIN_SLICE - 1])
def test_small_reference_gives_one_slice(nr):
    assert k1_layout(64, nr, 1, H100_SMS).slices == 1
    assert k1_layout(100000, nr, 8, H100_SMS).slices == 1


@pytest.mark.parametrize("nq,nr,k,want", [
    # 2048 queries: 16 tiles of 128 threads need 16 slices; 8192: 64
    # tiles, 4 slices; 65536: one slice.
    (2048, 8192, 1, K1Layout(16, 128)), (8192, 8192, 8, K1Layout(4, 128)),
    (65536, 65536, 1, K1Layout(1, 128)), (65536, 65536, 8, K1Layout(1, 128)),
    # 512 queries: 4 tiles of 128 fill no wave at any S; 16 tiles of 32
    # fill one at 16 slices of 96 references.
    (512, 1536, 1, K1Layout(16, 32)),
    # 256 queries fill no wave at all: the most slices at 128 threads.
    (256, 8192, 1, K1Layout(16, 128)), (100, 100000, 8, K1Layout(16, 128))])
def test_layout_prefers_the_fewest_slices_that_fill(nq, nr, k, want):
    assert k1_layout(nq, nr, k, H100_SMS) == want


@pytest.mark.parametrize("S", SLICES)
@pytest.mark.parametrize("T", THREADS)
@pytest.mark.parametrize("k", [1, 8])
def test_forced_layout_is_honoured(S, T, k):
    assert k1_layout(512, 3000, k, H100_SMS, slices=S, threads=T) == \
        K1Layout(S, T)
    assert k1_layout(512, 3000, k, H100_SMS, slices=S).slices == S
    assert k1_layout(512, 3000, k, H100_SMS, threads=T).threads == T


@pytest.mark.parametrize("kw", [dict(slices=3), dict(slices=32),
                                dict(slices=0), dict(threads=64),
                                dict(threads=16),
                                dict(threads=256), dict(threads=48)])
def test_impossible_layout_raises(kw):
    with pytest.raises(ValueError):
        k1_layout(512, 3000, 1, H100_SMS, **kw)


@pytest.mark.parametrize("k", [0, 17])
def test_layout_rejects_k(k):
    with pytest.raises(ValueError):
        k1_layout(512, 3000, k, H100_SMS)
