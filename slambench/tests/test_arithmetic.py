"""The benchmark's arithmetic on inputs whose answers are known."""

import pytest

from slambench.core import stats


def test_p95_is_over_all_samples():
    vals = list(range(1, 101))          # 1..100
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(reversed(vals)), 95) == 95
    assert stats.percentile(list(range(1, 21)), 95) == 19


def test_rate_over_the_whole_window():
    assert stats.rate(600, 30.0) == 20.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_of_device_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.union_length([]) == 0.0
    assert stats.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_k1_bound_from_its_shape():
    ops, nbytes = stats.knn_work(2048, 8192, 1)
    assert ops == 8 * 2048 * 8192
    assert nbytes == 13 * (2048 + 8192) + 8 * 2048
    t = stats.least_time(ops, nbytes)
    assert t == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))
    # PERF.md's kernel table: 0.002 ms for 2048 x 8192 at k = 1.
    assert t * 1e3 == pytest.approx(0.002, rel=0.01)
