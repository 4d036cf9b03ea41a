"""K1's share of its roofline over the profiled stretch: the least time
its launches need (``stats.knn_work`` of each launch's (nq, nr, k), from
the harness's own tally, ``core/tally.py``, at the published fp32 and
HBM peaks) over
the device time of its kernel (``knn_kernel``) in the trace, in %."""

from slambench.core import stats


def read(run):
    tr = run.trace
    if not tr:
        return None
    busy = sum(v for k, v in tr["by_name"].items() if "knn_kernel" in k)
    if busy <= 0:
        return None
    least = sum(n * stats.least_time(*stats.knn_work(*shape))
                for shape, n in tr["k1_shapes"].items())
    return 100.0 * least / busy
