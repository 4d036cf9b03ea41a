"""95th percentile over every scan of the window of ``add_data``'s host
time up to the device synchronize after it (one robot: a step is a
scan)."""

from slambench.core import stats


def read(run):
    return 1e3 * stats.percentile(run.latencies_s, 95)
