"""95th percentile over every step of the window of ``add_data_batch``'s
host time up to the synchronize after it."""

from slambench.core import stats


def read(run):
    return 1e3 * stats.percentile(run.latencies_s, 95)
