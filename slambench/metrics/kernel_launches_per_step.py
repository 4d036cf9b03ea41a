"""Launches of the port's four kernels (K1-K4) per step, counted by
``_build.count_launch`` into the program's recording of the profiled
stretch (``core/recording.py``)."""

from slambench.core import recording as R


def read(run, rec=None):
    rec = R.last() if rec is None else rec
    if not R.steps(rec):
        return None
    return sum(rec.counters.get(f"launch.k{i}", 0)
               for i in range(1, 5)) / R.steps(rec)
