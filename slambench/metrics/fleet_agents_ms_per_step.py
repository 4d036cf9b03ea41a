"""Milliseconds per step in the program's span ``pgslam.fleet.agents``
(the per-agent loops of ``add_data_batch``: pose updates and probe
requests, then decisions and graph mutations), from its recording of
the profiled stretch (``core/recording.py``)."""

from slambench.core import recording as R


def read(run, rec=None):
    return R.span_ms_per(R.last() if rec is None else rec,
                         "pgslam.fleet.agents")
