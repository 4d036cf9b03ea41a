"""Milliseconds per step in the program's span ``pgslam.localmap.build``
(every local-map, candidate-map and probe-map build, single or batched,
and the local map's reference chain as it is installed), from its
recording of the profiled stretch (``core/recording.py``)."""

from slambench.core import recording as R


def read(run, rec=None):
    return R.span_ms_per(R.last() if rec is None else rec,
                         "pgslam.localmap.build")
