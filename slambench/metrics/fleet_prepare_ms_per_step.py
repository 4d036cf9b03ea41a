"""Milliseconds per step in the program's span ``pgslam.fleet.prepare``
(the fleet's input preparation, each agent's ``prepare_scan`` and the
registration batch's stacking), from its recording of the profiled
stretch (``core/recording.py``)."""

from slambench.core import recording as R


def read(run, rec=None):
    return R.span_ms_per(R.last() if rec is None else rec,
                         "pgslam.fleet.prepare")
