"""Milliseconds per step in the program's span ``pgslam.fleet.probes``
(``MultiAgentSlam._batched_probes``: the fleet's overlap probes and
their map builds), from its recording of the profiled stretch
(``core/recording.py``)."""

from slambench.core import recording as R


def read(run, rec=None):
    return R.span_ms_per(R.last() if rec is None else rec,
                         "pgslam.fleet.probes")
