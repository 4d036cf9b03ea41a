"""Milliseconds per scan in the program's span
``pgslam.frontend.filters`` (the input chain of ``prepare_input`` and the
reading chain of ``prepare_reading``), from its recording of the
profiled stretch (``core/recording.py``)."""

from slambench.core import recording as R


def read(run, rec=None):
    return R.span_ms_per(R.last() if rec is None else rec,
                         "pgslam.frontend.filters", per="scans")
