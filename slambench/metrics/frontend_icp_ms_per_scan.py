"""Milliseconds per scan in the program's span ``pgslam.frontend.icp``
(``icp_core``, or K2 at B = 1, in ``Localizer._dispatch``), from its
recording of the profiled stretch (``core/recording.py``)."""

from slambench.core import recording as R


def read(run, rec=None):
    return R.span_ms_per(R.last() if rec is None else rec,
                         "pgslam.frontend.icp", per="scans")
