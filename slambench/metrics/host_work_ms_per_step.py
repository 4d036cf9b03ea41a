"""Milliseconds per step the host works between waits: the step spans'
(``pgslam.*.step``) total less the seconds waited at sites inside them,
from the program's recording of the profiled stretch
(``core/recording.py``)."""

from slambench.core import recording as R


def read(run, rec=None):
    rec = R.last() if rec is None else rec
    if not R.steps(rec):
        return None
    roots = [v for k, v in rec.spans.items() if k.endswith(".step")]
    host_s = sum(v["total_s"] - v["wait_s"] for v in roots)
    return 1e3 * host_s / R.steps(rec)
