"""Host-device synchronizations per step: the calls of every wait site
of the program (fetches, host reads of device values, event waits,
uploads from pageable memory), from its recording of the profiled
stretch (``core/recording.py``)."""

from slambench.core import recording as R


def read(run, rec=None):
    rec = R.last() if rec is None else rec
    if not R.steps(rec):
        return None
    return sum(s["count"] for s in rec.sites.values()) / R.steps(rec)
