"""The share of the front end's registrations (``icp_core`` calls) that
ran as CUDA graph replays, with the decision to stop made on the device:
the program's counters ``icp.graph.registrations`` over those and
``icp.eager.registrations`` (the host-decided loop), from its recording
of the profiled stretch (``core/recording.py``). None where the program
counts neither."""

from slambench.core import recording as R


def read(run, rec=None):
    rec = R.last() if rec is None else rec
    if rec is None:
        return None
    graph = rec.counters.get("icp.graph.registrations", 0)
    total = graph + rec.counters.get("icp.eager.registrations", 0)
    return graph / total if total else None
