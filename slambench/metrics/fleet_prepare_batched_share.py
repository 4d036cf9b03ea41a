"""The share of the fleet's steps whose input preparation ran whole once
over the step's batch (no input filter chain run agent by agent): the
program's counters ``fleet.prepare.batched`` over those and
``fleet.prepare.per_agent``, from its recording of the profiled stretch
(``core/recording.py``). None where the program counts neither."""

from slambench.core import recording as R


def read(run, rec=None):
    rec = R.last() if rec is None else rec
    if rec is None:
        return None
    batched = rec.counters.get("fleet.prepare.batched", 0)
    total = batched + rec.counters.get("fleet.prepare.per_agent", 0)
    return batched / total if total else None
