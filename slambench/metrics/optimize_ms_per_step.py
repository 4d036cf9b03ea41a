"""Milliseconds per step in the span around ``Optimizer.process_pending``
(the step's optimization), each side synchronized, over the span-timed
part of a traced window."""


def read(run):
    s = run.spans
    if s is None or not run.steps_timed:
        return None
    return 1e3 * s.total_s.get("optimize", 0.0) / run.steps_timed
