"""The program's own recording of a traced run's profiled stretch, for
the metric readers that read it: the spans, wait sites and counters of
``pgslam_tpu_torch.utils.timing``, which record exactly while the
stretch's profiler does. A step is one ``pgslam.*.step`` root span (one
``add_data`` or ``add_data_batch`` call); ``scans`` counts a fleet
step's scans, as ``scans_per_s`` does."""

from __future__ import annotations


def last():
    """The program's last recording, or None where the program keeps none
    (a checkout from before its tracer)."""
    try:
        from pgslam_tpu_torch.utils.timing import recording
    except ImportError:
        return None
    return recording()


def steps(rec) -> int:
    return 0 if rec is None else int(rec.counters.get("steps", 0))


def span_ms_per(rec, name: str, per: str = "steps"):
    """Milliseconds in span ``name`` (its calls' total) per step or per
    scan (``per``), or None for an empty recording."""
    n = 0 if rec is None else int(rec.counters.get(per, 0))
    if not steps(rec) or not n:
        return None
    return 1e3 * rec.spans.get(name, {}).get("total_s", 0.0) / n
