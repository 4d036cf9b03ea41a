"""Reduction of a ``torch.profiler`` trace to the numbers the benchmark
reports: per device the union of its events' intervals (busy time), the
device time by kernel name, and the idle gaps of the first device named
by the benchmark's span the host was in, over the profiled stretch.
The device time by name is ``key_averages``'s, as in
``pgslam_tpu_torch/profile_replay.py``; the busy time is the union of
the intervals, where that file sums the event times.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List

from . import stats

MARK = "slambench_stretch"


def reduce(prof, devices: List[int], span_names: Iterable[str]) -> Dict:
    """Busy seconds per device index in ``devices``, the stretch's
    length (from the marker's start to the last event's end, on the
    trace's clock), device seconds by name, and idle seconds of the
    first device by the innermost span the host was in."""
    from torch.autograd import DeviceType
    names = set(span_names) | {MARK}
    dev_iv = collections.defaultdict(list)
    host_spans, t0, t_end = [], None, 0.0
    for ev in prof.events():
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == DeviceType.CUDA:
            if ev.name in names or getattr(ev, "is_user_annotation", False):
                continue
            dev_iv[ev.device_index].append((s, e))
        elif ev.name == MARK:
            t0 = s
        elif ev.name in names:
            host_spans.append((s, e, ev.name))
        t_end = max(t_end, e)
    if t0 is None:
        raise RuntimeError("the stretch marker is missing from the trace")
    busy = {d: stats.union_length((max(s, t0), e) for s, e in dev_iv[d]
                                  if e > t0) for d in devices}
    by_name = collections.defaultdict(float)
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.key not in names:
            by_name[ev.key] += ev.self_device_time_total * 1e-6
    host_spans.sort()
    idle = collections.defaultdict(float)
    for gs, ge in stats.gaps(dev_iv[devices[0]], t0, t_end):
        mid = 0.5 * (gs + ge)
        inner, start = "between steps", -1.0
        for s, e, name in host_spans:
            if s > mid:
                break
            if e >= mid and s > start:
                inner, start = name, s
        idle[inner] += ge - gs
    return {"busy_s": busy, "window_s": t_end - t0, "by_name": dict(by_name),
            "idle_by_span": dict(idle)}
