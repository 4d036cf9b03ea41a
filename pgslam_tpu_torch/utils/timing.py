"""The port's tracer: spans, host-device wait sites and counters.

It records exactly while a torch profiler is recording (torch's own
flag, ``torch.autograd.profiler._is_profiler_enabled``), and costs one
flag check per span, site or count otherwise. A new recording starts at
the first span, site or count after recording turned on, where the last
span, site, count or :func:`recording` call found it off (two profiler
sessions with none of these between them make one recording); it holds
until the next starts, and :func:`recording` returns it.

* :func:`span` times a block (``time.perf_counter_ns``) under a name
  that starts with ``pgslam.``, with its parent on the same thread, the
  step it belongs to (``span(..., step=True)`` opens a step: one
  ``PoseGraphSlam.add_data`` or ``MultiAgentSlam.add_data_batch``) and
  the seconds waited at sites inside it; it also opens a profiler range
  under the same name (:data:`_RANGE`), so the span sits on the device
  trace's clock. A span opened with no parent on its thread (a worker
  thread's) takes the newest step.
* :func:`wait` wraps one host-device synchronization (a fetch to the
  host, a host read of a device value, an event wait, an upload from
  pageable memory): per site the calls and the seconds blocked, into the
  recording and into every enclosing span. Sites count on every device.
* :func:`count` adds to a counter of the recording (``steps``, ``scans``,
  ``launch.k1`` ... ``launch.k4``, ``icp.iterations``; ``icp_core``'s
  route: ``icp.graph.registrations``, the registrations served by CUDA
  graph replays, ``icp.eager.registrations``, those run eagerly with the
  host leaving each stage once it has converged, and
  ``icp.graph.captures``, the graphs captured; the fleet's
  input preparation, one a step on the route taken:
  ``fleet.prepare.batched``, the whole preparation once over the step's
  batch, and ``fleet.prepare.per_agent``, an input filter chain run per
  agent before the batch's compaction and transform). On the graph
  route ``icp.iterations`` counts every iteration the device ran, to
  each stage's cap, the frozen ones after convergence included.

The loop closer's outcomes stay in :data:`pgslam_tpu_torch.utils.counters`,
summed over the whole process.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "pgslam."

# The profiler range a span opens: a host range only. torch's public
# ``record_function`` is a user annotation, which the profiler also lays
# on the device timeline over the kernels launched inside it
# (``gpu_user_annotation``), where device-time tables count it as a
# kernel; the fast record function makes no such event.
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function


class SpanRecord(NamedTuple):
    """One closed span: ``parent`` is the ``id`` of the span it opened in
    (-1 for none), ``step`` the step it belongs to (0 before the first),
    times in ``perf_counter_ns``."""
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    step: int
    wait_ns: int
    thread: int


class Recording:
    """What one profiler session recorded. ``spans``: name -> calls,
    total_s, self_s (total less the spans directly inside), wait_s (at
    sites inside, nested spans' included); ``sites``: name -> count,
    wait_s; ``counters``: name -> count; ``records``: every closed span
    (:class:`SpanRecord`), in the order they closed."""

    def __init__(self):
        self.spans: Dict[str, Dict[str, float]] = {}
        self.sites: Dict[str, Dict[str, float]] = {}
        self.counters: Dict[str, int] = defaultdict(int)
        self.records: List[SpanRecord] = []
        self.step = 0           # the newest step's id

    def _snapshot(self) -> "Recording":
        out = Recording()
        out.spans = {k: dict(v) for k, v in self.spans.items()}
        out.sites = {k: dict(v) for k, v in self.sites.items()}
        out.counters = defaultdict(int, self.counters)
        out.records = list(self.records)
        out.step = self.step
        return out


_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_current = Recording()
_was_on = False


def _active() -> Optional[Recording]:
    """The recording to add to, or None while no profiler records."""
    global _current, _was_on
    if not _profiler._is_profiler_enabled:
        _was_on = False
        return None
    if not _was_on:
        with _lock:
            if not _was_on:
                _current = Recording()
                _was_on = True
    return _current


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "name", "new_step", "id", "parent", "step", "start",
                 "child_ns", "wait_ns", "rf")

    def __init__(self, rec: Recording, name: str, new_step: bool):
        self.rec, self.name, self.new_step = rec, name, new_step

    def __enter__(self):
        rec, st = self.rec, _stack()
        outer = st[-1] if st and st[-1].rec is rec else None
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else -1
        if self.new_step:
            with _lock:
                rec.step += 1
                self.step = rec.step
        else:
            self.step = outer.step if outer is not None else rec.step
        self.child_ns = self.wait_ns = 0
        st.append(self)
        self.rf = _RANGE(self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        st = _stack()
        st.pop()
        total = end - self.start
        if st and st[-1].rec is self.rec:
            st[-1].child_ns += total
            st[-1].wait_ns += self.wait_ns
        rec = SpanRecord(self.id, self.name, self.start, end, self.parent,
                         self.step, self.wait_ns, threading.get_ident())
        with _lock:
            agg = self.rec.spans.get(self.name)
            if agg is None:
                agg = self.rec.spans[self.name] = {
                    "calls": 0, "total_s": 0.0, "self_s": 0.0, "wait_s": 0.0}
            agg["calls"] += 1
            agg["total_s"] += total * 1e-9
            agg["self_s"] += (total - self.child_ns) * 1e-9
            agg["wait_s"] += self.wait_ns * 1e-9
            self.rec.records.append(rec)
        return False


def span(name: str, step: bool = False):
    """A context manager timing its block as span ``name`` (which must
    start with ``pgslam.``) while a profiler records; ``step`` opens a
    new step."""
    rec = _active()
    if rec is None:
        return _NULL
    if not name.startswith(PREFIX):
        raise ValueError(f"span names start with {PREFIX!r}: {name!r}")
    return _Span(rec, name, step)


def spanned(name: str):
    """A decorator: every call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class _Wait:
    __slots__ = ("rec", "site", "start")

    def __init__(self, rec: Recording, site: str):
        self.rec, self.site = rec, site

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.start
        st = _stack()
        if st and st[-1].rec is self.rec:
            st[-1].wait_ns += ns
        with _lock:
            agg = self.rec.sites.get(self.site)
            if agg is None:
                agg = self.rec.sites[self.site] = {"count": 0, "wait_s": 0.0}
            agg["count"] += 1
            agg["wait_s"] += ns * 1e-9
        return False


def wait(site: str):
    """A context manager around one host-device synchronization at
    ``site`` while a profiler records."""
    rec = _active()
    if rec is None:
        return _NULL
    return _Wait(rec, site)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    rec = _active()
    if rec is None:
        return
    with _lock:
        rec.counters[name] += n


def recording() -> Recording:
    """A copy of the last recording (empty before any)."""
    global _was_on
    if not _profiler._is_profiler_enabled:
        _was_on = False
    with _lock:
        return _current._snapshot()
