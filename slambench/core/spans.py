"""Spans around the program's bound methods, recorded from the
benchmark's own files (the program itself is not instrumented).

:meth:`Spans.wrap` replaces a bound method on one object by a wrapper
that records a span named by the benchmark. While ``timed`` is on, the
wrapper synchronizes every device before and after the call, so that a
span's host-clock duration holds the device work it launched; its self
time leaves out the time of spans opened inside it. While ``timed`` is
off, a span only marks its interval for the profiler
(``torch.profiler.record_function``), and nothing is synchronized.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, List, Optional

import torch


class Spans:
    def __init__(self, devices: List[torch.device]):
        self.devices = devices
        self.timed = False
        self.self_s = collections.defaultdict(float)
        self.total_s = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.names = set()
        self._stack: List[list] = []

    def sync(self) -> None:
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)
        setattr(obj, attr, self.wrapper(fn, name))

    def wrapper(self, fn: Callable, name: str) -> Callable:
        self.names.add(name)

        def spanned(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return spanned

    def span(self, name: str):
        self.names.add(name)
        return _Span(self, name)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.s, self.name = spans, name
        self.rf: Optional[torch.profiler.record_function] = None

    def __enter__(self):
        s = self.s
        if s.timed:
            s.sync()
        else:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        s._stack.append([time.perf_counter(), 0.0])
        return self

    def __exit__(self, *exc):
        s = self.s
        if s.timed:
            s.sync()
        t0, child = s._stack.pop()
        dur = time.perf_counter() - t0
        if s.timed:
            s.total_s[self.name] += dur
            s.self_s[self.name] += dur - child
            s.calls[self.name] += 1
            if s._stack:
                s._stack[-1][1] += dur
        else:
            self.rf.__exit__(*exc)
        return False
