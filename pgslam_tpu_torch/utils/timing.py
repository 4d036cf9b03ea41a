"""Stage timers and device traces. Counterpart of
:mod:`pgslam_tpu.utils.timing`: :class:`StageTimer` as there, and
:func:`profile_trace` over ``torch.profiler`` (CPU and, where present,
CUDA activity), writing a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    """Accumulating wall-clock timer per named stage.

    >>> timer = StageTimer()
    >>> with timer.stage("icp"):
    ...     run_icp()
    >>> timer.summary()
    {'icp': {'count': 1, 'total_s': ..., 'mean_ms': ...}}
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "count": self.counts[name],
                "total_s": round(self.totals[name], 4),
                "mean_ms": round(1e3 * self.totals[name]
                                 / max(self.counts[name], 1), 3),
            }
            for name in self.totals
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Profile the enclosed block (CPU, and CUDA when a card is present)
    and write its Chrome trace to ``logdir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
