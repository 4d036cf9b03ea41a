"""Observability: event counters shared by the pipeline's components
(counterpart of ``pgslam_tpu.utils.timing.counters``), summed over every
component in the process, and the tracer of :mod:`.timing` (spans, wait
sites and counters recorded while a torch profiler records). Counter
keys in use: ``loopcloser/accepted``, ``loopcloser/rejected`` and
``loopcloser/rejected_duplicate`` (each ``LoopCloser`` also keeps its
own counts).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

counters: Dict[str, float] = defaultdict(float)
