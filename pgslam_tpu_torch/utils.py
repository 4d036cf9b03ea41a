"""Event counters shared by the pipeline's components (counterpart of
``pgslam_tpu.utils.timing.counters``), summed over every component in
the process. Keys in use: ``loopcloser/accepted``, ``loopcloser/rejected``
and ``loopcloser/rejected_duplicate`` (each ``LoopCloser`` also keeps its
own counts).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

counters: Dict[str, float] = defaultdict(float)
