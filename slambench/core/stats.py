"""The benchmark's arithmetic: percentiles, rates, the union of device
intervals, and the rooflines. Kept here, under the
benchmark's own paths, so that a change to the program cannot move it.

The peaks are NVIDIA's published figures for one H100 SXM (data sheet,
dense rates): 67 TFLOP/s of float32 outside the tensor cores and 3.35
TB/s of HBM3 bandwidth, at the full 700 W power limit.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

FP32_FLOPS = 67e12          # float32, CUDA cores
HBM_BYTES_PER_S = 3.35e12   # HBM3


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all
    ``values``: the ``ceil(q / 100 * n)``-th smallest."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[rank - 1])


def rate(count: float, seconds: float) -> float:
    """Work done over the whole window: ``count / seconds``."""
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return count / seconds


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The stretches of ``[start, end]`` that no interval covers."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(s, e) for s, e in out if e > s]


def knn_work(nq: int, nr: int, k: int) -> Tuple[float, float]:
    """(operations, bytes) that one exact k-NN launch needs: every
    (query, reference) pair's expanded squared distance, 8 fp32
    operations (three products and two sums for the cross term, the
    doubling and two sums with the norms; the norms and the selection
    are not counted); each input byte read once (points 12 bytes, masks
    1 byte each) and each output byte written once (a float32 distance
    and an int32 id per neighbour)."""
    ops = 8.0 * nq * nr
    nbytes = 13.0 * (nq + nr) + 8.0 * nq * k
    return ops, nbytes


def least_time(ops: float, nbytes: float) -> float:
    """The roofline's least seconds: the larger of operations over the
    fp32 peak and bytes over the HBM bandwidth."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
