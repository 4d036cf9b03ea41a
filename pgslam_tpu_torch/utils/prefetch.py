"""Host-to-device staging ahead of the consumer. Counterpart of
:mod:`pgslam_tpu.utils.prefetch`: while scan t registers on the card,
the copies of the next ``depth`` scans are already in flight.

Each scan is staged in its own pinned host tensor and copied with
``non_blocking=True`` on the current stream. Nothing reuses a staging
tensor by hand: PyTorch's pinned-memory allocator hands a block out again
only after the copies recorded on it have run.

    for cloud in prefetch_clouds(raw_scans, capacity=2048):
        slam.add_data(t, "world", odom[t], T_rs, cloud)
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

from ..cloud import Cloud, make_cloud
from ..devices import resolve_device


def _ahead(items: Iterable, put, depth: int) -> Iterator:
    """Yield ``put(x)`` for each item, ``depth`` puts ahead."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    queue: collections.deque = collections.deque()
    it = iter(items)
    for x in it:
        queue.append(put(x))
        if len(queue) > depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def prefetch_clouds(scans: Iterable, capacity: int, depth: int = 2,
                    device=None) -> Iterator[Cloud]:
    """Yield a :class:`Cloud` on ``device`` (the card unless
    ``device="cpu"``) for each raw ``[N, 3]`` scan (float32, or int16
    millimetres) or host :class:`Cloud`, with ``depth`` copies in flight
    ahead of the consumer. Padding to ``capacity`` is :func:`make_cloud`'s."""
    dev = resolve_device(device)

    def put(scan) -> Cloud:
        cloud = scan if isinstance(scan, Cloud) else make_cloud(
            np.asarray(scan), capacity=capacity)
        return cloud.map(lambda a: _to_device(a, dev))

    return _ahead(scans, put, depth)


def prefetch_batches(batches: Iterable, depth: int = 1,
                     device=None) -> Iterator:
    """Copy every numpy array, tensor and :class:`Cloud` of each batch (a
    dict, list or tuple nesting them, or one of them) to ``device``,
    ``depth`` batches ahead of the consumer; other leaves pass as they
    are."""
    dev = resolve_device(device)

    def put(tree):
        if isinstance(tree, dict):
            return {k: put(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(put(v) for v in tree)
        if isinstance(tree, Cloud):
            return tree.map(lambda a: _to_device(a, dev))
        if isinstance(tree, torch.Tensor):
            return _to_device(tree, dev)
        if isinstance(tree, np.ndarray):
            return _to_device(torch.as_tensor(tree), dev)
        if isinstance(tree, list):
            return [put(v) for v in tree]
        return tree

    return _ahead(batches, put, depth)
