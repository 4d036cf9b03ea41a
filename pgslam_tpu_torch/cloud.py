"""Padded point cloud: ``points [N, 3]``, validity ``mask [N]`` and a dict
of named ``[N, D]`` descriptor channels. Counterpart of
:mod:`pgslam_tpu.cloud`; every tensor of a cloud lives on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import se3
from .utils import timing

# Descriptor channels that rotate with the cloud (unit direction fields).
ROTATED_DESCRIPTORS = ("normals", "observationDirections", "eigVectors")

# int16 clouds are millimetre fixed point.
MM_SCALE = 1000.0


@dataclasses.dataclass
class Cloud:
    points: torch.Tensor                      # [..., N, 3]
    mask: torch.Tensor                        # [..., N] bool
    descriptors: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def count(self) -> torch.Tensor:
        return self.mask.sum(-1)

    def with_descriptor(self, name: str, value: torch.Tensor) -> "Cloud":
        desc = dict(self.descriptors)
        desc[name] = value
        return dataclasses.replace(self, descriptors=desc)

    def replace(self, **kw) -> "Cloud":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "Cloud":
        """Apply ``fn`` to every tensor of the cloud."""
        return Cloud(points=fn(self.points), mask=fn(self.mask),
                     descriptors={k: fn(v)
                                  for k, v in self.descriptors.items()})


def make_cloud(points, mask=None, descriptors=None,
               capacity: Optional[int] = None, device=None,
               dtype=torch.float32) -> Cloud:
    """Build a padded cloud of ``dtype`` (float32, or float64 for the
    plain paths on the CPU; the kernels take float32) from an ``[N, 3]``
    array. int16 input is millimetre fixed point and is dequantized
    here."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    pts = np.asarray(points)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {pts.shape}")
    if pts.dtype == np.int16:
        if descriptors:
            raise ValueError("int16 (mm fixed-point) clouds cannot carry "
                             "descriptors")
        pts = (pts.astype(np.float32) * np.float32(1.0 / MM_SCALE))
    pts = pts.astype(np_dtype)
    n = pts.shape[0]
    m = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
    capacity = n if capacity is None else capacity
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    pad = capacity - n
    desc = {k: np.asarray(v, np_dtype)
            for k, v in (descriptors or {}).items()}
    if pad:
        pts = np.concatenate([pts, np.zeros((pad, 3), np_dtype)])
        m = np.concatenate([m, np.zeros(pad, bool)])
        desc = {k: np.concatenate(
            [v, np.zeros((pad,) + v.shape[1:], np_dtype)])
            for k, v in desc.items()}

    def upload(a):
        with timing.wait("cloud.upload"):
            return torch.as_tensor(a, device=device)
    return Cloud(points=upload(pts), mask=upload(m),
                 descriptors={k: upload(v) for k, v in desc.items()})


def upload(arrays, device) -> List[torch.Tensor]:
    """float32 and int32 numpy arrays to ``device`` in one copy: packed
    into one fresh host buffer (pinned for a card, so the copy does not
    hold the host; the caching host allocator keeps the block until the
    copy is done), sent, and split into views of their shapes."""
    device = torch.device(device)
    sizes = [int(np.prod(a.shape)) for a in arrays]
    host = torch.empty(sum(sizes), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    buf, off = host.numpy(), 0
    for a, n in zip(arrays, sizes):
        if a.dtype not in (np.float32, np.int32):
            raise TypeError(f"upload takes float32 and int32, not {a.dtype}")
        buf[off:off + n] = a.reshape(-1).view(np.int32)
        off += n
    dev = host.to(device, non_blocking=True)
    out, off = [], 0
    for a, n in zip(arrays, sizes):
        view = dev[off:off + n].view(a.shape)
        out.append(view.view(torch.float32) if a.dtype == np.float32
                   else view)
        off += n
    return out


def make_cloud_batch(points: Sequence, capacity: int, device=None,
                     riders: Sequence[np.ndarray] = ()):
    """One padded ``[B, capacity, 3]`` float32 cloud from B ``[N_b, 3]``
    arrays, each scan with :func:`make_cloud`'s bits (int16 is millimetre
    fixed point, dequantized as there). The points, their counts and the
    float32 ``riders`` (a step's transforms) go to ``device`` in one
    :func:`upload`; the masks are made there from the counts. Returns
    (cloud, the riders on ``device``)."""
    B = len(points)
    pts_host = np.empty((B, capacity, 3), np.float32)
    counts = np.empty(B, np.int32)
    for b, p in enumerate(points):
        p = np.asarray(p)
        if p.ndim != 2 or p.shape[1] != 3:
            raise ValueError(f"points must be [N, 3], got {p.shape}")
        n = p.shape[0]
        if n > capacity:
            raise ValueError(f"{n} points exceed capacity {capacity}")
        if p.dtype == np.int16:
            p = p.astype(np.float32) * np.float32(1.0 / MM_SCALE)
        pts_host[b, :n] = p.astype(np.float32, copy=False)
        pts_host[b, n:] = 0.0
        counts[b] = n
    riders = [np.ascontiguousarray(r, np.float32) for r in riders]
    pts, n_dev, *on_dev = upload([pts_host, counts] + riders, device)
    mask = torch.arange(capacity, device=pts.device) < n_dev[:, None]
    return Cloud(points=pts, mask=mask), on_dev


def empty_cloud(capacity: int, descriptor_spec: Optional[Dict[str, int]] = None,
                device=None) -> Cloud:
    """An all-padding cloud; ``descriptor_spec`` maps channel names to
    widths."""
    return Cloud(points=torch.zeros((capacity, 3), device=device),
                 mask=torch.zeros((capacity,), dtype=torch.bool,
                                  device=device),
                 descriptors={name: torch.zeros((capacity, dim),
                                                device=device)
                              for name, dim in
                              (descriptor_spec or {}).items()})


def concatenate_clouds(clouds: Sequence[Cloud]) -> Cloud:
    """Concatenate along the point axis; capacities add. Descriptors are
    the union of the channels, zero where a cloud lacks one."""
    keys = sorted({k for c in clouds for k in c.descriptors})
    pts = torch.cat([c.points for c in clouds])
    desc = {}
    for k in keys:
        dim = next(c.descriptors[k].shape[-1] for c in clouds
                   if k in c.descriptors)
        desc[k] = torch.cat([c.descriptors[k] if k in c.descriptors
                             else pts.new_zeros((c.capacity, dim))
                             for c in clouds])
    return Cloud(points=pts, mask=torch.cat([c.mask for c in clouds]),
                 descriptors=desc)


def pad_cloud(cloud: Cloud, capacity: int) -> Cloud:
    """Grow a cloud to ``capacity`` with padding."""
    extra = capacity - cloud.capacity
    if extra < 0:
        raise ValueError("pad_cloud cannot shrink")
    if extra == 0:
        return cloud
    grow = lambda a: torch.cat([a, a.new_zeros((extra,) + a.shape[1:])])
    return cloud.map(grow)


def dequantize_cloud(cloud: Cloud) -> Cloud:
    """int16 millimetre cloud -> float32 metres; identity otherwise."""
    if cloud.points.dtype != torch.int16:
        return cloud
    return cloud.replace(
        points=cloud.points.to(torch.float32) * (1.0 / MM_SCALE))


def transform_cloud(T: torch.Tensor, cloud: Cloud) -> Cloud:
    """Rigid transform of the points; direction descriptors rotate. A
    ``[B, N]`` batch takes ``T [B, 4, 4]``, one transform a cloud."""
    desc = {}
    for name, value in cloud.descriptors.items():
        if name in ROTATED_DESCRIPTORS and value.shape[-1] == 3:
            desc[name] = se3.rotate(T, value)
        else:
            desc[name] = value
    return cloud.replace(points=se3.apply(T, cloud.points), descriptors=desc)


def stack_clouds(clouds: Sequence[Cloud]) -> Cloud:
    """Stack equal-capacity clouds along a new leading batch axis."""
    keys = clouds[0].descriptors.keys()
    return Cloud(points=torch.stack([c.points for c in clouds]),
                 mask=torch.stack([c.mask for c in clouds]),
                 descriptors={k: torch.stack([c.descriptors[k]
                                              for c in clouds])
                              for k in keys})


def unbind_cloud(cloud: Cloud) -> List[Cloud]:
    """The clouds of a ``[B, N]`` batch, each a view of it."""
    desc = {k: v.unbind(0) for k, v in cloud.descriptors.items()}
    return [Cloud(points=p, mask=m,
                  descriptors={k: v[b] for k, v in desc.items()})
            for b, (p, m) in enumerate(zip(cloud.points.unbind(0),
                                           cloud.mask.unbind(0)))]
