"""Padded point cloud: ``points [N, 3]``, validity ``mask [N]`` and a dict
of named ``[N, D]`` descriptor channels. Counterpart of
:mod:`pgslam_tpu.cloud`; every tensor of a cloud lives on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import se3

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
               capacity: Optional[int] = None, device=None) -> Cloud:
    """Build a padded float32 cloud from an ``[N, 3]`` array. int16 input
    is millimetre fixed point and is dequantized here."""
    pts = np.asarray(points)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {pts.shape}")
    if pts.dtype == np.int16:
        if descriptors:
            raise ValueError("int16 (mm fixed-point) clouds cannot carry "
                             "descriptors")
        pts = (pts.astype(np.float32) * np.float32(1.0 / MM_SCALE))
    pts = pts.astype(np.float32)
    n = pts.shape[0]
    m = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
    capacity = n if capacity is None else capacity
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    pad = capacity - n
    desc = {k: np.asarray(v, np.float32)
            for k, v in (descriptors or {}).items()}
    if pad:
        pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
        m = np.concatenate([m, np.zeros(pad, bool)])
        desc = {k: np.concatenate(
            [v, np.zeros((pad,) + v.shape[1:], np.float32)])
            for k, v in desc.items()}
    return Cloud(points=torch.as_tensor(pts, device=device),
                 mask=torch.as_tensor(m, device=device),
                 descriptors={k: torch.as_tensor(v, device=device)
                              for k, v in desc.items()})


def dequantize_cloud(cloud: Cloud) -> Cloud:
    """int16 millimetre cloud -> float32 metres; identity otherwise."""
    if cloud.points.dtype != torch.int16:
        return cloud
    return cloud.replace(
        points=cloud.points.to(torch.float32) * (1.0 / MM_SCALE))


def transform_cloud(T: torch.Tensor, cloud: Cloud) -> Cloud:
    """Rigid transform of the points; direction descriptors rotate."""
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
