"""Build the port's objects from the JAX package's state handed over as
numpy arrays and plain dicts (no import of the JAX package).

* :func:`cloud_from_numpy` - a :class:`Cloud` from points, mask and
  descriptors;
* :func:`config_from_dict` - a port config from ``dataclasses.asdict`` of
  the JAX config of the same name (nested configs, filter and outlier
  tuples included);
* :func:`graph_from_arrays` - a :class:`PoseGraph` from its arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .cloud import Cloud
from .graph.pose_graph import PoseGraph
from .ops import filters as F
from .ops import outlier as O

_OUTLIERS = (O.TrimmedDist, O.MaxDist)
_FILTERS = (F.VoxelGrid, F.Compact, F.SurfaceNormal)
_CHAIN_FIELDS = {"outlier": _OUTLIERS, "reading_filters": _FILTERS,
                 "reference_filters": _FILTERS, "input_filters": _FILTERS}


def cloud_from_numpy(points, mask=None, descriptors=None,
                     device=None) -> Cloud:
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    m = (torch.ones(pts.shape[:-1], dtype=torch.bool, device=device)
         if mask is None else torch.as_tensor(np.asarray(mask, bool),
                                              device=device))
    desc = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in (descriptors or {}).items()}
    return Cloud(points=pts, mask=m, descriptors=desc)


def _chain_entry(d: dict, classes):
    """The one class of ``classes`` whose field names are ``d``'s keys."""
    keys = set(d)
    for cls in classes:
        if {f.name for f in dataclasses.fields(cls)} == keys:
            return cls(**d)
    raise NotImplementedError(
        f"no ported filter/outlier has the fields {sorted(keys)}")


def config_from_dict(cls, d: dict):
    """``cls(**d)`` with nested configs and chains rebuilt."""
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(names)
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kwargs = {}
    for name, value in d.items():
        default = names[name].default
        if name in _CHAIN_FIELDS:
            kwargs[name] = tuple(_chain_entry(x, _CHAIN_FIELDS[name])
                                 for x in value)
        elif dataclasses.is_dataclass(default):
            kwargs[name] = config_from_dict(type(default), value)
        elif isinstance(value, list):
            kwargs[name] = tuple(value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def graph_from_arrays(poses, optimized_poses, update_times, edge_from,
                      edge_to, edge_T, edge_cov, edge_type,
                      clouds: Optional[Sequence[Cloud]] = None) -> PoseGraph:
    """A pose graph holding exactly these vertices and edges."""
    n = len(poses)
    g = PoseGraph()
    for v in range(n):
        g.add_vertex(None if clouds is None else clouds[v], poses[v],
                     int(update_times[v]))
        g.optimized_poses[v] = np.asarray(optimized_poses[v], np.float32)
    for e in range(len(edge_from)):
        g.add_edge(int(edge_from[e]), int(edge_to[e]), edge_T[e],
                   edge_cov[e], int(edge_type[e]))
    return g
