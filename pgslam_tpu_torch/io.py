"""Checkpoints, trajectories and point clouds on disk. Counterpart of
:mod:`pgslam_tpu.io`, with the same file formats:

* a checkpoint is one ``.npz`` with the pose-graph arrays, every keyframe
  cloud (points, mask, descriptors), the fixed vertex, the logical clock
  and the localizer's pose and composition state, under the same keys and
  ``FORMAT_VERSION``, so that a checkpoint written by either package
  loads in the other;
* trajectories in the KITTI odometry and the TUM formats;
* clouds as PLY (x, y, z and, where present, the normals).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cloud import Cloud, make_cloud
from .devices import resolve_device
from .graph.pose_graph import MapManager, PoseGraph

FORMAT_VERSION = 1


def _cloud_arrays(prefix: str, cloud: Cloud, out: dict) -> None:
    out[f"{prefix}/points"] = cloud.points.cpu().numpy()
    out[f"{prefix}/mask"] = cloud.mask.cpu().numpy()
    for k, v in cloud.descriptors.items():
        out[f"{prefix}/desc/{k}"] = v.cpu().numpy()


def _cloud_from(prefix: str, data, device) -> Cloud:
    desc_prefix = f"{prefix}/desc/"
    put = lambda a: torch.as_tensor(np.asarray(a), device=device)
    return Cloud(points=put(data[f"{prefix}/points"]),
                 mask=put(data[f"{prefix}/mask"]),
                 descriptors={k[len(desc_prefix):]: put(data[k])
                              for k in data.files
                              if k.startswith(desc_prefix)})


def save_checkpoint(path: str, map_manager: MapManager,
                    localizer=None) -> None:
    """Write the map (and the localizer's state) to ``path``."""
    g = map_manager.get_graph()
    nv, ne = g.n_vertices, g.n_edges
    out = {
        "format_version": FORMAT_VERSION,
        "n_vertices": nv,
        "n_edges": ne,
        "fixed_vertex": map_manager.fixed_vertex
        if map_manager.fixed_vertex is not None else -1,
        "clock": map_manager._clock,
        "poses": g.poses[:nv],
        "optimized_poses": g.optimized_poses[:nv],
        "update_times": g.update_times[:nv],
        "edge_from": g.edge_from[:ne],
        "edge_to": g.edge_to[:ne],
        "edge_T": g.edge_T[:ne],
        "edge_cov": g.edge_cov[:ne],
        "edge_type": g.edge_type[:ne],
        "edge_weight": g.edge_weight[:ne],
    }
    for v in range(nv):
        _cloud_arrays(f"cloud/{v}", g.clouds[v], out)
    if localizer is not None:
        out["localizer/T_refkf_robot"] = localizer.T_refkf_robot
        out["localizer/T_world_robot"] = localizer.T_world_robot
        out["localizer/last_input_T_world_robot"] = \
            localizer.last_input_T_world_robot
        out["localizer/count"] = localizer.count
        out["localizer/composition"] = np.asarray(
            localizer.local_map.get_composition().as_list()
            if localizer.local_map.has_cloud() else [], np.int64)
    np.savez_compressed(path, **out)


def load_checkpoint(path: str, map_manager: MapManager, localizer=None,
                    device=None) -> None:
    """Restore the state in place into a freshly built ``map_manager``
    (and ``localizer``, whose local map is rebuilt and installed in its
    ICP engine). Clouds land on the localizer's device, else on
    ``device`` (the card when None)."""
    device = localizer.device if localizer is not None \
        else resolve_device(device)
    data = np.load(path, allow_pickle=False)
    version = int(data["format_version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {version}")
    nv, ne = int(data["n_vertices"]), int(data["n_edges"])
    g = PoseGraph(initial_vertex_capacity=max(64, nv),
                  initial_edge_capacity=max(128, ne))
    g.n_vertices, g.n_edges = nv, ne
    g.poses[:nv] = data["poses"]
    g.optimized_poses[:nv] = data["optimized_poses"]
    g.update_times[:nv] = data["update_times"]
    g.edge_from[:ne] = data["edge_from"]
    g.edge_to[:ne] = data["edge_to"]
    g.edge_T[:ne] = data["edge_T"]
    g.edge_cov[:ne] = data["edge_cov"]
    g.edge_type[:ne] = data["edge_type"]
    g.edge_weight[:ne] = data["edge_weight"]
    g.clouds = [_cloud_from(f"cloud/{v}", data, device) for v in range(nv)]
    # A restore is not an append: no resident optimizer's device copy may
    # survive it. Every restored graph lands at epoch 1, and a new graph
    # object can reuse a freed one's id(), so mirrors also key on a
    # per-object token (optim/resident.py::_graph_token); the bump covers
    # a restore into the same object.
    g.mutation_epoch += 1
    map_manager.graph = g
    fixed = int(data["fixed_vertex"])
    map_manager.fixed_vertex = None if fixed < 0 else fixed
    map_manager._clock = int(data["clock"])
    if localizer is not None and "localizer/count" in data.files:
        localizer.T_refkf_robot = data["localizer/T_refkf_robot"]
        localizer.T_world_robot = data["localizer/T_world_robot"]
        localizer.last_input_T_world_robot = \
            data["localizer/last_input_T_world_robot"]
        localizer.count = int(data["localizer/count"])
        comp_list = [int(v) for v in data["localizer/composition"]]
        if comp_list:
            from .localmap import Composition
            comp = Composition(localizer.local_map.capacity(), comp_list)
            localizer.next_composition = Composition(comp.capacity,
                                                     comp_list)
            localizer.local_map.update_to_new_composition(g, comp)
            localizer.icp_engine.set_map(localizer.local_map.cloud())


# -- trajectories -------------------------------------------------------------

def save_trajectory_kitti(path: str, poses) -> None:
    """``[N, 4, 4]`` poses in the KITTI odometry format: per pose one
    line of the upper 3x4 block, row-major."""
    arr = np.asarray(poses, dtype=np.float64).reshape(-1, 4, 4)
    np.savetxt(path, arr[:, :3, :].reshape(len(arr), 12), fmt="%.9e")


def load_trajectory_kitti(path: str) -> np.ndarray:
    """KITTI odometry poses as ``[N, 4, 4]`` float32."""
    flat = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    out = np.tile(np.eye(4, dtype=np.float32), (len(flat), 1, 1))
    out[:, :3, :] = flat.astype(np.float32)
    return out


def save_trajectory_tum(path: str, poses, timestamps=None) -> None:
    """Poses in the TUM format, ``t tx ty tz qx qy qz qw`` per line;
    ``timestamps`` default to the pose index."""
    from . import se3
    arr = np.asarray(poses, dtype=np.float32).reshape(-1, 4, 4)
    q = se3.quaternion_from_matrix(
        torch.as_tensor(arr[:, :3, :3])).numpy()            # (w, x, y, z)
    ts = np.arange(len(arr), dtype=np.float64) if timestamps is None \
        else np.asarray(timestamps, dtype=np.float64)
    cols = np.column_stack([ts, arr[:, :3, 3], q[:, 1], q[:, 2], q[:, 3],
                            q[:, 0]])
    np.savetxt(path, cols, fmt="%.9f")


def load_trajectory_tum(path: str):
    """A TUM trajectory as (timestamps ``[N]``, poses ``[N, 4, 4]``
    float32)."""
    data = np.loadtxt(path, dtype=np.float64).reshape(-1, 8)
    t = data[:, 1:4].astype(np.float32)
    x, y, z, w = data[:, 4:8].astype(np.float32).T
    R = np.empty((len(data), 3, 3), np.float32)
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - z * w)
    R[:, 0, 2] = 2 * (x * z + y * w)
    R[:, 1, 0] = 2 * (x * y + z * w)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - x * w)
    R[:, 2, 0] = 2 * (x * z - y * w)
    R[:, 2, 1] = 2 * (y * z + x * w)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(data), 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = t
    return data[:, 0], poses


# -- point clouds -------------------------------------------------------------

def save_cloud_ply(path: str, cloud, binary: bool = True) -> None:
    """A :class:`Cloud` (or an ``[N, 3]`` array) as PLY; masked points are
    dropped, a ``normals`` descriptor becomes nx, ny, nz."""
    if isinstance(cloud, Cloud):
        mask = cloud.mask.cpu().numpy()
        pts = cloud.points.cpu().numpy()[mask].astype(np.float32)
        normals = cloud.descriptors.get("normals")
        normals = None if normals is None \
            else normals.cpu().numpy()[mask].astype(np.float32)
    else:
        pts = np.asarray(cloud, dtype=np.float32).reshape(-1, 3)
        normals = None
    props = ["property float x", "property float y", "property float z"]
    cols = [pts]
    if normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(normals)
    fmt = "binary_little_endian" if binary else "ascii"
    header = ("ply\nformat %s 1.0\nelement vertex %d\n%s\nend_header\n"
              % (fmt, len(pts), "\n".join(props)))
    data = np.column_stack(cols).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def load_cloud_ply(path: str, capacity: Optional[int] = None,
                   device=None) -> Cloud:
    """A PLY written by :func:`save_cloud_ply` as a :class:`Cloud` on
    ``device`` (the card when None)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header
                 if h.startswith("element vertex"))
        props = [h.split()[-1] for h in header if h.startswith("property")]
        width = len(props)
        if any("binary_little_endian" in h for h in header):
            data = np.frombuffer(f.read(4 * n * width),
                                 dtype="<f4").reshape(n, width)
        else:
            data = np.loadtxt(f, dtype=np.float32).reshape(n, width)
    descriptors = {}
    if "nx" in props:
        i = props.index("nx")
        descriptors["normals"] = data[:, i:i + 3]
    return make_cloud(data[:, :3], capacity=capacity or n,
                      descriptors=descriptors, device=device)
