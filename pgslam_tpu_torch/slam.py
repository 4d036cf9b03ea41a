"""PoseGraphSlam facade: builds MapManager -> Optimizer -> LoopCloser ->
Localizer, wires the notifications, and forwards scans. Counterpart of
:mod:`pgslam_tpu.slam` (single-threaded; the threaded facade is
:class:`~pgslam_tpu_torch.pipeline.PoseGraphSlamMT`). Tensors live on
``device`` (the GPU unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

from .cloud import Cloud, make_cloud
from .devices import resolve_device
from .graph.pose_graph import LOOP_CONSTRAINT, MapManager
from .localizer import Localizer, LocalizerConfig
from .loopcloser import LoopCloser, LoopCloserConfig
from .optimizer import Optimizer, OptimizerConfig
from .utils import timing


def assemble_global_map(graph, max_points_per_keyframe: int = 0
                        ) -> np.ndarray:
    """The body of :meth:`PoseGraphSlam.global_map` for ``graph``."""
    parts = []
    for v in range(graph.n_vertices):
        cloud = graph.clouds[v]
        if cloud is None:
            continue
        pts = cloud.points[cloud.mask].cpu().numpy()
        if max_points_per_keyframe and len(pts) > max_points_per_keyframe:
            pts = pts[::len(pts) // max_points_per_keyframe + 1]
        T = np.asarray(graph.optimized_poses[v], dtype=np.float32)
        parts.append(pts @ T[:3, :3].T + T[:3, 3])
    if not parts:
        return np.zeros((0, 3), np.float32)
    return np.concatenate(parts, axis=0)


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    localizer: LocalizerConfig = LocalizerConfig()
    loop_closer: LoopCloserConfig = LoopCloserConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    sensor_cloud_capacity: int = 2048


class PoseGraphSlam:
    """Single-threaded facade. ``device`` is where the clouds and every
    kernel run: the card by default, the CPU with ``device="cpu"``."""

    def __init__(self, config: SlamConfig = SlamConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        self.map_manager = MapManager()
        self.optimizer = Optimizer(self.map_manager, config.optimizer,
                                   device=self.device)
        self.loop_closer = LoopCloser(self.map_manager, self.optimizer,
                                      config.loop_closer, device=self.device)
        self.localizer = Localizer(self.map_manager, config.localizer,
                                   device=self.device)
        self.map_manager.set_localizer(self.localizer)
        self.map_manager.set_loop_closer(self.loop_closer)

    @classmethod
    def from_yaml(cls, path: str, device=None) -> "PoseGraphSlam":
        """Build from one nested SLAM YAML (``config.load_slam_config``)."""
        from .config import load_slam_config
        return cls(load_slam_config(path), device=device)

    @classmethod
    def from_config_paths(cls, localizer_icp_config: str,
                          localizer_input_filters_config: str,
                          loop_closer_icp_config: str,
                          device=None) -> "PoseGraphSlam":
        """The reference constructor's three YAML paths: the localizer's
        ICP pipeline, its input filters, the loop closer's ICP pipeline."""
        from .config import load_icp_config, load_input_filters
        cfg = SlamConfig(
            localizer=LocalizerConfig(
                icp=load_icp_config(localizer_icp_config),
                input_filters=load_input_filters(
                    localizer_input_filters_config)),
            loop_closer=LoopCloserConfig(
                icp=load_icp_config(loop_closer_icp_config)))
        return cls(cfg, device=device)

    def set_icp_config(self, path: str,
                       localizer_icp_config: Optional[str] = None,
                       loop_closer_icp_config: Optional[str] = None) -> None:
        """One ICP YAML for both the localizer and the loop closer, or the
        reference's three paths (input filters, localizer ICP, loop-closer
        ICP), each handed to its component."""
        if localizer_icp_config is None and loop_closer_icp_config is None:
            self.localizer.set_icp_config(path)
            self.loop_closer.set_icp_config(path)
            return
        if localizer_icp_config is None or loop_closer_icp_config is None:
            raise TypeError("set_icp_config takes either one ICP YAML path "
                            "or the reference's three paths (input filters, "
                            "localizer ICP, loop-closer ICP)")
        self.localizer.set_input_filters_config(path)
        self.localizer.set_icp_config(localizer_icp_config)
        self.loop_closer.set_icp_config(loop_closer_icp_config)

    SetIcpConfig = set_icp_config

    def set_input_filters_config(self, path: str) -> None:
        self.localizer.set_input_filters_config(path)

    def add_data(self, timestamp, world_frame_id: str, T_world_robot,
                 T_robot_sensor, cloud: Union[Cloud, np.ndarray]) -> None:
        with timing.span("pgslam.slam.step", step=True):
            timing.count("steps")
            timing.count("scans")
            if not isinstance(cloud, Cloud):
                cloud = make_cloud(np.asarray(cloud),
                                   capacity=self.config.sensor_cloud_capacity,
                                   device=self.device)
            self.localizer.add_new_data(
                timestamp, world_frame_id,
                np.asarray(T_world_robot, np.float32),
                np.asarray(T_robot_sensor, np.float32), cloud)

    AddData = add_data

    def flush(self) -> None:
        """Commit every buffered and in-flight scan and every deferred
        loop-closure verification (``sync_lag``, ``micro_batch``,
        ``deferred_verification``); nothing on the classic path. Every
        accessor below calls it, so reads reflect every scan given to
        :meth:`add_data`."""
        self.localizer.flush()

    @property
    def T_world_robot(self) -> np.ndarray:
        self.flush()
        return self.localizer.T_world_robot

    def get_graph(self):
        self.flush()
        return self.map_manager.get_graph()

    def get_local_map(self) -> Tuple[Optional[Cloud], bool]:
        self.flush()
        return self.localizer.get_local_map()

    def get_local_map_in_world_frame(self) -> Tuple[Optional[Cloud], bool]:
        self.flush()
        return self.localizer.get_local_map_in_world_frame()

    def trajectory(self) -> np.ndarray:
        """Optimized keyframe poses ``[n, 4, 4]``."""
        self.flush()
        g = self.map_manager.get_graph()
        return g.optimized_poses[:g.n_vertices].copy()

    def global_map(self, max_points_per_keyframe: int = 0) -> np.ndarray:
        """Every keyframe cloud in the world frame at its optimized pose,
        masked points dropped, as one ``[N, 3]`` float32 array; at most
        every ``len // max_points_per_keyframe + 1``-th point of a
        keyframe with more than ``max_points_per_keyframe``. Export with
        :func:`pgslam_tpu_torch.io.save_cloud_ply`."""
        self.flush()
        return assemble_global_map(self.map_manager.get_graph(),
                                   max_points_per_keyframe)

    def n_loop_edges(self) -> int:
        self.flush()
        g = self.map_manager.get_graph()
        return int(np.sum(g.edge_type[:g.n_edges] == LOOP_CONSTRAINT))

    def write_graphviz(self, path: str) -> None:
        self.flush()
        self.map_manager.write_graphviz(path)

    WriteGraphviz = write_graphviz
