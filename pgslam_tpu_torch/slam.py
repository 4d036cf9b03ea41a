"""PoseGraphSlam facade: builds MapManager -> Optimizer -> LoopCloser ->
Localizer, wires the notifications, and forwards scans. Counterpart of
:mod:`pgslam_tpu.slam` (single-threaded). Tensors live on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .cloud import Cloud, make_cloud
from .graph.pose_graph import LOOP_CONSTRAINT, MapManager
from .localizer import Localizer, LocalizerConfig
from .loopcloser import LoopCloser, LoopCloserConfig
from .optimizer import Optimizer, OptimizerConfig


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    localizer: LocalizerConfig = LocalizerConfig()
    loop_closer: LoopCloserConfig = LoopCloserConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    sensor_cloud_capacity: int = 2048


class PoseGraphSlam:
    """Single-threaded facade. ``device`` ("cpu" or "cuda") is where the
    clouds and every kernel run."""

    def __init__(self, config: SlamConfig = SlamConfig(), device=None):
        self.config = config
        self.device = torch.device(device or "cpu")
        self.map_manager = MapManager()
        self.optimizer = Optimizer(self.map_manager, config.optimizer,
                                   device=self.device)
        self.loop_closer = LoopCloser(self.map_manager, self.optimizer,
                                      config.loop_closer, device=self.device)
        self.localizer = Localizer(self.map_manager, config.localizer,
                                   device=self.device)
        self.map_manager.set_localizer(self.localizer)
        self.map_manager.set_loop_closer(self.loop_closer)

    def add_data(self, timestamp, world_frame_id: str, T_world_robot,
                 T_robot_sensor, cloud: Union[Cloud, np.ndarray]) -> None:
        if not isinstance(cloud, Cloud):
            cloud = make_cloud(np.asarray(cloud),
                               capacity=self.config.sensor_cloud_capacity,
                               device=self.device)
        self.localizer.add_new_data(timestamp, world_frame_id,
                                    np.asarray(T_world_robot, np.float32),
                                    np.asarray(T_robot_sensor, np.float32),
                                    cloud)

    AddData = add_data

    def flush(self) -> None:
        """Nothing is in flight on the per-scan path."""

    @property
    def T_world_robot(self) -> np.ndarray:
        return self.localizer.T_world_robot

    def get_graph(self):
        return self.map_manager.get_graph()

    def get_local_map(self) -> Tuple[Optional[Cloud], bool]:
        return self.localizer.get_local_map()

    def get_local_map_in_world_frame(self) -> Tuple[Optional[Cloud], bool]:
        return self.localizer.get_local_map_in_world_frame()

    def trajectory(self) -> np.ndarray:
        """Optimized keyframe poses ``[n, 4, 4]``."""
        g = self.map_manager.get_graph()
        return g.optimized_poses[:g.n_vertices].copy()

    def n_loop_edges(self) -> int:
        g = self.map_manager.get_graph()
        return int(np.sum(g.edge_type[:g.n_edges] == LOOP_CONSTRAINT))

    def write_graphviz(self, path: str) -> None:
        self.map_manager.write_graphviz(path)

    WriteGraphviz = write_graphviz
