"""pgslam_tpu_torch: the PyTorch and CUDA port of pgslam_tpu.

Pose-graph SLAM over lidar scans: scan-to-local-map ICP, loop-closure
search and verification, and SE(3) Levenberg-Marquardt. The hot kernels
are hand-written CUDA for Hopper (``csrc/``): exact k-NN (K1), a whole
ICP registration (K2), a whole LM optimize (K3) and the PCG solve of one
LM step across the card (K4, for large graphs); each has a plain PyTorch
version beside it that runs on CPU tensors.

    slam = PoseGraphSlam(config)      # on the GPU; device="cpu" for the CPU
    slam.add_data(timestamp, frame_id, T_world_robot, T_robot_sensor, cloud)
    slam.flush()                      # sync_lag / micro_batch: commit all

    with PoseGraphSlamMT(config) as mt:   # three worker threads
        mt.add_data(timestamp, frame_id, T_world_robot, T_robot_sensor,
                    cloud)
        mt.wait_idle()

    fleet = MultiAgentSlam(config, n_agents=16)   # one shared pose graph
    fleet.add_data_batch(timestamp, frame_id, T_world_robots, T_robot_sensor,
                         clouds)
    result = batched_register(readings, references, T_inits, icp_config)

    from pgslam_tpu_torch.parallel.multichip import make_mesh
    mesh = make_mesh(8, tp=2)       # dp = 4 x tp = 2 over cuda:0..7; or
    mesh = make_mesh(8, tp=2, devices=["cuda:0"] * 8)   # on one card
    fleet = MultiAgentSlam(config, n_agents=16, mesh=mesh)
    result = make_sharded_register(mesh, icp_config)(readings, references,
                                                     T_inits)

This package imports torch and numpy only, never jax or pgslam_tpu.
"""

__version__ = "0.1.0"

import torch as _torch

# The exact matcher and the SE(3) solves need true fp32 products, the
# counterpart of pgslam_tpu's "highest" matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import metrics, se3  # noqa: E402,F401
from .cloud import (Cloud, empty_cloud, make_cloud,  # noqa: E402,F401
                    transform_cloud)
from .ops.icp import ICPConfig, ICPEngine, ICPResult, icp  # noqa: E402,F401

# name -> submodule; each is imported at first use.
_LAZY = {
    **dict.fromkeys(("PoseGraphSlam", "SlamConfig"), "slam"),
    "PoseGraphSlamMT": "pipeline",
    "PoseGraph": "graph.pose_graph",
    "LocalMap": "localmap",
    "MultiAgentSlam": "parallel.multi_agent",
    "batched_register": "parallel.batched",
    "make_sharded_register": "parallel.sharded_icp",
    **dict.fromkeys(("LocalizerConfig", "Localizer"), "localizer"),
    **dict.fromkeys(("LoopCloserConfig", "LoopCloser"), "loopcloser"),
    **dict.fromkeys(("OptimizerConfig", "Optimizer"), "optimizer"),
    **dict.fromkeys(("PGOConfig", "optimize_pose_graph", "pose_marginals"),
                    "optim.pgo"),
    **dict.fromkeys(("save_checkpoint", "load_checkpoint",
                     "save_trajectory_kitti", "load_trajectory_kitti",
                     "save_trajectory_tum", "load_trajectory_tum"), "io"),
    **dict.fromkeys(("ate_rmse", "rpe", "align_umeyama"), "eval"),
    **dict.fromkeys(("prefetch_clouds", "prefetch_batches"),
                    "utils.prefetch"),
    "ScanLoader": "native",
    **dict.fromkeys(("load_kitti_bin", "save_kitti_bin",
                     "harsh_velodyne_pair"), "datasets"),
}

__all__ = ["se3", "metrics", "Cloud", "make_cloud", "empty_cloud",
           "transform_cloud", "ICPConfig", "ICPEngine", "ICPResult", "icp",
           *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module 'pgslam_tpu_torch' has no attribute "
                         f"{name!r}")
