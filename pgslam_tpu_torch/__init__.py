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

This package imports torch and numpy only, never jax or pgslam_tpu.
"""

__version__ = "0.1.0"

import torch as _torch

# The exact matcher and the SE(3) solves need true fp32 products, the
# counterpart of pgslam_tpu's "highest" matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import metrics, se3  # noqa: E402,F401
from .cloud import Cloud, make_cloud, transform_cloud  # noqa: E402,F401
from .ops.icp import ICPConfig, ICPEngine, ICPResult  # noqa: E402,F401

__all__ = ["se3", "metrics", "Cloud", "make_cloud", "transform_cloud",
           "ICPConfig", "ICPEngine", "ICPResult", "PoseGraphSlam",
           "PoseGraphSlamMT", "SlamConfig", "PGOConfig", "optimize_pose_graph", "pose_marginals",
           "MultiAgentSlam", "batched_register"]


def __getattr__(name):
    if name in ("PoseGraphSlam", "SlamConfig"):
        from . import slam
        return getattr(slam, name)
    if name == "PoseGraphSlamMT":
        from .pipeline import PoseGraphSlamMT
        return PoseGraphSlamMT
    if name in ("PGOConfig", "optimize_pose_graph", "pose_marginals"):
        from .optim import pgo
        return getattr(pgo, name)
    if name == "MultiAgentSlam":
        from .parallel.multi_agent import MultiAgentSlam
        return MultiAgentSlam
    if name == "batched_register":
        from .parallel.batched import batched_register
        return batched_register
    raise AttributeError(f"module 'pgslam_tpu_torch' has no attribute "
                         f"{name!r}")
