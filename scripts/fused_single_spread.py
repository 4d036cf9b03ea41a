"""The spread of the single-scan K2 route on the golden loop, on the CPU.

    python scripts/fused_single_spread.py [--seeds 16] [--noise 1e-6]
        [--replay loop]

Replays the sequence through ``pgslam_tpu_torch.PoseGraphSlam`` with the
route forced on (``localizer.FUSED_SINGLE``; on the CPU K2's plain
version runs it), once as recorded and once per seed with every
odometry pose's translation moved by ``--noise`` metres (normal), and
prints each run's largest per-scan gap to the replay's fixture, the scan
it falls on, and the keyframe and loop counts. The route's whole-replay
limit on the card is set from these runs (PERF.md, section 6).
Imports torch and the port only.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def run(name: str, noise: float, seed: int):
    from pgslam_tpu_torch import localizer, replays
    from pgslam_tpu_torch.slam import PoseGraphSlam
    localizer.FUSED_SINGLE = True
    localizer.FUSED_SINGLE_DEVICES = ("cuda", "cpu")
    scans, odom, _ = replays.REPLAYS[name][0]()
    rng = np.random.default_rng(seed)
    slam = PoseGraphSlam(replays.REPLAYS[name][1](), device="cpu")
    T_rs = np.eye(4, dtype=np.float32)
    per_scan = []
    for i, (scan, T) in enumerate(zip(scans, odom)):
        T = T.copy()
        T[:3, 3] += noise * rng.normal(size=3)
        slam.add_data(i, "world", T, T_rs, scan)
        per_scan.append(slam.localizer.T_world_robot.copy())
    gaps = replays.per_scan_gaps(np.stack(per_scan),
                                 replays.fixture(name)["per_scan_poses"])
    return (float(gaps.max()), int(gaps.argmax()),
            slam.get_graph().n_vertices, slam.n_loop_edges())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--noise", type=float, default=1e-6)
    ap.add_argument("--replay", default="loop")
    args = ap.parse_args()
    torch.set_num_threads(1)
    for seed in range(args.seeds + 1):
        noise = 0.0 if seed == 0 else args.noise
        gap, at, kf, loops = run(args.replay, noise, seed)
        print(f"{args.replay} route on, odometry moved {noise:g} m "
              f"(seed {seed}): max gap {gap:.5f} m at scan {at}, "
              f"{kf} keyframes, {loops} loops", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
