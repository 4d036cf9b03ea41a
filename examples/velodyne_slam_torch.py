"""BASELINE config 4 on the PyTorch/CUDA port: Velodyne-scale SLAM from
KITTI ``.bin`` files.

Renders a corridor drive of 64k-point spins, writes each spin as a KITTI
velodyne ``.bin`` file (``save_kitti_bin``) into a temporary directory,
streams the directory back through the native ``ScanLoader`` and feeds
every scan to ``pgslam_tpu_torch.PoseGraphSlam`` under the 64k-point
point-to-plane profile. Prints each scan's pose error to the rendered
truth and the milliseconds per scan. Nothing is downloaded.

    python examples/velodyne_slam_torch.py [--scans 16] [--points 65536]
        [--cpu] [--quantize] [--fused-single] [--sync-lag 0]

``--quantize`` streams int16 millimetre scans, ``--fused-single``
registers each scan in one K2 launch (``PGSLAM_FUSED_SINGLE=1``; on the
card only) and ``--sync-lag 2`` is the deployable live loop. The card is
the default; ``--cpu`` runs the plain PyTorch versions of the kernels
(use a few thousand points there).
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def write_drive(directory: str, n_scans: int, n_points: int, seed: int = 0):
    """Render the corridor drive and write one KITTI ``.bin`` per spin;
    returns the true sensor poses."""
    from pgslam_tpu_torch import save_kitti_bin
    from pgslam_tpu_torch.datasets import corridor_world, render_scan
    rng = np.random.default_rng(seed)
    world = corridor_world(rng, n_points=200000, length=60.0, width=8.0,
                           height=5.0)
    truth = []
    for i in range(n_scans):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [2.0 + i * 1.0, 0.0, 1.8]
        scan = render_scan(world, T, rng, n_points, max_range=30.0,
                           noise=0.01)
        reflectance = rng.uniform(0.0, 1.0, len(scan)).astype(np.float32)
        save_kitti_bin(os.path.join(directory, f"{i:06d}.bin"), scan,
                       reflectance)
        truth.append(T)
    return truth


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=16)
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--fused-single", action="store_true")
    ap.add_argument("--sync-lag", type=int, default=0)
    args = ap.parse_args(argv)

    import pgslam_tpu_torch.localizer as localizer
    from pgslam_tpu_torch import PoseGraphSlam, ScanLoader
    from pgslam_tpu_torch.native import native_available
    from pgslam_tpu_torch.replays import velodyne_config
    if not native_available():
        raise SystemExit("the native scan loader did not build (g++)")
    if args.fused_single:
        localizer.FUSED_SINGLE = True
    device = "cpu" if args.cpu else None
    sync = None
    if not args.cpu:
        import torch
        sync = torch.cuda.synchronize

    with tempfile.TemporaryDirectory() as directory:
        truth = write_drive(directory, args.scans, args.points)
        slam = PoseGraphSlam(velodyne_config(args.sync_lag), device=device)
        T_rs = np.eye(4, dtype=np.float32)
        times = []
        with ScanLoader(directory, quantize_mm=args.quantize) as loader:
            for i, scan in enumerate(loader):
                t0 = time.perf_counter()
                # the truth as odometry: the map, not the prior, is shown
                slam.add_data(i, "world", truth[i], T_rs, scan[:65536])
                if sync is not None:
                    sync()
                times.append(time.perf_counter() - t0)
                est = slam.localizer.T_world_robot
                err = float(np.linalg.norm(est[:3, 3] - truth[i][:3, 3]))
                print(f"scan {i}: pose=({est[0, 3]:.3f}, {est[1, 3]:.3f}, "
                      f"{est[2, 3]:.3f}) error={err:.4f} m "
                      f"keyframes={slam.get_graph().n_vertices}")
        slam.flush()
    warm = times[1:] or times
    print(f"{1e3 * float(np.mean(warm)):.3f} ms/scan after the first, "
          f"{len(times)} scans, native loader"
          f"{', int16' if args.quantize else ''}"
          f"{', single-scan K2 route' if args.fused_single else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
