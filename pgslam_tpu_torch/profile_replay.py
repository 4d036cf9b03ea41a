"""Where a replay's time goes on the GPU.

    python -m pgslam_tpu_torch.profile_replay [loop|corridor_64k] [--trace DIR]

Runs the replay once to build and warm everything, then again under
``torch.profiler`` (CPU and CUDA activities), synchronizing after every
scan. Prints the card, the wall time per scan (the profiler's own host
overhead included), the device's busy time and idle share over the run,
the device-side events (kernels, copies) per scan, and the device time by
kernel, with the port's own kernels (K1-K3) marked. ``--trace`` also
writes a Chrome trace into DIR (tens of MB per replay).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

OWN_KERNELS = {"knn_kernel": "K1", "icp_fused_kernel": "K2",
               "lm_kernel": "K3"}


def _kernel_label(name: str) -> str:
    for key, label in OWN_KERNELS.items():
        if key in name:
            return label
    return "torch"


def profile(name: str, trace_dir=None) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from . import replays
    dev = torch.device("cuda", 0)
    replays.run_replay(name, device=dev, sync=torch.cuda.synchronize)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        per_scan, _, stats = replays.run_replay(
            name, device=dev, sync=torch.cuda.synchronize)
        wall = time.perf_counter() - t0
    n = len(per_scan)
    rows = []   # device-side events only: kernels, memcpy, memset
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            rows.append((ev.key, ev.count, ev.self_device_time_total / 1e3))
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    events = sum(r[1] for r in rows)
    by_label = {}
    for key, _, ms in rows:
        lab = _kernel_label(key)
        by_label[lab] = by_label.get(lab, 0.0) + ms
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              f"trace_{name}.json"))
    return {"replay": name, "scans": n, "wall_ms_per_scan": 1e3 * wall / n,
            "device_busy_ms_per_scan": busy_ms / n,
            "device_idle_share": 1.0 - busy_ms / (1e3 * wall),
            "device_events_per_scan": events / n,
            "device_ms_per_scan_by_kernel_group":
                {k: v / n for k, v in by_label.items()},
            "top_kernels": [{"name": k[:90], "calls": c, "ms": ms,
                             "group": _kernel_label(k)}
                            for k, c, ms in rows[:15]],
            "keyframes": stats["n_keyframes"], "loops": stats["n_loops"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("replays", nargs="*", default=["corridor_64k", "loop"])
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_replay needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for name in args.replays:
        print(json.dumps(profile(name, args.trace), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
