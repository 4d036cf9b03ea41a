"""Where a replay's or a large-graph optimize's time goes on the GPU.

    python -m pgslam_tpu_torch.profile_replay [loop|corridor_64k|long|yaml_clover|p2plane|grid|corridor_64k_lag2|loop_lag2|loop_stream4|pgo_1k|pgo_16k] [--trace DIR] [--fused-single]

Runs the replay (or one ``optimize_pose_graph`` of the pose-graph problem
under ``solver="pcg_pallas"`` and the default ``PGOConfig``: the LM loop
with K4) once to build and warm everything, then again under
``torch.profiler`` (CPU and CUDA activities). A classic replay is
synchronized after every scan; a deferred or streaming one
(``replays.VARIANTS``, e.g. BASELINE config 4's ``corridor_64k_lag2``)
only once after its flush, since a synchronize per scan would undo what
deferral buys. Prints the card, the wall time per unit (scan, or LM iteration;
the profiler's own host overhead included), the device's busy time and
idle share over the run, the device-side events (kernels, copies) per
unit, and the device time by kernel, with the port's own kernels (K1-K4)
marked. ``--trace`` also writes a Chrome trace into DIR (tens of MB per
replay). ``--fused-single`` turns the single-scan K2 route on
(``localizer.FUSED_SINGLE``, as ``PGSLAM_FUSED_SINGLE=1`` does).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

OWN_KERNELS = {"knn_kernel": "K1", "icp_fused_kernel": "K2",
               "lm_kernel": "K3", "pcg_kernel": "K4"}


def _kernel_label(name: str) -> str:
    for key, label in OWN_KERNELS.items():
        if key in name:
            return label
    return "torch"


def profile(name: str, trace_dir=None, fused_single: bool = False) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from . import localizer
    dev = torch.device("cuda", 0)
    saved, localizer.FUSED_SINGLE = localizer.FUSED_SINGLE, (
        fused_single or localizer.FUSED_SINGLE)
    try:
        _drive(name, dev)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            unit, n, extra = _drive(name, dev)
            wall = time.perf_counter() - t0
    finally:
        localizer.FUSED_SINGLE = saved
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
    return {"run": name, "fused_single": localizer.FUSED_SINGLE
            or fused_single, "unit": unit, "units": n,
            "wall_ms_per_unit": 1e3 * wall / n,
            "device_busy_ms_per_unit": busy_ms / n,
            "device_idle_share": 1.0 - busy_ms / (1e3 * wall),
            "device_events_per_unit": events / n,
            "device_ms_per_unit_by_kernel_group":
                {k: v / n for k, v in by_label.items()},
            "top_kernels": [{"name": k[:90], "calls": c, "ms": ms,
                             "group": _kernel_label(k)}
                            for k, c, ms in rows[:15]], **extra}


def _drive(name: str, dev):
    """Run a replay, or one optimize of a pose-graph problem; returns
    (unit, number of units, extra stats)."""
    from . import replays
    if name in replays.REPLAYS or name in replays.VARIANTS:
        per_scan, _, stats = replays.run_replay(
            name, device=dev, sync=torch.cuda.synchronize,
            sync_every_scan=name in replays.REPLAYS)
        return "scan", len(per_scan), {"keyframes": stats["n_keyframes"],
                                       "loops": stats["n_loops"]}
    from .optim.pgo import PGOConfig, optimize_pose_graph
    from .pgo_problems import named_problem
    args, _ = named_problem(name, device=dev)
    _, stats = optimize_pose_graph(*args,
                                   config=PGOConfig(solver="pcg_pallas"))
    torch.cuda.synchronize()
    return "LM iteration", int(stats["iterations"]), {
        "cg_steps": int(stats["cg_steps"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("replays", nargs="*", default=["corridor_64k", "loop"])
    ap.add_argument("--trace", default=None)
    ap.add_argument("--fused-single", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_replay needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for name in args.replays:
        print(json.dumps(profile(name, args.trace, args.fused_single),
                         indent=1), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
