#!/usr/bin/env python3
"""Where an optimize's time goes with the resident mirror and with the
classic upload, under ``torch.profiler``: ``chip_smoke.py``'s
``resident_growth`` sequence (16 optimizes of a ring like pgo_1k's
growing from 512 keyframes, K3 on the card) run four times in turns
(classic, mirror, mirror, classic) after a warm-up of each.

    python3 scripts/resident_profile.py      # needs a GPU

Per run: ms per optimize (one synchronize after the writeback, the
profiler on), the device time in all and in K3, the device events, and
the host's kernel launches, copy calls and stream synchronizations.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("resident_profile: needs a GPU")
    dev = torch.device("cuda", 0)
    chip_smoke.phase_device_and_build()
    run = chip_smoke.resident_growth_run(dev)
    run("auto", "time")
    run("off", "time")
    for mode in ("off", "auto", "auto", "off"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            records = run(mode, "time")
        events = prof.key_averages()
        device = [e for e in events if e.self_device_time_total > 0]
        host = {e.key: e.count for e in events}
        chip_smoke.line(
            "resident_profile", path="mirror" if mode == "auto" else
            "classic", optimizes=len(records),
            ms_per_optimize=round(sum(r["ms"] for r in records)
                                  / len(records), 3),
            device_ms=round(sum(e.self_device_time_total
                                for e in device) / 1e3, 3),
            k3_device_ms=round(sum(e.self_device_time_total for e in device
                                   if "lm_kernel" in e.key) / 1e3, 3),
            device_events=sum(e.count for e in device),
            kernel_launches=host.get("cudaLaunchKernel", 0),
            memcpy_calls=host.get("cudaMemcpyAsync", 0),
            stream_synchronizes=host.get("cudaStreamSynchronize", 0))


if __name__ == "__main__":
    main()
