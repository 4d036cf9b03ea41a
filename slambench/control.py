#!/usr/bin/env python3
"""Readings behind the correctness limits of a cell: for each seed, one
run of the cell (set-up, a window of ``--seconds``) and, on the same
records, the numbers compared for the program and for the control, the
plain reference computed with TF32 matmuls in the program's place.
Every seed runs in this one process. Not part of a benchmark run.

    python3 slambench/control.py --workload <name> --seeds 1,2,3 --seconds 8
        [--control-seeds 1,2] [--trace-seeds 3] [--fault one_agent]

``--control-seeds`` reads the control on those seeds only (all by
default), ``--trace-seeds`` runs those seeds traced, ``--fault`` plants
a fault of ``slambench/core/faults.py`` in the program for every seed.
Prints one JSON line per seed: ``{"seed", "program", "control", ...}``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run as R  # noqa: E402


def main() -> int:
    import argparse
    import time
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control-seeds", default=None)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    ints = lambda text: [int(s) for s in text.split(",") if s]
    seeds = ints(args.seeds)
    ctl_seeds = set(seeds if args.control_seeds is None
                    else ints(args.control_seeds))
    bench = R.load_json(os.path.join(R.ROOT, "BENCHMARK.json"))
    if args.fault:
        from slambench.core import faults
        cell, _, cfg, _ = R.resolve(bench, args.workload)
        faults.plant(cfg["entry"], args.fault)
    for seed in seeds:
        res, _, info = R.run_cell(bench, args.workload, seed, args.seconds,
                                  seed in ints(args.trace_seeds),
                                  t_start=time.perf_counter(),
                                  control=seed in ctl_seeds)
        program = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": res["correct"], "program": program,
                          "control": info.pop("control", None),
                          "info": info, "metrics": res["metrics"],
                          "device": res["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
