#!/usr/bin/env python3
"""Where the grid replay (``replays.run_replay("grid")``) leaves the JAX
run on the card: each registration's ICP stopping decision and each
loop-closure decision, on the card with K3, on the card with the plain
LM in place of K3, and on the CPU (whose decisions are the JAX run's,
``tests/test_torch_gridknn.py``).

    python3 scripts/grid_replay_stops.py          # on a machine with a GPU
    python3 scripts/grid_replay_stops.py --cpu    # the CPU run only

For every scan whose registration took another number of ICP iterations
than the CPU run's, it prints both counts and the convergence checker's
last three values, the smoothed translation and rotation steps over
``trans_eps`` and ``rot_eps`` (a run stops when both are below 1), and
then the CPU run's stops nearest 1 (its knife edges: the margin is how
far below 1 the larger value was at the stop, or above 1 one iteration
earlier). It also prints each
run's loop-closure candidates and verifications, and each run's per-scan
gap to the CPU run where it first exceeds 1e-4 m. The ICP loop is traced
by wrapping the eager run of ``ops/icp_graph.py::Registration`` (every
registration but point-to-plane on the card, which replays graphs and
is not traced): after each iteration of the last stage it reads the
checker's values; the arithmetic is the loop's.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pgslam_tpu_torch import loopcloser, replays  # noqa: E402
from pgslam_tpu_torch.ops.icp_graph import Registration  # noqa: E402
from pgslam_tpu_torch.optim import lm, pgo  # noqa: E402
from pgslam_tpu_torch.slam import PoseGraphSlam  # noqa: E402

SHOWN = 8


class Trace:
    """ICP stops and loop-closure decisions of one replay, by scan."""

    def __init__(self):
        self.scan = -1
        # scan -> [(iterations, the checker's last values, converged)]
        # per registration (the scan's, then a verification's)
        self.stops = {}
        self.closures = []
        self.values = None    # the running registration's checker

    def body(self, reg, s):
        """``Registration.body``, then the checker's values after an
        iteration of the last stage of a traced run."""
        BODY(reg, s)
        if self.values is not None and s == len(reg.stages) - 1:
            cfg = reg.cfg
            self.values.append((float(reg.dts.mean()) / cfg.trans_eps,
                                float(reg.drs.mean()) / cfg.rot_eps))

    def run(self, reg, index, call, count=True):
        """``Registration.run``; an eager run (not ``static``) is
        traced."""
        self.values = None if reg.static else []
        try:
            RUN(reg, index, call, count=count)
            if not reg.static:
                self.stops.setdefault(self.scan, []).append(
                    (int(reg.iterations), self.values[-3:],
                     bool(reg.done)))
        finally:
            self.values = None


BODY, RUN = Registration.body, Registration.run


def run(device, plain_lm: bool) -> tuple:
    trace = Trace()
    add, find, check = (PoseGraphSlam.add_data,
                        loopcloser.LoopCloser.find_candidate_composition,
                        loopcloser.LoopCloser.check_icp_result)

    def add_data(self, *a, **k):
        trace.scan += 1
        return add(self, *a, **k)

    def find_candidate(self, v):
        comp = find(self, v)
        if comp is not None:
            trace.closures.append(("candidate", trace.scan, v,
                                   tuple(comp.as_list())))
        return comp

    def check_result(self, result, residual=None):
        ok = check(self, result, residual=residual)
        trace.closures.append(("verification", trace.scan,
                               self.input_vertex,
                               round(float(result.overlap), 5),
                               int(result.iterations), ok))
        return ok

    saved = [(PoseGraphSlam, "add_data", add),
             (loopcloser.LoopCloser, "find_candidate_composition", find),
             (loopcloser.LoopCloser, "check_icp_result", check),
             (Registration, "body", BODY), (Registration, "run", RUN),
             (lm, "lm_optimize", lm.lm_optimize)]
    PoseGraphSlam.add_data = add_data
    loopcloser.LoopCloser.find_candidate_composition = find_candidate
    loopcloser.LoopCloser.check_icp_result = check_result
    Registration.body = lambda reg, s: trace.body(reg, s)
    Registration.run = lambda reg, *a, **k: trace.run(reg, *a, **k)
    if plain_lm:
        lm.lm_optimize = lambda *a, config, ptr_host=None: \
            pgo.lm_optimize_plain(*a, config=config)
    try:
        sync = torch.cuda.synchronize if device != "cpu" else None
        per_scan = replays.run_replay("grid", device=device, sync=sync)[0]
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    return per_scan, trace


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="the CPU run only (no GPU needed)")
    args = ap.parse_args()
    runs = [("cpu", "cpu", False)]
    if not args.cpu:
        if not torch.cuda.is_available():
            raise SystemExit("no GPU: pass --cpu for the CPU run")
        print(torch.cuda.get_device_name(0))
        runs += [("card", "cuda", False), ("card_plain_lm", "cuda", True)]
    out = {label: run(dev, plain) for label, dev, plain in runs}
    host_poses, host = out["cpu"]
    for label, (per_scan, trace) in out.items():
        gaps = replays.per_scan_gaps(per_scan, host_poses)
        off = np.flatnonzero(gaps > 1e-4)
        print(f"[{label}] first scan > 1e-4 m from the CPU run: "
              f"{int(off[0]) if len(off) else None}, largest gap "
              f"{gaps.max():.5f} m")
        for c in trace.closures:
            print(f"[{label}] {c}")
        if label == "cpu":
            continue
        differ = [(s, k) for s in sorted(trace.stops)
                  for k, (a, b) in enumerate(zip(trace.stops[s],
                                                 host.stops.get(s, [])))
                  if a[0] != b[0]]
        print(f"[{label}] registrations (scan, k-th of the scan) whose ICP "
              f"iterations differ from the CPU run's: {differ}")
        for s, k in differ[:SHOWN]:
            mine, cpu = trace.stops[s][k], host.stops[s][k]
            print(f"  scan {s}: {mine[0]} iterations, checker "
                  f"{np.round(mine[1], 5).tolist()}; CPU {cpu[0]}, "
                  f"{np.round(cpu[1], 5).tolist()}")
    # A stop's margin: how far below 1 the larger value was when it
    # stopped, or how far above 1 it was one iteration earlier.
    margin = lambda v: min([1 - max(v[-1])]
                           + ([max(v[-2]) - 1] if len(v) > 1 else []))
    nearest = sorted((margin(v), s) for s, regs in host.stops.items()
                     for _, v, converged in regs if converged)[:SHOWN]
    print("[cpu] stops nearest the checker's eps (margin, scan):",
          [(round(m, 5), s) for m, s in nearest])


if __name__ == "__main__":
    main()
