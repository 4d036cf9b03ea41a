"""Time point-to-point ``icp_core`` and the loop replays that run it.

Two readings, each scan or call synchronized:

* ``icp_core``: ``replays.loop_config``'s point-to-point ICP (the
  replays' front end and loop closer) at 512 x 1536, a reading of a
  wavy surface against that surface from four initial transforms; ms a
  call over ``--calls`` calls, ``--reps`` times;
* ``replay_<name>``: ``replays.run_replay(name)`` with
  ``torch.cuda.synchronize`` after every scan (as ``chip_smoke.py``'s
  replays), ms a scan (the mean of ``stats["scan_seconds"]``), ``--reps``
  times, with its keyframe and loop-edge counts and last pose.

The package timed is the one first on the path::

    PYTHONPATH=<tree> python scripts/time_icp_core.py [--reps 5]

``--against <other tree>`` also loads that tree's package in the same
process and times the two in turns (ABBA: ``--calls`` calls of
``icp_core`` or one replay a turn, ``--reps`` rounds), so that a slow
stretch of a shared host falls on both. It prints one JSON line a
reading.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

import pgslam_tpu_torch


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _load_package(tree: str, name: str):
    """``<tree>/pgslam_tpu_torch`` imported as the package ``name``."""
    path = os.path.join(os.path.abspath(tree), "pgslam_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    for sub in ("replays", "se3", "cloud", "ops.icp"):
        importlib.import_module(f"{name}.{sub}")
    return pkg


def icp_core_case(pkg, dev):
    """A closure running call i of the case through ``pkg``'s
    ``icp_core``, and the iterations of its four starts."""
    icp, cfg = pkg.ops.icp, pkg.replays.loop_config().localizer.icp
    rng = np.random.default_rng(0)
    u = rng.uniform(-3.0, 3.0, (1536, 2))
    ref = np.stack([u[:, 0], u[:, 1], 0.4 * np.sin(1.3 * u[:, 0])],
                   1).astype(np.float32)
    reading = (ref[:512] + rng.normal(0.0, 0.002, (512, 3))).astype(
        np.float32)
    engine = icp.ICPEngine(cfg)
    engine.set_map(pkg.cloud.make_cloud(ref, device=dev))
    r = engine.prepare_reading(pkg.cloud.make_cloud(reading, device=dev))
    T0s = [pkg.se3.exp(torch.tensor(t, dtype=torch.float32)).to(dev)
           for t in rng.normal(0.0, 0.03, (4, 6))]

    def call(i):
        return icp.icp_core(r, engine.reference, T0s[i % 4], cfg,
                            engine.index)
    iterations = [int(call(i).iterations) for i in range(4)]
    _sync(dev)
    return call, iterations


def time_icp_core(dev, pkgs: dict, reps: int, calls: int) -> dict:
    cases = {name: icp_core_case(pkg, dev) for name, pkg in pkgs.items()}
    names = list(cases)
    ms = {name: [] for name in names}
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            call = cases[name][0]
            t = time.perf_counter()
            for i in range(calls):
                call(i)
                _sync(dev)
            ms[name].append(1e3 * (time.perf_counter() - t) / calls)
    return dict(reading="icp_core", shape="512x1536", **{
        name: dict(iterations=cases[name][1], ms_per_call=ms[name],
                   median=float(np.median(ms[name]))) for name in names})


def time_replay(dev, pkgs: dict, name: str, reps: int) -> dict:
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else None
    names = list(pkgs)
    ms, counts = {n: [] for n in names}, {}
    for rep in range(reps):
        for n in (names if rep % 2 == 0 else names[::-1]):
            per_scan, _, stats = pkgs[n].replays.run_replay(
                name, device=dev, sync=sync)
            ms[n].append(1e3 * float(np.mean(stats["scan_seconds"])))
            counts[n] = dict(
                scans=len(per_scan), keyframes=stats["n_keyframes"],
                loop_edges=stats["n_loops"],
                last_position=[float(x) for x in per_scan[-1, :3, 3]])
    return dict(reading=f"replay_{name}", **{
        n: dict(ms_per_scan=ms[n], median=float(np.median(ms[n])),
                **counts[n]) for n in names})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--replays", default="loop,long",
                    help="comma-separated replay names ('' for none)")
    ap.add_argument("--against", default=None,
                    help="a tree whose package is timed in turns with "
                         "this one's")
    args = ap.parse_args()
    dev = torch.device(args.device)
    for sub in ("replays", "ops.icp"):
        importlib.import_module(f"pgslam_tpu_torch.{sub}")
    pkgs = {"this": pgslam_tpu_torch}
    if args.against:
        pkgs["against"] = _load_package(args.against, "pgslam_against")
    print(json.dumps(dict(device=str(dev), **{
        name: os.path.dirname(pkg.__file__) for name, pkg in pkgs.items()})),
        flush=True)
    print(json.dumps(time_icp_core(dev, pkgs, args.reps, args.calls)),
          flush=True)
    for name in filter(None, args.replays.split(",")):
        print(json.dumps(time_replay(dev, pkgs, name, args.reps)),
              flush=True)


if __name__ == "__main__":
    main()
