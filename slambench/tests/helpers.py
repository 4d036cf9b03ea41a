"""A shrunken copy of the benchmark in a temporary checkout, for runs on
the CPU: the same harness files, configurations and mixes with fewer
agents, points and steps."""

from __future__ import annotations

import contextlib
import json
import os
import shutil

FUSED_SWITCH = "PGSLAM_FUSED_BATCHED"
HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)

# Fewer agents, steps and sampled registrations; the limits are the
# configurations' own.
CFG = {
    "fleet16": {"agents": 4, "warmup_steps": 2,
                "check": {"registrations": 4}},
    "velodyne64": {"warmup_steps": 1, "check": {"registrations": 4}},
}
APART_CELL = {"name": "fleet16.apart", "config": "fleet16",
              "traffic": "apart", "chips": 1,
              "why": "the fleet's scans on separate sites"}
VELO_SLAM = {"sensor_cloud_capacity": 2048,
             "localizer": {"keyframe_cloud_capacity": 2048}}
MIX = {
    "shared": {"steps": 10, "sequence": {"n_scans": 14}},
    "apart": {"steps": 5, "sequence": {"n_scans": 8}},
    "corridor": {"steps": 4, "sequence": {"n_scans": 4, "scan_points": 2048},
                 "world": {"n_points": 40000}},
}


def _merge(d, over):
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            _merge(d[k], v)
        else:
            d[k] = v


def tiny_checkout(tmp: str) -> dict:
    """Copy ``slambench/`` into ``tmp`` with the shrunken configurations
    and mixes; returns the benchmark's ``BENCHMARK.json`` with the apart
    cell."""
    shutil.copytree(BENCH_DIR, os.path.join(tmp, "slambench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    # The apart mix is tested on the CPU whether or not a cell of
    # BENCHMARK.json runs it.
    if APART_CELL["name"] not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append(APART_CELL)
    for c in bench["configs"]:
        path = os.path.join(tmp, c["file"])
        with open(path) as fh:
            cfg = json.load(fh)
        _merge(cfg, CFG.get(c["name"], {}))
        if c["name"] == "velodyne64":
            _merge(cfg["slam"], VELO_SLAM)
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    for name, over in MIX.items():
        path = os.path.join(tmp, "slambench", "mixes", name + ".json")
        with open(path) as fh:
            mix = json.load(fh)
        _merge(mix, over)
        with open(path, "w") as fh:
            json.dump(mix, fh)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return bench


@contextlib.contextmanager
def card_routes():
    """The routes the card takes by default, on the CPU: the batched
    registrations and verifications through K2's plain version (on the
    card "auto" sends them to K2 itself)."""
    old = os.environ.get(FUSED_SWITCH)
    os.environ[FUSED_SWITCH] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ[FUSED_SWITCH]
        else:
            os.environ[FUSED_SWITCH] = old


def run_tiny(tmp: str, bench: dict, workload: str, seed: int = 7,
             seconds: float = 1.5, trace: bool = False):
    """One run of a shrunken cell on the CPU, on the card's routes."""
    import time

    from slambench import run as R
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}[workload]
    with card_routes():
        return R.run_cell(bench, workload, seed, seconds, trace,
                          devices=["cpu"] * chips, root=tmp,
                          t_start=time.perf_counter())
