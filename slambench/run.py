#!/usr/bin/env python3
"""Run one cell of the benchmark of ``pgslam_tpu_torch`` once.

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``: a configuration
(``slambench/configs/<config>.json``, whose ``entry`` names the driver
``slambench/drivers/<entry>.py``) under a traffic mix
(``slambench/mixes/<traffic>.json``). Set-up renders the mix from the
seed, builds the program's kernels (into ``pgslam_tpu_torch/_build/``
inside the checkout, a fixed path; later runs load them) and runs one
warm-up session; then sessions run back to back, each on a fresh SLAM
object, for ``--seconds``; then the sampled outputs are checked against
the plain reference. With ``--trace 0`` the last line of standard output is the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(each read by ``slambench/metrics/<metric>.py``), as one JSON object;
the numbers compared and their limits are the last lines of standard
error and the last key of that object. Exits non-zero, printing no
result, without enough CUDA devices, or if JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "pgslam_tpu")
STRETCH_S = 3.0      # the profiled part of a traced window, at most


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def resolve(bench: dict, workload: str, root: str = ROOT):
    """(cell, configuration entry, configuration, mix) of a workload."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(root, entry["file"]))
    mix = load_json(os.path.join(root, "slambench", "mixes",
                                 cell["traffic"] + ".json"))
    return cell, entry, cfg, mix


def load_part(root: str, kind: str, name: str):
    """``slambench/<kind>/<name>.py`` of the checkout at ``root``, as a
    module (a metric reader or a driver)."""
    path = os.path.join(root, "slambench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"slambench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: dict, trace: bool):
    """The metrics a run of ``cell`` reports."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Run:
    """What the metric readers read (``slambench/metrics``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(bench, workload, seed, seconds, trace, devices=None,
             t_start=None, root=ROOT, stretch_s=STRETCH_S, control=False):
    """One run of a cell; returns (result dict, the compared numbers'
    lines, the check's other readings). The devices default to the first
    ``chips`` CUDA devices. ``control`` also reads the control (the TF32
    reference in the program's place) into the readings."""
    import torch

    from slambench.core import checks, slamconfig, spans as S, traffic
    from slambench.core import tally as TL
    from slambench.core import trace as TR

    t_start = T_START if t_start is None else t_start
    cell, _, cfg, mix = resolve(bench, workload, root)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    devices = [torch.device(d) for d in devices]
    on_card = devices[0].type == "cuda"
    if on_card:
        torch.cuda.set_device(devices[0])

    t_render = time.perf_counter()
    session = traffic.make_session(mix, int(cfg["agents"]), seed,
                                   device=devices[0])
    slam_config = slamconfig.build(cfg)
    t_warm = time.perf_counter()
    Driver = load_part(root, "drivers", cfg["entry"]).Driver
    spans = S.Spans(devices) if trace else None

    # Set-up: build the kernels and warm up on one session of the mix.
    warm = Driver(cfg, slam_config, session, devices)
    warm.open()
    for i in range(min(session.steps, int(cfg["warmup_steps"]))):
        warm.step(i)
    warm.close()
    del warm
    gc.collect()
    if on_card:
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    from pgslam_tpu_torch.ops import knn as K1
    k1 = TL.K1Tally() if trace else None
    if k1 is not None:
        k1.install()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    setup_parts = {"start_s": t_render - t_start,
                   "render_s": t_warm - t_render,
                   "warmup_s": t_window - t_warm}

    # The window (a traced run starts its profiler just before it).
    driver = Driver(cfg, slam_config, session, devices, spans=spans)
    records, lat, steps_timed = [], [], 0
    prof, prof_done, shapes0, shapes1 = None, None, None, None
    launches = [0, 0]
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        with torch.profiler.record_function(TR.MARK):
            shapes0 = dict(k1.shapes)
            launches[0] = K1.knn.launches
    t0 = time.perf_counter()
    end = t0 + seconds
    stretch_end = t0 + min(stretch_s, seconds / 3.0)
    t_last = t0
    while t_last < end:
        records.append(driver.open())
        for i in range(session.steps):
            ts = time.perf_counter()
            if spans is None:
                driver.step(i)
            else:
                with spans.span("step"):
                    driver.step(i)
            t_last = time.perf_counter()
            lat.append(t_last - ts)
            if prof is not None and t_last >= stretch_end:
                driver.sync()
                shapes1 = dict(k1.shapes)
                launches[1] = K1.knn.launches
                prof.__exit__(None, None, None)
                prof_done, prof = prof, None
                spans.timed = True
            elif trace and prof is None:
                steps_timed += 1
            if t_last >= end:
                break
        driver.close()
    window_s = t_last - t0
    n_steps = len(lat)

    mem = max((torch.cuda.max_memory_allocated(d) for d in devices),
              default=0) if on_card else 0
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        raise SystemExit(3)

    tr = None
    if trace:
        dev_ix = sorted({d.index or 0 for d in devices}) if on_card else [0]
        tr = TR.reduce(prof_done, dev_ix, spans.names)
        del prof_done
        tr["k1_shapes"] = {k: shapes1.get(k, 0) - shapes0.get(k, 0)
                           for k in shapes1}
        k1_wrapped = k1.modules()
        k1.remove()

    record_ms = 1e3 * driver.record_s / max(n_steps, 1)
    del driver
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    limits = cfg["check"]["limits"]
    values = checks.readings(cfg, session, records, seed, devices[0])
    correct = checks.verdict(values, limits)

    run = Run(setup_s=setup_s, window_s=window_s, steps=n_steps,
              scans=n_steps * int(cfg["agents"]), latencies_s=lat,
              steps_timed=steps_timed, spans=spans, trace=tr)
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        v = load_part(root, "metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else devices[0].type,
              "kind": torch.cuda.get_device_name(devices[0]) if on_card
              else devices[0].type,
              "count": len(devices), "memory_peak_bytes": int(mem),
              "power_limit_w": power_limit() if on_card else None}
    result = {"correct": bool(correct), "attempted": run.scans, "failed": 0,
              "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = sum(tr["busy_s"].values()) / len(tr["busy_s"])
        device["window_s"] = tr["window_s"]
        result["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in tr["by_name"].items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v
                                 in tr["idle_by_span"].items()),
                                key=lambda x: -x[1])[:10]}
    result["checks"] = checks.checks_json(values, limits)
    info = {k: v for k, v in values.items() if k not in limits}
    info["setup_parts"] = setup_parts
    # The harness's own copies for the check, inside the timed steps.
    info["record_ms_per_step"] = record_ms
    if trace:
        info["k1_launches"] = {"harness": sum(tr["k1_shapes"].values()),
                               "program": launches[1] - launches[0],
                               "wrapped_in": k1_wrapped}
    if control:
        info["control"] = checks.readings(cfg, session, records, seed,
                                          devices[0], control=True)
    return result, checks.lines(values, limits), info


def main(argv=None, root: str = ROOT, devices=None) -> int:
    """A run from the command line; ``devices`` (for tests) skips the
    look for CUDA devices and runs on those."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = resolve(bench, args.workload, root)[0]
    if devices is None:
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"this machine has {have}", file=sys.stderr)
            return 2
    result, lines, info = run_cell(bench, args.workload, args.seed,
                                   args.seconds, bool(args.trace),
                                   devices=devices, root=root)
    print(json.dumps(info), file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    # Again after the reference, the metric readers and everything else
    # the run loaded: nothing prints a result with JAX in the process.
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
