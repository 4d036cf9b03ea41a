"""A configuration, a traffic mix and a per-layer metric added as files of
their own, with entries in BENCHMARK.json, are found by name: no file of
the harness is edited."""

import json
import os

from slambench.tests.helpers import run_tiny, tiny_checkout


def test_new_files_are_picked_up(tmp_path):
    tmp = str(tmp_path)
    bench = tiny_checkout(tmp)
    sb = os.path.join(tmp, "slambench")
    with open(os.path.join(sb, "configs", "fleet16.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="fleet8", agents=2)
    with open(os.path.join(sb, "configs", "fleet8.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(sb, "mixes", "shared.json")) as fh:
        mix = json.load(fh)
    mix["agents"]["stagger"] = 2
    with open(os.path.join(sb, "mixes", "pairs.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(sb, "metrics", "steps_in_window.py"), "w") as fh:
        fh.write('"""Steps the window completed."""\n\n\n'
                 'def read(run):\n    return float(run.steps)\n')
    bench["configs"].append({"name": "fleet8", "source": "a test",
                             "file": "slambench/configs/fleet8.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "fleet8.pairs", "config": "fleet8",
                               "traffic": "pairs", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "facade", "moves": "scans_per_s",
                               "workloads": ["fleet8.pairs"]})
    res, lines, _ = run_tiny(tmp, bench, "fleet8.pairs", seconds=2.0,
                             trace=True)
    assert res["correct"]
    assert res["metrics"]["steps_in_window"]["value"] >= 1
    assert res["attempted"] % 2 == 0
    with open(os.path.join(sb, "configs", "fleet8.json")) as fh:
        limits = json.load(fh)["check"]["limits"]
    assert list(res["checks"]) == list(limits)
    assert list(res)[-1] == "checks" and len(lines) == len(limits)
