"""BENCHMARK.json and the harness's data files: every configuration, mix
and metric file parses and is found by name, and every name and unit
keeps to the characters the benchmark's format allows."""

import json
import os
import re

import pytest

from slambench.tests.helpers import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["slambench"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    for word in b["command"]:
        assert TEXT.match(word) and not word.startswith("/") \
            and ".." not in word


def test_configs_parse_and_are_used():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("slambench/configs/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(
            BENCH_DIR, "drivers", cfg["entry"] + ".py"))
        assert c["name"] in used


@pytest.mark.parametrize("kind", ["workloads", "end_to_end", "per_layer"])
def test_entries(kind):
    b = bench()
    names = [e["name"] for e in b[kind]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in b["workloads"]}
    for e in b[kind]:
        assert NAME.match(e["name"])
        if kind == "workloads":
            assert set(e) == {"name", "config", "traffic", "chips", "why"}
            assert e["chips"] in (1, 4) and TEXT.match(e["why"])
            assert os.path.exists(os.path.join(
                BENCH_DIR, "mixes", e["traffic"] + ".json"))
            continue
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert set(e.get("workloads", [])) <= cells
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           e["name"] + ".py"))
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        else:
            assert TEXT.match(e["layer"])
            assert e["moves"] in {m["name"] for m in b["end_to_end"]}


def test_every_cell_reports_enough():
    b = bench()
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4)
    for w in b["workloads"]:
        e2e = [m["name"] for m in b["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in b["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:
            moves = [x for x in b["end_to_end"] if x["name"] == m["moves"]][0]
            assert w["name"] in moves.get("workloads", [w["name"]])


@pytest.mark.parametrize("sub", ["configs", "mixes"])
def test_data_files_parse(sub):
    for f in os.listdir(os.path.join(BENCH_DIR, sub)):
        assert f.endswith(".json") and NAME.match(f[:-5])
        with open(os.path.join(BENCH_DIR, sub, f)) as fh:
            json.load(fh)


def test_file_names():
    for dirpath, _, files in os.walk(BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        rel = os.path.relpath(dirpath, ROOT)
        for f in files:
            assert re.match(r"^[A-Za-z0-9_./-]+$", os.path.join(rel, f))
