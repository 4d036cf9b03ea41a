"""The port's tracer (``pgslam_tpu_torch.utils.timing``): what a short
``PoseGraphSlam`` and ``MultiAgentSlam`` run record under a torch
profiler, when recordings start and hold, spans on two threads, and the
benchmark's readers of the recording (``slambench/metrics``). The
``gpu`` test holds the wait sites to torch's own count of synchronizing
calls on the card:

    python -m pytest tests/test_torch_tracing.py -m gpu --noconftest
"""

import importlib.util
import os
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pgslam_tpu_torch import PoseGraphSlam
from pgslam_tpu_torch import fleet_problems as FP
from pgslam_tpu_torch.parallel.multi_agent import MultiAgentSlam
from pgslam_tpu_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_RS = np.eye(4, dtype=np.float32)

# Every span the port opens, by the run that reaches it.
SINGLE_SPANS = {"pgslam.slam.step", "pgslam.frontend",
                "pgslam.frontend.filters", "pgslam.frontend.icp",
                "pgslam.localmap.build", "pgslam.loopcloser.vertex"}
FLEET_SPANS = {"pgslam.fleet.step", "pgslam.fleet.prepare",
               "pgslam.fleet.register", "pgslam.fleet.agents",
               "pgslam.fleet.probes", "pgslam.loopcloser.verify",
               "pgslam.optimizer.optimize", "pgslam.localmap.build"}
ALL_SPANS = SINGLE_SPANS | FLEET_SPANS


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return timing.recording()


def _single_run(n_scans=10):
    scans, odom, _ = FP.config5_sequence(24)
    slam = PoseGraphSlam(FP.fleet_config(), device="cpu")

    def feed(lo, hi):
        for i in range(lo, hi):
            slam.add_data(i, "world", odom[i], T_RS, scans[i])
    return slam, feed


def _fleet_run(n_agents=4):
    """A fleet on config 5's corridor, agent b on scan i + b % 3: its
    ninth step verifies and optimizes a closure."""
    scans, odom, _ = FP.config5_sequence(24)
    fleet = MultiAgentSlam(FP.fleet_config(), n_agents=n_agents,
                           device="cpu")

    def feed(lo, hi):
        for i in range(lo, hi):
            ix = [i + b % 3 for b in range(n_agents)]
            fleet.add_data_batch(i, "world", np.stack([odom[j] for j in ix]),
                                 T_RS, [scans[j] for j in ix])
    return fleet, feed


@pytest.fixture(scope="module")
def recordings():
    """(recording, steps fed, scans fed, spans expected) of each run."""
    slam, feed_single = _single_run()
    fleet, feed_fleet = _fleet_run()
    single = _profiled(lambda: feed_single(0, 10))
    fleet_rec = _profiled(lambda: feed_fleet(0, 10))
    assert fleet.optimizer.runs >= 1
    return {"single": (single, 10, 10, SINGLE_SPANS),
            "fleet": (fleet_rec, 10, 40, FLEET_SPANS)}


@pytest.mark.parametrize("run", ["single", "fleet"])
def test_recording_counts_steps_scans_and_every_span(recordings, run):
    rec, steps, scans, expected = recordings[run]
    assert rec.counters["steps"] == steps
    assert rec.counters["scans"] == scans
    assert expected <= set(rec.spans) <= ALL_SPANS
    assert all(n.startswith("pgslam.") for n in rec.spans)
    roots = [r for r in rec.records if r.parent == -1]
    assert len(roots) == steps and {r.step for r in roots} == set(
        range(1, steps + 1))
    assert all(r.name.endswith(".step") for r in roots)
    for name, agg in rec.spans.items():
        assert 0.0 <= agg["self_s"] <= agg["total_s"] + 1e-9, name
        assert 0.0 <= agg["wait_s"] <= agg["total_s"] + 1e-9, name


@pytest.mark.parametrize("run", ["single", "fleet"])
def test_children_fall_inside_their_parent_and_step(recordings, run):
    rec = recordings[run][0]
    by_id = {r.id: r for r in rec.records}
    step_of = {r.step: r for r in rec.records if r.parent == -1}
    for r in rec.records:
        assert r.start_ns <= r.end_ns
        if r.parent == -1:
            continue
        p = by_id[r.parent]
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
        assert r.step == p.step and r.thread == p.thread
        s = step_of[r.step]
        assert s.start_ns <= r.start_ns and r.end_ns <= s.end_ns
        # No map build nests in another: their time adds up once.
        if r.name == "pgslam.localmap.build":
            q = p
            while q.parent != -1:
                assert q.name != r.name
                q = by_id[q.parent]
    # Self time is the total less the spans directly inside.
    kids = {}
    for r in rec.records:
        kids.setdefault(r.parent, []).append(r)
    for name in rec.spans:
        own = [r for r in rec.records if r.name == name]
        total = sum(r.end_ns - r.start_ns for r in own)
        inside = sum(c.end_ns - c.start_ns for r in own
                     for c in kids.get(r.id, []))
        assert rec.spans[name]["self_s"] == pytest.approx(
            (total - inside) * 1e-9, abs=1e-6)


@pytest.mark.parametrize("run", ["single", "fleet"])
def test_waits_add_up_inside_the_steps(recordings, run):
    """Every site is reached inside a step, each span's wait holds its
    nested spans' waits, and a step's host work plus its waits is its
    time."""
    rec = recordings[run][0]
    sites_s = sum(s["wait_s"] for s in rec.sites.values())
    roots = [v for k, v in rec.spans.items() if k.endswith(".step")]
    assert sum(v["wait_s"] for v in roots) == pytest.approx(sites_s,
                                                            rel=1e-6)
    rows = {r.id: r for r in rec.records}
    for r in rec.records:
        if r.parent != -1:
            assert r.wait_ns <= rows[r.parent].wait_ns
    assert sum(s["count"] for s in rec.sites.values()) > 0


@pytest.mark.parametrize("run", ["single", "fleet"])
def test_icp_convergence_site_counts_every_iteration(recordings, run):
    rec = recordings[run][0]
    assert rec.counters["icp.iterations"] > 0
    assert rec.sites["icp.converged"]["count"] == \
        rec.counters["icp.iterations"]


def test_fleet_results_come_up_in_one_packed_fetch(monkeypatch):
    """A fleet's registration batch comes to the host in one fetch a step,
    and a step's batched verification in one more: no per-field copy
    (``icp.to_host``) and no per-entry residual read
    (``loopcloser.residual``)."""
    fleet, feed = _fleet_run()
    fetches = []          # (step, span) of each fetch.event wait
    enter = timing._Wait.__enter__

    def spied(self):
        if self.site == "fetch.event":
            st = timing._stack()
            fetches.append((st[-1].step, {s.name for s in st}))
        return enter(self)

    monkeypatch.setattr(timing._Wait, "__enter__", spied)
    rec = _profiled(lambda: feed(0, 10))
    assert not {"icp.to_host", "loopcloser.residual"} & set(rec.sites)
    for name in ("pgslam.fleet.register", "pgslam.loopcloser.verify"):
        steps = [r.step for r in rec.records if r.name == name]
        per_step = [sum(step == s and name in spans
                        for step, spans in fetches) for s in steps]
        if name == "pgslam.fleet.register":
            assert len(steps) == 9 and per_step == [1] * 9
        else:
            # Every step enters the verification; those with queued
            # candidates fetch their batch once.
            assert set(per_step) == {0, 1}, per_step
    assert fleet.loop_closer.accepted + fleet.loop_closer.rejected >= 1


def test_recording_holds_outside_a_profiler_and_restarts_in_the_next():
    slam, feed = _single_run()
    first = _profiled(lambda: feed(0, 3))
    assert first.counters["steps"] == 3
    feed(3, 5)                       # no profiler: nothing recorded
    held = timing.recording()
    assert dict(held.counters) == dict(first.counters)
    assert held.spans == first.spans and held.sites == first.sites
    second = _profiled(lambda: feed(5, 7))
    assert second.counters["steps"] == 2
    assert {r.step for r in second.records} == {1, 2}
    # Back to back, read in between: a fresh recording each time.
    third = _profiled(lambda: feed(7, 8))
    assert third.counters["steps"] == 1


def test_spans_from_two_threads_nest_on_their_own_thread():
    barrier = threading.Barrier(2, timeout=30)
    done = []

    def worker(tag):
        with timing.span(f"pgslam.test.{tag}"):
            barrier.wait()
            with timing.span(f"pgslam.test.{tag}.inner"):
                barrier.wait()
                with timing.wait(f"test.{tag}"):
                    pass
                barrier.wait()
            barrier.wait()
        done.append(tag)

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    rec = timing.recording()
    assert sorted(done) == ["a", "b"]
    rows = {r.name: r for r in rec.records}
    for tag in ("a", "b"):
        outer, inner = rows[f"pgslam.test.{tag}"], \
            rows[f"pgslam.test.{tag}.inner"]
        assert outer.parent == -1 and inner.parent == outer.id
        assert inner.thread == outer.thread
        assert rec.sites[f"test.{tag}"]["count"] == 1
        assert inner.wait_ns == outer.wait_ns > 0
    assert rows["pgslam.test.a"].thread != rows["pgslam.test.b"].thread


def test_nothing_is_recorded_outside_a_profiler():
    before = timing.recording()
    with timing.span("pgslam.test.off"):
        with timing.wait("test.off"):
            timing.count("steps")
    after = timing.recording()
    assert "pgslam.test.off" not in after.spans
    assert "test.off" not in after.sites
    assert dict(after.counters) == dict(before.counters)


def test_span_names_start_with_the_prefix():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            timing.span("frontend")


# -- the benchmark's readers of the recording ------------------------------

def _reader(name):
    path = os.path.join(ROOT, "slambench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _fake():
    """Four steps of 16 scans with known spans, sites and counters."""
    rec = timing.Recording()
    rec.counters.update({"steps": 4, "scans": 64, "launch.k1": 30,
                         "launch.k2": 6, "launch.k3": 4, "launch.k4": 0,
                         "icp.iterations": 50,
                         "icp.graph.registrations": 6,
                         "icp.eager.registrations": 2,
                         "fleet.prepare.batched": 3,
                         "fleet.prepare.per_agent": 1})
    spans = {"pgslam.fleet.step": (4, 0.100, 0.020),
             "pgslam.slam.step": (0, 0.0, 0.0),
             "pgslam.frontend.icp": (8, 0.032, 0.004),
             "pgslam.frontend.filters": (8, 0.016, 0.0),
             "pgslam.localmap.build": (10, 0.008, 0.001),
             "pgslam.fleet.prepare": (4, 0.012, 0.002),
             "pgslam.fleet.agents": (8, 0.020, 0.0),
             "pgslam.fleet.probes": (4, 0.028, 0.004)}
    for name, (calls, total, wait) in spans.items():
        if calls:
            rec.spans[name] = {"calls": calls, "total_s": total,
                               "self_s": total, "wait_s": wait}
    rec.sites = {"icp.converged": {"count": 50, "wait_s": 0.01},
                 "fetch.event": {"count": 10, "wait_s": 0.01}}
    return rec


READINGS = {"host_syncs_per_step": 60 / 4,
            "host_work_ms_per_step": 1e3 * (0.100 - 0.020) / 4,
            "kernel_launches_per_step": 40 / 4,
            "frontend_icp_ms_per_scan": 32.0 / 64,
            "frontend_filters_ms_per_scan": 16.0 / 64,
            "localmap_build_ms_per_step": 8.0 / 4,
            "fleet_prepare_ms_per_step": 12.0 / 4,
            "fleet_agents_ms_per_step": 20.0 / 4,
            "probes_ms_per_step": 28.0 / 4,
            "icp_graph_share": 6 / 8,
            "fleet_prepare_batched_share": 3 / 4}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_metric_reader_on_a_fake_recording(name):
    assert _reader(name)(None, _fake()) == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_metric_reader_reads_nothing_in_an_empty_recording(name):
    assert _reader(name)(None, timing.Recording()) is None


def test_metric_readers_are_the_benchmarks_new_entries():
    import json
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        per_layer = {m["name"]: m for m in json.load(fh)["per_layer"]}
    for name in READINGS:
        assert per_layer[name]["source"] in ("program_span",
                                             "program_counter")


# -- on the card ------------------------------------------------------------

# Sites whose wait torch's sync debug mode does not report: an event's
# synchronize.
UNSEEN = {"fetch.event"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["velodyne64.corridor", "fleet16.shared"])
def test_wait_sites_are_every_sync_torch_reports(cell):
    """A few steps of the cell's entry point at its configuration, under
    ``torch.cuda.set_sync_debug_mode("warn")``: torch's count of
    synchronizing calls equals the program's wait sites (less the event
    waits torch does not see), and every one falls inside a wait. A fleet
    step's input preparation holds at most 4 sites and takes the batched
    route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the syncs counted are the card's")
    from slambench import run as R
    from slambench.core import slamconfig, traffic
    bench = R.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, _, cfg, mix = R.resolve(bench, cell, ROOT)
    n = int(cfg["agents"])
    session = traffic.make_session(mix, n, 2900000017)
    config = slamconfig.build(cfg)
    if n == 1:
        slam = PoseGraphSlam(config, device="cuda")

        def step(i):
            slam.add_data(i, "world", session.odom[i, 0], T_RS,
                          session.scans[session.index[i, 0]])
    else:
        slam = MultiAgentSlam(config, n, device="cuda")

        def step(i):
            slam.add_data_batch(i, "world", session.odom[i], T_RS,
                                session.step_clouds(i))
    warm, steps = (4, 8) if n == 1 else (12, 12)
    for i in range(warm):
        step(i)
    torch.cuda.synchronize()
    outside = []
    inside = [0]
    in_prepare = [0]
    enter, leave = timing._Wait.__enter__, timing._Wait.__exit__
    depth = threading.local()

    def counted_enter(self):
        depth.n = getattr(depth, "n", 0) + 1
        if any(s.name == "pgslam.fleet.prepare" for s in timing._stack()):
            in_prepare[0] += 1
        return enter(self)

    def counted_exit(self, *exc):
        depth.n -= 1
        return leave(self, *exc)

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        if getattr(depth, "n", 0):
            inside[0] += 1
        else:
            outside.append(f"{os.path.relpath(filename, ROOT)}:{lineno}")

    with profile(activities=[ProfilerActivity.CPU]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            timing._Wait.__enter__ = counted_enter
            timing._Wait.__exit__ = counted_exit
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for i in range(warm, warm + steps):
                    step(i)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                timing._Wait.__enter__, timing._Wait.__exit__ = enter, leave
        torch.cuda.synchronize()
    rec = timing.recording()
    assert rec.counters["steps"] == steps
    seen = sum(v["count"] for k, v in rec.sites.items() if k not in UNSEEN)
    assert not outside, f"syncs outside any wait site: {sorted(set(outside))}"
    assert inside[0] == seen, {k: v["count"] for k, v in rec.sites.items()}
    # The outlier thresholds read nothing on the host, and the front
    # end's ICP runs as graph replays: no host read inside its loop.
    assert not {"outlier.upload", "outlier.threshold"} & set(rec.sites)
    if n > 1:
        # The fleet's scans and transforms go up as one batch a step.
        assert in_prepare[0] <= 4 * steps, in_prepare[0]
        assert rec.counters["fleet.prepare.batched"] == steps
    if n == 1:
        assert rec.counters["icp.graph.registrations"] == steps
        assert not {"icp.converged", "icp.upload", "minimizer.solve",
                    "minimizer.inv"} & set(rec.sites)
