"""The single-scan K2 route (``PGSLAM_FUSED_SINGLE``): its gate, and the
route held to the JAX package's ``fused_icp_register`` (the Pallas
kernel in interpret mode on the CPU) registration by registration on the
golden loop, and the whole replay with the route forced on the CPU.

The reference never takes the route on its CPU backend, and its kernel's
interpret mode is keyed on that same backend, so its replay with the
route cannot run here; each of the port's route-on registrations is run
through the JAX kernel on the same inputs instead. The tests force the
route with the module attributes ``FUSED_SINGLE`` and
``FUSED_SINGLE_DEVICES``, so that K2's plain version runs it."""

import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_replay import golden_config
from pgslam_tpu.cloud import Cloud as JCloud
from pgslam_tpu.ops.icp_pallas import fused_icp_register as j_fused
from pgslam_tpu_torch import localizer as L
from pgslam_tpu_torch import replays
from pgslam_tpu_torch.cloud import make_cloud
from pgslam_tpu_torch.ops import icp_fused
from pgslam_tpu_torch.ops import outlier as O
from pgslam_tpu_torch.ops.icp import ICPConfig
from pgslam_tpu_torch.slam import PoseGraphSlam
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Per registration, the route against the JAX kernel (the fleet's
# tests/test_torch_fleet_fused_reference.py holds the batched route so).
T_TOL_M = 1e-4
R_TOL_RAD = 1e-4
# The whole replay with the route on, gap to golden_replay.npz: the limit
# PERF.md (section 6) derives before the first card run from the
# reference's own fused route (0.10389 m), the route on the CPU (0.04999
# m) and 16 CPU runs with the odometry moved by 1e-6 m (up to 0.12967 m):
# 1.5 times the largest, rounded up.
ROUTE_REPLAY_TOL_M = 0.20
# Measured on the CPU (PERF.md, section 6): 62 of the 69
# registrations meet T_TOL_M, R_TOL_RAD and equal iterations; 7 miss them
# by up to 2.21e-3 m, 3.84e-4 rad and 3 iterations. The packages round
# the squared distances that matches and thresholds read differently: at
# scans 8 and 60 the port's own icp_core stands as far (0.71 and 2.0 mm)
# from the JAX kernel, which agrees with the JAX icp_core; at scans 8 and
# 46 K2's averaging over ties of its expanded fp32 distance decides (the
# first minimum meets the limits). The ICP loop carries one point's
# decision to millimetres. The test pins that record; the limits are not
# met for every registration.
MAX_OUTSIDE = 7
OUTSIDE_T_M = 2.5e-3
OUTSIDE_R_RAD = 5e-4
OUTSIDE_ITERATIONS = 3


def _route_on(monkeypatch):
    monkeypatch.setattr(L, "FUSED_SINGLE", True)
    monkeypatch.setattr(L, "FUSED_SINGLE_DEVICES", ("cuda", "cpu"))


@pytest.fixture(scope="module")
def route_run():
    """The golden loop with the route forced on, on the CPU: per-scan
    poses, compositions and loop counts, and each registration's inputs
    and result."""
    mp = pytest.MonkeyPatch()
    _route_on(mp)
    calls = []
    orig = L.register_one

    def recording(reading, ref, T0, cfg):
        res = orig(reading, ref, T0, cfg)
        calls.append({"reading": (reading.points.numpy().copy(),
                                  reading.mask.numpy().copy()),
                      "ref": (ref.points.numpy().copy(),
                              ref.mask.numpy().copy()),
                      "T0": T0.numpy().copy(), "T": res.T.numpy().copy(),
                      "iterations": int(res.iterations),
                      "converged": bool(res.converged)})
        return res

    mp.setattr(L, "register_one", recording)
    try:
        scans, odom, _ = replays.loop_sequence_golden()
        slam = PoseGraphSlam(replays.loop_config(), device="cpu")
        T_rs = np.eye(4, dtype=np.float32)
        per_scan, comps, loops, scan_of_call = [], [], [], []
        for i, (scan, T) in enumerate(zip(scans, odom)):
            n = len(calls)
            slam.add_data(i, "world", T, T_rs, scan)
            scan_of_call += [i] * (len(calls) - n)
            per_scan.append(slam.localizer.T_world_robot.copy())
            comps.append(tuple(
                slam.localizer.local_map.get_composition().as_list()))
            loops.append(slam.n_loop_edges())
    finally:
        mp.undo()
    return {"per_scan": np.stack(per_scan), "comps": comps, "loops": loops,
            "calls": calls, "scan_of_call": scan_of_call,
            "n_keyframes": slam.get_graph().n_vertices}


def _gaps(T_ref, T):
    """(translation m, rotation rad) between two poses; the angle from
    the skew part, since arccos of the trace reads the fp32 rounding of a
    near-identity rotation as ~1e-4 rad."""
    dT = np.linalg.inv(np.asarray(T_ref, np.float64)) @ np.asarray(
        T, np.float64)
    R = dT[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return (np.linalg.norm(dT[:3, 3]),
            np.arctan2(np.linalg.norm(w) / 2, (np.trace(R) - 1) / 2))


def test_route_matches_jax_kernel_per_registration(route_run):
    """Every registration of the route-on replay (the first after the
    first keyframe swap, where the window drops its oldest keyframe, and
    those after the closure among them) against the JAX kernel on the
    same inputs. At most MAX_OUTSIDE of them may miss the T, iterations
    and converged limits, and those only within the OUTSIDE_* bounds."""
    calls, of = route_run["calls"], route_run["scan_of_call"]
    assert len(calls) == len(route_run["per_scan"]) - 1  # scan 0 bootstraps
    comps = route_run["comps"]
    swap = next(i for i in range(1, len(comps))
                if set(comps[i - 1]) - set(comps[i]))
    closure = route_run["loops"].index(1)
    assert swap + 1 in of and closure + 1 in of and closure > swap
    jcfg = golden_config().localizer.icp
    lift = lambda a: jnp.asarray(a)[None]
    outside = {}
    for c, rec in enumerate(calls):
        jr = j_fused(JCloud(points=lift(rec["reading"][0]),
                            mask=lift(rec["reading"][1])),
                     JCloud(points=lift(rec["ref"][0]),
                            mask=lift(rec["ref"][1])),
                     lift(rec["T0"]), jcfg)
        dt, dr = _gaps(np.asarray(jr.T[0]), rec["T"])
        dit = abs(rec["iterations"] - int(jr.iterations[0]))
        assert rec["converged"] == bool(jr.converged[0]), of[c]
        if dt > T_TOL_M or dr > R_TOL_RAD or dit:
            outside[of[c]] = (float(dt), float(dr), dit)
            assert dt <= OUTSIDE_T_M and dr <= OUTSIDE_R_RAD \
                and dit <= OUTSIDE_ITERATIONS, (of[c], dt, dr, dit)
    print(f"route against the JAX kernel: {len(calls) - len(outside)} of "
          f"{len(calls)} registrations within {T_TOL_M} m, {R_TOL_RAD} rad "
          f"and equal iterations; outside, by scan (m, rad, iterations): "
          f"{outside}")
    assert len(outside) <= MAX_OUTSIDE, outside


def test_route_replay_in_its_envelope(route_run):
    gold = replays.fixture("loop")
    gaps = replays.per_scan_gaps(route_run["per_scan"],
                                 gold["per_scan_poses"])
    print(f"route-on loop replay on the CPU: gap to golden_replay.npz "
          f"{gaps.max():.5f} m (scan {int(gaps.argmax())}), "
          f"{route_run['n_keyframes']} keyframes, "
          f"{route_run['loops'][-1]} loop")
    assert np.isfinite(route_run["per_scan"]).all()
    assert gaps.max() < ROUTE_REPLAY_TOL_M
    assert route_run["n_keyframes"] == 20
    assert route_run["loops"][-1] == int(gold["n_loop_edges"]) == 1


_P2POINT = ICPConfig(error="point_to_point",
                     outlier=(O.TrimmedDist(0.85), O.MaxDist(0.5)))
_P2PLANE = ICPConfig(error="point_to_plane",
                     outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)))
_INELIGIBLE = ICPConfig(error="point_to_point", matcher="grid")


@pytest.mark.parametrize("switch,device,kind,normals", list(
    itertools.product((False, True), ("cpu", "cuda"),
                      ("p2point", "p2plane", "ineligible"), (False, True))))
def test_gate(monkeypatch, switch, device, kind, normals):
    """On only with the switch, on the card, for a config K2 covers, with
    normals on a point-to-plane reference; the CPU never takes it by
    default."""
    monkeypatch.setattr(L, "FUSED_SINGLE", switch)
    cfg = {"p2point": _P2POINT, "p2plane": _P2PLANE,
           "ineligible": _INELIGIBLE}[kind]
    pts = np.zeros((4, 3), np.float32)
    ref = make_cloud(pts, descriptors={"normals": pts} if normals else None)
    want = switch and device == "cuda" and (
        kind == "p2point" or (kind == "p2plane" and normals))
    assert L.single_route(cfg, ref, torch.device(device)) == want


@pytest.mark.parametrize("env,want", [(None, False), ("0", False),
                                      ("1", True), ("yes", False)])
def test_switch_is_read_at_import(env, want):
    code = ("import pgslam_tpu_torch.localizer as L; "
            "print(L.FUSED_SINGLE, L.FUSED_SINGLE_DEVICES)")
    envs = {k: v for k, v in os.environ.items()
            if k != "PGSLAM_FUSED_SINGLE"}
    if env is not None:
        envs["PGSLAM_FUSED_SINGLE"] = env
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=envs,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(want), "('cuda',)"]


def test_route_has_no_fallback(monkeypatch):
    """A K2 that fails fails the scan; icp_core does not take over."""
    _route_on(monkeypatch)

    def broken(*a, **k):
        raise RuntimeError("K2 failed")

    monkeypatch.setattr(icp_fused, "fused_icp_register_plain", broken)
    scans, odom, _ = replays.loop_sequence_golden()
    slam = PoseGraphSlam(replays.loop_config(), device="cpu")
    T_rs = np.eye(4, dtype=np.float32)
    slam.add_data(0, "world", odom[0], T_rs, scans[0])
    with pytest.raises(RuntimeError, match="K2 failed"):
        slam.add_data(1, "world", odom[1], T_rs, scans[1])


def test_route_off_by_default_runs_icp_core(monkeypatch):
    """With the switch as it is by default, a CPU replay never reaches
    K2's single route."""
    monkeypatch.setattr(L, "FUSED_SINGLE_DEVICES", ("cuda", "cpu"))
    assert L.FUSED_SINGLE == (os.environ.get("PGSLAM_FUSED_SINGLE") == "1")
    monkeypatch.setattr(L, "FUSED_SINGLE", False)

    def broken(*a, **k):
        raise AssertionError("the single route ran")

    monkeypatch.setattr(L, "register_one", broken)
    scans, odom, _ = replays.loop_sequence_golden()
    slam = PoseGraphSlam(replays.loop_config(), device="cpu")
    T_rs = np.eye(4, dtype=np.float32)
    for i in range(3):
        slam.add_data(i, "world", odom[i], T_rs, scans[i])
    assert jax.default_backend() == "cpu"
