#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pgslam_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, one line each (the script raises and exits non-zero on the first
failure, and prints the final JSON line only when every phase passed):

1. device and build: the card from ``nvidia-smi``, then the hand-written
   kernels built from ``pgslam_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the main path (K1: 2048x8192 k=1, 8192x8192 k=8,
   65536x65536 k=1; K2: the 64k profile's loop-closure verification,
   2048 vs 8192 points, point-to-plane, coarse_div 8, every output of the
   registration and its final pass; K3: a 500-pose loop under the
   profile's LM settings, poses, costs and iteration count), with
   CUDA-event times after a warm-up;
3. the 64k-point corridor replay (the Velodyne-scale profile) through
   ``PoseGraphSlam.add_data`` against ``tests/fixtures/golden_replay_64k.npz``;
4. the 70-scan loop replay against ``tests/fixtures/golden_replay.npz``
   (20 keyframes, one accepted loop closure, one LM optimize).

The launch counters are zeroed before phase 3 and read after phase 4;
every kernel must have run on that main path. The second-to-last line is
the per-kernel JSON summary; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

POSE_TOL_M = 0.10        # the envelope pgslam_tpu allows its non-ST paths
K2_T_TOL = 1e-4
K2_OVERLAP_TOL = 1e-4     # below one reading point of 2048 changing its weight
K2_RESIDUAL_RTOL = 1e-4
K2_COV_RTOL = 1e-3        # of the largest covariance entry
K3_POSE_TOL_M = 1e-4
K3_ROT_TOL = 1e-4         # rotation matrix entries
K3_COST_RTOL = 1e-3
K3_CLOSURE_GATE_M = 0.01  # BASELINE config 3's gate (closure_err < 0.01 m)
K1_D2_RTOL = 1e-5


def line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def timed(fn, reps: int, warmup: int = 1):
    """Mean milliseconds of ``fn`` by CUDA events, synchronizing after
    every call; returns (ms, last result)."""
    import torch
    out = None
    for _ in range(warmup):
        out = fn()
        torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps, out


def phase_device_and_build():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from pgslam_tpu_torch import _build
    path, seconds, log = _build.build(verbose=True)
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln.lower():
            print("  ptxas: " + ln.strip(), flush=True)
    _build.lib()
    line("build", seconds=round(seconds, 3), library=os.path.basename(path),
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_k1(dev, scans):
    import torch
    from pgslam_tpu_torch.ops.knn import knn, knn_plain
    s0, s1 = scans[0], scans[1]
    cases = [("2048x8192_k1", s1[:2048], s0[:8192], 1, 20),
             ("8192x8192_k8", s0[:8192], s0[:8192], 8, 10),
             ("65536x65536_k1", s1, s0, 1, 3)]
    worst = 0.0
    times = {}
    for name, q, r, k, reps in cases:
        qt = torch.as_tensor(q, device=dev)
        rt = torch.as_tensor(r, device=dev)
        qm = torch.ones(len(q), dtype=torch.bool, device=dev)
        rm = torch.ones(len(r), dtype=torch.bool, device=dev)
        rm[-len(r) // 16:] = False           # masked references too
        ms, mk = timed(lambda: knn(qt, qm, rt, rm, k=k), reps)
        pms, mp = timed(lambda: knn_plain(qt, qm, rt, rm, k=k), max(1, reps // 4))
        if not torch.equal(mk.ids, mp.ids):
            bad = int((mk.ids != mp.ids).sum())
            raise AssertionError(f"K1 {name}: {bad} ids differ from plain")
        fin = torch.isfinite(mp.dists2)
        if not torch.equal(fin, torch.isfinite(mk.dists2)):
            raise AssertionError(f"K1 {name}: finite pattern differs")
        err = float((mk.dists2[fin] - mp.dists2[fin]).abs().max())
        tol = K1_D2_RTOL * max(1.0, float(mp.dists2[fin].abs().max()))
        if err > tol:
            raise AssertionError(f"K1 {name}: d2 err {err} > {tol}")
        worst = max(worst, err)
        times[name] = (ms, pms)
        line("k1", shape=name, ids_equal=True, max_abs_err=err,
             ms=round(ms, 4), plain_ms=round(pms, 4))
    return worst, times


def phase_k2(dev, seq):
    """A loop-closure verification as the 64k profile runs it: scan 1
    against the 3-keyframe map of scans 0-2 in scan 1's frame."""
    import torch
    from pgslam_tpu_torch import se3
    from pgslam_tpu_torch.cloud import make_cloud
    from pgslam_tpu_torch.ops import filters as F
    from pgslam_tpu_torch.ops.icp import reference_chain
    from pgslam_tpu_torch.ops.icp_fused import (fused_icp_register,
                                                fused_icp_register_plain,
                                                result_from_rows)
    from pgslam_tpu_torch.replays import velodyne_config
    cfg = velodyne_config().loop_closer.icp
    scans, poses, _ = seq
    local_map = np.concatenate([s @ p[:3, :3].T + (p[:3, 3] - poses[1][:3, 3])
                                for s, p in zip(scans[:3], poses[:3])])
    reading = F.apply_chain(cfg.reading_filters,
                            make_cloud(scans[1], device=dev))
    ref0 = make_cloud(local_map, device=dev)
    ref = F.apply_chain(reference_chain(cfg, ref0), ref0)
    lift = lambda c: c.map(lambda a: a[None].contiguous())
    rd, rf = lift(reading), lift(ref)
    T0 = se3.exp(torch.tensor([[0.2, -0.1, 0.0, 0.0, 0.0, 0.02]],
                              device=dev))             # odometry-like guess
    ms, res = timed(lambda: fused_icp_register(rd, rf, T0, cfg), 5)
    pms, rows = timed(lambda: fused_icp_register_plain(rd, rf, T0, cfg), 2)
    plain = result_from_rows(rows, T0, cfg)
    err = float((res.T - plain.T).abs().max())
    it_k, it_p = int(res.iterations[0]), int(plain.iterations[0])
    conv_k, conv_p = bool(res.converged[0]), bool(plain.converged[0])
    # The final pass: overlap gates a loop closure, the covariance becomes
    # the edge's information in K3.
    ov_err = float((res.overlap - plain.overlap).abs().max())
    res_err = float((res.residual - plain.residual).abs().max()
                    / plain.residual.abs().max().clamp(min=1e-30))
    cov_err = float((res.cov - plain.cov).abs().max()
                    / plain.cov.abs().max().clamp(min=1e-30))
    line("k2", shape=f"{reading.capacity}x{ref.capacity}_p2plane_c8",
         iterations=it_k, plain_iterations=it_p, converged=conv_k,
         plain_converged=conv_p, overlap=float(res.overlap[0]),
         overlap_err=ov_err, residual=float(res.residual[0]),
         residual_rel_err=res_err, cov_rel_err=cov_err, max_abs_err=err,
         ms=round(ms, 4), plain_ms=round(pms, 4))
    if not (err <= K2_T_TOL and it_k == it_p and conv_k == conv_p
            and ov_err <= K2_OVERLAP_TOL and res_err <= K2_RESIDUAL_RTOL
            and cov_err <= K2_COV_RTOL):
        raise AssertionError(
            f"K2 disagrees with its plain version: T err {err}, iterations "
            f"{it_k} vs {it_p}, converged {conv_k} vs {conv_p}, overlap "
            f"err {ov_err}, residual rel err {res_err}, cov rel err "
            f"{cov_err}")
    return err, ms, pms


def loop_500(dev):
    """BASELINE config 3: a 500-pose ring with accumulated drift and one
    loop edge from the last pose back to the start."""
    import torch
    from pgslam_tpu_torch import se3
    V = 500
    rng = np.random.default_rng(1)
    ang = 2 * np.pi * np.arange(V) / V
    R = se3.exp_so3(torch.as_tensor(
        np.stack([np.zeros(V), np.zeros(V), ang], -1), dtype=torch.float32))
    t = torch.as_tensor(np.stack([20 * np.cos(ang), 20 * np.sin(ang),
                                  np.zeros(V)], -1), dtype=torch.float32)
    true = se3.make(R, t).numpy()
    drift = se3.exp(torch.as_tensor(
        np.cumsum(rng.normal(size=(V, 6)) * 0.002, 0),
        dtype=torch.float32)).numpy()
    init = np.einsum("vij,vjk->vik", true, drift).astype(np.float32)
    ef = np.arange(V - 1, dtype=np.int32)
    et = np.arange(1, V, dtype=np.int32)
    Ts = np.einsum("eij,ejk->eik", np.linalg.inv(init[ef]),
                   init[et]).astype(np.float32)
    T_loop = (np.linalg.inv(true[V - 1]) @ true[0]).astype(np.float32)
    ef = np.concatenate([ef, [V - 1]]).astype(np.int32)
    et = np.concatenate([et, [0]]).astype(np.int32)
    Ts = np.concatenate([Ts, T_loop[None]])
    covs = np.tile(np.eye(6, dtype=np.float32) * 0.01, (V, 1, 1))
    args = tuple(torch.as_tensor(a, device=dev) for a in (
        init, np.ones(V, bool), ef, et, Ts, covs, np.ones(V, bool)))
    return args + (0,), true


def phase_k3(dev):
    """The optimize with the 64k profile's ``PGOConfig`` (the default: 50
    LM iterations, 64 PCG steps, cg_tol 1e-4), as the main path runs it."""
    from pgslam_tpu_torch.optim.lm import lm_optimize
    from pgslam_tpu_torch.optim.pgo import lm_optimize_plain
    from pgslam_tpu_torch.replays import velodyne_config
    args, true = loop_500(dev)
    cfg = velodyne_config().optimizer.pgo
    ms, (pk, sk) = timed(lambda: lm_optimize(*args, config=cfg), 5)
    pms, (pp, sp) = timed(lambda: lm_optimize_plain(*args, config=cfg), 1)
    err = float((pk[:, :3, 3] - pp[:, :3, 3]).norm(dim=1).max())
    rot_err = float((pk[:, :3, :3] - pp[:, :3, :3]).abs().max())
    costs = {k: (float(sk[k]), float(sp[k]))
             for k in ("initial_cost", "final_cost")}
    cost_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in costs.values())
    it_k, it_p = int(sk["iterations"]), int(sp["iterations"])
    closure = float(np.linalg.norm(pk[-1, :3, 3].cpu().numpy()
                                   - true[-1, :3, 3]))
    line("k3", shape="500_poses_500_edges", iterations=it_k,
         plain_iterations=it_p, final_cost=costs["final_cost"][0],
         plain_final_cost=costs["final_cost"][1], cost_rel_err=cost_err,
         closure_err_m=closure, rot_err=rot_err, max_abs_err=err,
         ms=round(ms, 4), plain_ms=round(pms, 4))
    if not (err <= K3_POSE_TOL_M and rot_err <= K3_ROT_TOL
            and cost_err <= K3_COST_RTOL and it_k == it_p
            and closure < K3_CLOSURE_GATE_M):
        raise AssertionError(
            f"K3 disagrees with its plain version: pose gap {err} m, "
            f"rotation err {rot_err}, cost rel err {cost_err}, iterations "
            f"{it_k} vs {it_p}, closure {closure} m")
    return err, ms, pms


def phase_replay(dev, name, keyframes, loops):
    import torch
    from pgslam_tpu_torch import replays
    t0 = time.perf_counter()
    per_scan, _, stats = replays.run_replay(name, device=dev,
                                            sync=torch.cuda.synchronize)
    wall = time.perf_counter() - t0
    gold = replays.fixture(name)
    gap = replays.max_pose_gap(per_scan, gold["per_scan_poses"])
    ms_scan = 1e3 * float(np.mean(stats["scan_seconds"]))
    line(f"replay_{name}", scans=len(per_scan), keyframes=stats["n_keyframes"],
         loop_edges=stats["n_loops"], max_gap_m=round(gap, 5),
         ms_per_scan=round(ms_scan, 3), wall_s=round(wall, 2))
    if not (np.isfinite(per_scan).all() and gap < POSE_TOL_M
            and stats["n_keyframes"] == keyframes
            and stats["n_loops"] == loops):
        raise AssertionError(f"replay {name}: gap {gap}, keyframes "
                             f"{stats['n_keyframes']}, loops "
                             f"{stats['n_loops']}")
    return gap, ms_scan


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on a GPU and has no CPU mode", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import pgslam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    from pgslam_tpu_torch.ops.icp_fused import fused_icp_register
    from pgslam_tpu_torch.ops.knn import knn
    from pgslam_tpu_torch.optim.lm import lm_optimize
    from pgslam_tpu_torch.replays import corridor_64k_sequence

    dev = torch.device("cuda", 0)
    phase_device_and_build()
    seq = corridor_64k_sequence()
    scans = seq[0]
    k1_err, k1_times = phase_k1(dev, scans)
    k2_err, k2_ms, k2_pms = phase_k2(dev, seq)
    k3_err, k3_ms, k3_pms = phase_k3(dev)

    wrappers = (knn, fused_icp_register, lm_optimize)
    for w in wrappers:
        w.launches = 0
    phase_replay(dev, "corridor_64k", keyframes=4, loops=0)
    if knn.launches == 0:
        raise AssertionError("corridor_64k replay never launched K1")
    phase_replay(dev, "loop", keyframes=20, loops=1)
    launches = [w.launches for w in wrappers]
    line("launches", k1=launches[0], k2=launches[1], k3=launches[2])
    if min(launches) == 0:
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")

    ms1, pms1 = k1_times["2048x8192_k1"]
    kernels = [
        {"name": "K1 knn", "route": "cuda",
         "source": "pgslam_tpu_torch/csrc/knn.cu",
         "replaces": "pgslam_tpu/ops/knn_pallas.py:173",
         "launches": launches[0], "max_abs_err": k1_err,
         "ms": ms1, "plain_ms": pms1},
        {"name": "K2 icp_fused", "route": "cuda",
         "source": "pgslam_tpu_torch/csrc/icp_fused.cu",
         "replaces": "pgslam_tpu/ops/icp_pallas.py:667",
         "launches": launches[1], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_pms},
        {"name": "K3 lm", "route": "cuda",
         "source": "pgslam_tpu_torch/csrc/lm.cu",
         "replaces": "pgslam_tpu/optim/lm_pallas.py:1142",
         "launches": launches[2], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_pms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
