#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pgslam_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, one line each (the script raises and exits non-zero on the first
failure, and prints the final JSON line only when every phase passed):

1. device and build: the card from ``nvidia-smi``, then the hand-written
   kernels built from ``pgslam_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths (K1: 2048x8192 k=1, 8192x8192 k=8,
   65536x65536 k=1; K2: the 64k profile's loop-closure verification,
   2048 vs 8192 points, point-to-plane, coarse_div 8, every output of the
   registration and its final pass, without and with Anderson
   acceleration (windows 2-4), and the headline batch, 128 int16 sensor
   packets of 1024 points against 128 distinct 8192-point maps, every
   entry bit-equal to its own B = 1 launch and within the limits of the
   plain version from its start or from one a rounding away; K3: a 500-pose loop under the profile's LM settings,
   poses, costs and iteration count; K4: one LM step's PCG solve of the
   ``pgo_1k`` and ``pgo_16k`` graphs, agreement, residuals and
   bit-for-bit repeats), with CUDA-event times after a warm-up;
3. the per-scan main path: the 64k-point corridor replay (the
   Velodyne-scale profile) through ``PoseGraphSlam.add_data`` against
   ``tests/fixtures/golden_replay_64k.npz``, and the 70-scan loop replay
   against ``tests/fixtures/golden_replay.npz`` (20 keyframes, one
   accepted loop closure, one LM optimize on K3);
4. the large-graph back end: ``optimize_pose_graph`` end to end on
   ``pgo_1k`` (``solver="pcg_pallas"`` under the bench's ``PGOConfig``
   and under the default, ``"cholesky"`` under the bench's with 10 LM
   iterations) and on ``pgo_16k`` (``"pcg"``, which routes to K4), each
   against its plain loop, with K3 timed beside on ``pgo_1k`` and a
   control per problem and config that the limits must catch; then the
   loop replay with ``solver="pcg_pallas"``;
5. the headline protocol (``bench.py:432-685``): ``batched_register`` on
   two blocks of 128 int16 packets, h2d + dequantize + one K2 launch per
   batch, registrations per second and pose error against the packets'
   offsets (gate 0.2 m);
6. the fleet: ``MultiAgentSlam`` at BASELINE config 5 (16 agents, the
   72-scan corridor) for 40 steps, ms per step, closures, and each
   agent's final error to truth (gate 0.25 m); the same run again with
   its split by stage; then the fleet of one on the golden loop, the
   ``icp_core`` route against ``golden_replay.npz`` and the K2 route
   against K2's plain version on the CPU.

The launch counters are zeroed before each of the paths 3-6 and read
after it; each path must have launched its kernels (K1-K3, K4, K2 at
B = 128, K1-K3 with K2 at B = 16). The second-to-last line is the
per-kernel JSON summary; the last is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --crossover

builds the kernels and only times K3 against the LM loop with K4 at the
padded shapes ``Optimizer`` sends (the measurement behind
``optim.pgo.K3_MAX_SIZE``, about three minutes).
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
# Iterations equal, except with an Anderson window of 4: its 3x3 system of
# differences of differences of near-eps twists is near-singular, so the
# rounding of the card's se3 log/exp and matrix products against torch's
# moves the smoothed checker across eps iterations apart (9 against 11
# at the verification shape on an H100, T 3.2e-7 apart).
# tests/test_icp_fused.py:158-165 allows the JAX kernel 2 iterations
# against XLA there.
K2_AA4_ITERATION_SLACK = 2
# The headline batch (128 registrations stopped unconverged after 5 fine
# iterations, map points up to 30 m out): an entry outside the limits
# must meet them against the plain version started from T0 moved by one
# of up to K2_CONTROLS twists of 1e-6 m and 3e-7 rad (k2_compare). On an
# H100 16 of 128 entries were outside (up to 2.96e-3 m in T); the first
# 28 twists matched all 16, within 1.2e-7 m in T and 6e-7 relative in
# the residual and covariance.
K2_CONTROLS = 128
K2_CONTROL_TRANSLATION = 1e-6
K2_CONTROL_ROTATION = 3e-7
# The fleet (BASELINE config 5): tests/test_multi_agent.py:30-31's gate on
# each agent's final error to truth, over this many fleet steps.
FLEET_ERR_GATE_M = 0.25
FLEET_STEPS = 40
# The fleet of one on the golden loop: the K2 route on the card against
# K2's plain version on the CPU, scan by scan. The sequence carries last
# bits far: odometry moved by 1e-6 m moves the card route by up to 0.153
# m, by more than 1 mm from scan 11 on (H100). So scan i is held to
# FLEET_K2_FACTOR times the largest move, over scans 0..i, of
# FLEET_CONTROLS such runs of the card route, and to no less than
# FLEET_K2_TOL_M. On an H100 the K2 route stood 1.24e-4 m from the plain
# one before scan 11, and at most 0.334 of its limit after.
FLEET_CONTROLS = 16
FLEET_CONTROL_NOISE = 1e-6
FLEET_K2_FACTOR = 3.0
FLEET_K2_TOL_M = 1e-3
K3_POSE_TOL_M = 1e-4
K3_ROT_TOL = 1e-4         # rotation matrix entries
K3_COST_RTOL = 1e-3
K3_CLOSURE_GATE_M = 0.01  # BASELINE config 3's gate (closure_err < 0.01 m)
K1_D2_RTOL = 1e-5
K4_X_RTOL = 1e-3          # of max|x_plain|: fp32 CG with another sum order
K4_RESIDUAL_FACTOR = 1.5  # |A x + b| / |b| <= this * sqrt(cg_tol)
# The pgo phase holds each route to its plain loop: poses (m) and final
# costs (relative to the plain cost, plus PGO_COST_ATOL), per problem and
# config. Each limit stands a few times above the largest reading of the
# sound runs on the card (each route against the plain loop, and the plain
# loop against itself: it does not repeat exactly on the card, its
# index_add_ sums use atomics), and each run also measures a control, the
# loop with one CG step per LM iteration (a stop test that fires too
# early), which must fail the same limits. PERF.md (section 6) lists
# both readings. Under the default config the loops end on fp32 noise at
# pgo_1k (poses up to 7.1e-5 m apart) and, at pgo_16k, still descending
# with poses up to 320 m from the anchor (1.1e-4 to 1.9e-4 m and 0.2 % of
# the cost apart).
# The dense route: fp32 Cholesky steps on pgo_1k's normal matrix (the 1e12
# anchor prior beside edge information of 1e2) are 1.1 % (CPU) and 3.8 %
# (card) off the fp64 step, and the card's loop (index_add_ assembly,
# cuSOLVER) does not repeat exactly. After 10 LM iterations its poses
# stood 2.7e-5 to 1.3e-4 m from the CPU loop's, both costs at their floor.
PGO_LIMITS = {("pgo_1k", "bench"): (1e-5, 1e-3),
              ("pgo_1k", "bench_10_iterations"): (4e-4, 1e-3),
              ("pgo_1k", "default"): (2e-4, 1e-3),
              ("pgo_16k", "default"): (5e-4, 6e-3)}
# A converged cost is fp32 noise: at pgo_1k under the default config the
# routes ended between 7.45e-6 and 7.67e-6, at most 2.0e-7 from the plain
# loop's.
PGO_COST_ATOL = 5e-7

# Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
# the least time for a kernel's work is the larger of its bytes over the
# memory rate and its fp32 operations over the fp32 rate.
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12
# fp32 operations, counted from the kernels' sources: a squared distance
# (3 subtractions, 3 multiply-adds); one LM iteration of K3 per edge (the
# residual, Jacobians and three 6x6 blocks, about 4.2k) and per vertex
# (sums, the 6x6 Schur inverse and the retraction, about 0.7k); one PCG
# step per edge (four 6x6 block products, 288, and the sums, 12) and per
# vertex (preconditioner 72, updates and dot products 84).
PAIR_FLOPS = 8
LM_EDGE_FLOPS, LM_VERTEX_FLOPS = 4200, 700
CG_EDGE_FLOPS, CG_VERTEX_FLOPS = 300, 156


def line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def run_times(fn, reps: int, warmup: int = 1):
    """Milliseconds of each of ``reps`` calls of ``fn`` by CUDA events,
    synchronizing after every call; returns (list of ms, last result)."""
    import torch
    out = None
    for _ in range(warmup):
        out = fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


def timed(fn, reps: int, warmup: int = 1):
    """Mean milliseconds of ``fn`` (:func:`run_times`); returns (ms, last
    result)."""
    times, out = run_times(fn, reps, warmup)
    return sum(times) / reps, out


def bound(nbytes: float, flops: float):
    """(least ms on an H100 at 700 W, what bounds it)."""
    t_bytes = 1e3 * nbytes / H100_BYTES_PER_S
    t_ops = 1e3 * flops / H100_FP32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        n, m = len(q), len(r)
        bnd = bound(13 * n + 13 * m + 8 * n * k, PAIR_FLOPS * n * m)
        times[name] = (ms, pms, bnd)
        line("k1", shape=name, ids_equal=True, max_abs_err=err,
             ms=round(ms, 4), plain_ms=round(pms, 4),
             bound_ms=round(bnd[0], 5))
    return worst, times


def k2_gaps(res, ref):
    """Per entry, the gaps of ``res`` to ``ref`` that phase k2's limits
    read: T (largest entry), overlap, residual (relative) and covariance
    (largest entry over ref's largest)."""
    return {
        "T": (res.T - ref.T).abs().amax(dim=(1, 2)),
        "overlap": (res.overlap - ref.overlap).abs(),
        "residual": ((res.residual - ref.residual).abs()
                     / ref.residual.abs().clamp(min=1e-30)),
        "cov": ((res.cov - ref.cov).abs().amax(dim=(1, 2))
                / ref.cov.abs().amax(dim=(1, 2)).clamp(min=1e-30))}


K2_LIMITS = {"T": K2_T_TOL, "overlap": K2_OVERLAP_TOL,
             "residual": K2_RESIDUAL_RTOL, "cov": K2_COV_RTOL}
K2_FIELDS = ("T", "iterations", "converged", "max_iter_reached", "overlap",
             "residual", "cov", "diverged")


def k2_within(res, ref, slack: int):
    """Per entry: T, overlap, residual and covariance within phase k2's
    limits of ``ref``, iterations within ``slack``, converged flags
    equal."""
    ok = ((res.iterations - ref.iterations).abs() <= slack) \
        & (res.converged == ref.converged)
    for f, g in k2_gaps(res, ref).items():
        ok &= g <= K2_LIMITS[f]
    return ok


def k2_take(res, ix):
    """The entries ``ix`` of a batched result."""
    import dataclasses
    return dataclasses.replace(res, **{
        f: getattr(res, f)[ix] for f in K2_FIELDS
        if getattr(res, f) is not None})


def k2_control_twists(n: int):
    """``n`` twists of K2_CONTROL_TRANSLATION m and K2_CONTROL_ROTATION rad
    in directions drawn from a fixed seed."""
    rng = np.random.default_rng(0)
    tw = rng.normal(size=(n, 6))
    tw[:, :3] *= K2_CONTROL_TRANSLATION / np.linalg.norm(tw[:, :3], axis=1,
                                                         keepdims=True)
    tw[:, 3:] *= K2_CONTROL_ROTATION / np.linalg.norm(tw[:, 3:], axis=1,
                                                      keepdims=True)
    return tw


def k2_compare(dev, label, rd, rf, T0, cfg, reps, plain_reps, controls=0,
               **info):
    """K2 against its plain version on one batch: every entry's T,
    iterations, converged flag, overlap, residual and covariance, with
    phase k2's limits. Returns (T err, ms, plain ms, bound, kernel result,
    plain result).

    With ``controls`` every entry is also held to its own B = 1 launch,
    bit for bit in every field; and an entry outside the limits passes
    only if the plain version, started from its T0 moved by one of up to
    ``controls`` twists of the size of fp32 rounding at the map's range
    (k2_control_twists, tried in turn on the entries still unmatched),
    gives the kernel's result within the same limits: the kernel took a
    branch of a near-tie that the plain version takes from a start a
    rounding away."""
    import torch
    from pgslam_tpu_torch import se3
    from pgslam_tpu_torch.ops.icp_fused import (fused_icp_register,
                                                fused_icp_register_plain,
                                                result_from_rows)
    ms, res = timed(lambda: fused_icp_register(rd, rf, T0, cfg), reps)
    pms, rows = timed(lambda: fused_icp_register_plain(rd, rf, T0, cfg),
                      plain_reps, warmup=0)
    plain = result_from_rows(rows, T0, cfg)
    B, n = rd.points.shape[:2]
    m = rf.points.shape[1]
    slack = K2_AA4_ITERATION_SLACK if cfg.anderson_m == 4 else 0
    it_gap = int((res.iterations - plain.iterations).abs().max())
    # The final pass: overlap gates a loop closure, the covariance becomes
    # the edge's information in K3. Relative errors are per entry.
    gaps = k2_gaps(res, plain)
    within = k2_within(res, plain, slack)
    n_within = int(within.sum())
    extra, matched, b1_equal = {}, within.clone(), B
    if controls:
        one = lambda b, c: c.map(lambda a: a[b:b + 1])
        b1_equal = 0
        for b in range(B):
            r1 = fused_icp_register(one(b, rd), one(b, rf), T0[b:b + 1], cfg)
            b1_equal += all(torch.equal(getattr(res, f)[b:b + 1],
                                        getattr(r1, f)) for f in K2_FIELDS)
        pending = (~within).nonzero().flatten()
        tried, worst = 0, {f: 0.0 for f in gaps}
        for tw in k2_control_twists(controls):
            if len(pending) == 0:
                break
            tried += 1
            sub = lambda c: c.map(lambda a: a[pending])
            Tc = T0[pending] @ se3.exp(torch.tensor(tw, dtype=torch.float32,
                                                    device=dev))
            moved = result_from_rows(fused_icp_register_plain(
                sub(rd), sub(rf), Tc, cfg), Tc, cfg)
            mine = k2_take(res, pending)
            hit = k2_within(mine, moved, slack)
            for f, g in k2_gaps(mine, moved).items():
                if bool(hit.any()):
                    worst[f] = max(worst[f], float(g[hit].max()))
            matched[pending[hit]] = True
            pending = pending[~hit]
        extra = dict(b1_bit_equal=b1_equal, twists_tried=tried,
                     entries_matched_by_a_twist=int(matched.sum()) - n_within,
                     unmatched=pending.tolist(),
                     **{f"{f}_err_to_matching_start": v
                        for f, v in worst.items()})
    n_matched = int(matched.sum())
    err = float(gaps["T"].max())
    # Bound: the fine iterations and the final pass of every entry, each an
    # NQ x NR search (the coarse stage's count is not reported, so it is
    # left out and the bound stays a lower bound); every input read once.
    pairs = n * m * int((res.iterations.to(torch.int64) + 1).sum())
    bnd = bound(B * (13 * n + 25 * m + 4 * (16 + 56)), PAIR_FLOPS * pairs)
    line(label, shape=f"{B}x{n}x{m}", **info,
         iterations=",".join(map(str, res.iterations.tolist()[:4]))
         + ("..." if B > 4 else ""),
         iteration_gap=it_gap, converged=int(res.converged.sum()),
         converged_equal=bool(torch.equal(res.converged, plain.converged)),
         overlap_mean=float(res.overlap.mean()), entries_within=n_within,
         overlap_err=float(gaps["overlap"].max()),
         residual_rel_err=float(gaps["residual"].max()),
         cov_rel_err=float(gaps["cov"].max()), max_abs_err=err,
         max_abs_err_within=float(gaps["T"][within].max())
         if n_within else None,
         **extra, ms=round(ms, 4), plain_ms=round(pms, 4),
         bound_ms=round(bnd[0], 5), bound_by=bnd[1])
    if not (n_matched == B and b1_equal == B):
        bad = (~matched).nonzero().flatten().tolist()
        raise AssertionError(
            f"K2 {label} {info} disagrees with its plain version: "
            f"{n_within} of {B} entries within the limits, {n_matched} "
            f"with a control start's (unmatched: {bad}), {b1_equal} of {B} "
            f"equal to their B = 1 launch, T err {err}, iteration gap "
            f"{it_gap} (limit {slack})")
    return err, ms, pms, bnd, res, plain


def phase_k2(dev, seq):
    """A loop-closure verification as the 64k profile runs it: scan 1
    against the 3-keyframe map of scans 0-2 in scan 1's frame; then the
    same registration with Anderson acceleration, windows 2 to 4."""
    import dataclasses

    import torch
    from pgslam_tpu_torch import se3
    from pgslam_tpu_torch.cloud import make_cloud
    from pgslam_tpu_torch.ops import filters as F
    from pgslam_tpu_torch.ops.icp import reference_chain
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
    out = k2_compare(dev, "k2", rd, rf, T0, cfg, 5, 2, error=cfg.error,
                     coarse_div=cfg.coarse_div, anderson_m=0)
    aa_err = 0.0
    for m in (2, 3, 4):
        aa = k2_compare(dev, "k2", rd, rf, T0,
                        dataclasses.replace(cfg, anderson_m=m), 3, 1,
                        error=cfg.error, coarse_div=cfg.coarse_div,
                        anderson_m=m)
        aa_err = max(aa_err, aa[0])
    return out[:4], aa_err


def headline_setup(dev):
    """The headline's fixtures on the card: 128 distinct 8192-point
    references prepared by ``batched_icp_config()``'s reference chain
    from 65536-point renders, and two blocks of 128 int16 sensor packets
    with their offsets (``fleet_problems``)."""
    from pgslam_tpu_torch import fleet_problems as FP
    from pgslam_tpu_torch.cloud import make_cloud, stack_clouds
    from pgslam_tpu_torch.ops.icp import ICPEngine
    t0 = time.perf_counter()
    world = FP.headline_world()
    maps = FP.headline_maps(world)
    packets, offsets = FP.headline_packets(world, n_blocks=2)
    render_s = time.perf_counter() - t0
    cfg = FP.batched_icp_config()
    eng = ICPEngine(cfg)
    t0 = time.perf_counter()
    refs = stack_clouds([eng.prepare_reference(make_cloud(
        m, capacity=FP.HEADLINE_POINTS, device=dev)) for m in maps])
    import torch
    torch.cuda.synchronize()
    line("headline_setup", agents=len(maps), map_points=refs.capacity,
         packet_points=packets.shape[2], render_s=round(render_s, 2),
         reference_prep_s=round(time.perf_counter() - t0, 2))
    return cfg, refs, packets, offsets


def packet_cloud(dev, packet):
    """One block of int16 packets -> the stacked float32 readings (h2d
    and the 1 mm dequantize)."""
    import torch
    from pgslam_tpu_torch.cloud import Cloud, dequantize_cloud
    pts = torch.as_tensor(packet).to(dev)
    return dequantize_cloud(Cloud(points=pts, mask=torch.ones(
        pts.shape[:2], dtype=torch.bool, device=dev), descriptors={}))


def phase_k2_headline(dev, cfg, refs, packets, offsets):
    """K2 at the headline shape: 128 packets of 1024 points against their
    agents' 8192-point maps, every entry against the plain version, and
    both versions' pose errors against the packets' offsets."""
    import torch
    from pgslam_tpu_torch import se3
    B = refs.points.shape[0]
    T0 = torch.eye(4, device=dev).expand(B, 4, 4).contiguous()
    out = k2_compare(dev, "k2_headline", packet_cloud(dev, packets[0]), refs,
                     T0, cfg, 5, 1, controls=K2_CONTROLS, error=cfg.error,
                     coarse_div=cfg.coarse_div, anderson_m=0)
    gold = torch.as_tensor(offsets[0], device=dev)
    errs = {name: se3.log(se3.inverse(r.T) @ gold).norm(dim=-1).cpu().numpy()
            for name, r in (("kernel", out[4]), ("plain", out[5]))}
    line("k2_headline_accuracy", **{
        f"{name}_err_{q}_m": round(float(np.quantile(e, x)), 5)
        for name, e in errs.items()
        for q, x in (("q50", 0.5), ("q90", 0.9), ("max", 1.0))})
    return out[:4]


def phase_batched(dev, cfg, refs, packets, offsets):
    """The headline protocol (``bench.py:432-685``): per batch the h2d of
    128 int16 packets, the dequantize and one ``batched_register``, on 2
    distinct blocks, host clock with a sync per batch after a warm-up;
    pose error of every registration against its offset."""
    import torch
    from pgslam_tpu_torch import fleet_problems as FP
    from pgslam_tpu_torch import se3
    from pgslam_tpu_torch.parallel.batched import batched_register
    B = refs.points.shape[0]
    T0 = torch.eye(4, device=dev).expand(B, 4, 4).contiguous()
    step = lambda pk: batched_register(packet_cloud(dev, pk), refs, T0, cfg)
    step(packets[0])
    torch.cuda.synchronize()
    batch_ms, errs = [], []
    for pk, offs in zip(packets, offsets):
        t0 = time.perf_counter()
        res = step(pk)
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        gold = torch.as_tensor(offs, device=dev)
        errs.append(se3.log(se3.inverse(res.T) @ gold).norm(dim=-1).cpu())
    errs = torch.cat(errs).numpy()
    ms = float(np.mean(batch_ms))
    q50, q90, worst = (float(np.quantile(errs, 0.5)),
                       float(np.quantile(errs, 0.9)), float(errs.max()))
    line("batched", protocol="sensor_decimated_1024pt_int16", agents=B,
         blocks=len(packets), batch_ms=",".join(f"{t:.3f}" for t in batch_ms),
         ms_per_batch=round(ms, 4), regs_per_s=round(1e3 * B / ms, 1),
         err_q50_m=round(q50, 5), err_q90_m=round(q90, 5),
         err_max_m=round(worst, 5), gate_m=FP.POSE_ERR_GATE)
    if not (np.isfinite(errs).all() and worst <= FP.POSE_ERR_GATE):
        raise AssertionError(f"batched: pose error max {worst} m above "
                             f"{FP.POSE_ERR_GATE} m")
    return ms


class FleetTimer:
    """Host milliseconds per fleet phase: wraps the fleet's stages with a
    device synchronize on each side (the split's own syncs are in the
    step times it is reported beside)."""

    def __init__(self):
        self.ms = {}
        self.patched = []

    def restore(self):
        for obj, attr, fn in self.patched:
            setattr(obj, attr, fn)

    def wrap(self, obj, attr, name):
        import torch
        fn = getattr(obj, attr)
        self.patched.append((obj, attr, fn))

        def timed_fn(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.ms[name] = self.ms.get(name, 0.0) \
                + 1e3 * (time.perf_counter() - t0)
            return out
        setattr(obj, attr, timed_fn)


def drive_fleet(dev, seq, n_steps, split=None):
    """BASELINE config 5: 16 agents over one shared pose graph
    (``scripts/bench_configs.py:286-334``), agent b on scan i + b % 3 of
    the 72-scan corridor, through ``MultiAgentSlam.add_data_batch``, with
    a sync after each step. With ``split`` (a FleetTimer) the fleet's
    stages are timed too. Returns (fleet, ms per step, largest error to
    truth over the steps, each agent's final error)."""
    import torch
    from pgslam_tpu_torch import fleet_problems as FP
    from pgslam_tpu_torch.parallel import multi_agent
    scans, odom, truth = seq
    B = 16
    fleet = multi_agent.MultiAgentSlam(FP.fleet_config(), n_agents=B,
                                       device=dev)
    fleet.prewarm()
    if split is not None:
        split.wrap(multi_agent, "prepare_input_batched", "input_prep")
        split.wrap(multi_agent, "batched_register", "registration")
        split.wrap(fleet, "_batched_probes", "probes")
        split.wrap(fleet, "_batched_set_map", "map_builds")
        split.wrap(fleet.loop_closer, "process_pending_batched",
                   "verification")
        split.wrap(fleet.optimizer, "process_pending", "optimize")
    T_rs = np.eye(4, dtype=np.float32)
    step_ms, worst_any = [], 0.0
    try:
        for i in range(n_steps):
            ix = [i + b % 3 for b in range(B)]
            t0 = time.perf_counter()
            fleet.add_data_batch(i, "world", np.stack([odom[j] for j in ix]),
                                 T_rs, [scans[j] for j in ix])
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            errs = [float(np.linalg.norm(fleet.poses()[b][:3, 3]
                                         - truth[j][:3, 3]))
                    for b, j in enumerate(ix)]
            worst_any = max(worst_any, max(errs))
    finally:
        if split is not None:
            split.restore()
    return fleet, step_ms, worst_any, errs


def phase_fleet(dev, seq, n_steps=FLEET_STEPS):
    """The fleet's main-path run, uninstrumented: ms per step, closures
    and each agent's error to truth."""
    fleet, step_ms, worst_any, errs = drive_fleet(dev, seq, n_steps)
    closer = fleet.loop_closer
    total_ms = float(np.sum(step_ms))
    line("fleet", agents=fleet.n_agents, steps=n_steps,
         config="config5_multi_agent", ms_per_step=round(total_ms / n_steps, 3),
         first_step_ms=round(step_ms[0], 3),
         median_step_ms=round(float(np.median(step_ms)), 3),
         agent_scans_per_s=round(1e3 * fleet.n_agents * n_steps / total_ms, 2),
         keyframes=fleet.get_graph().n_vertices,
         closures_accepted=closer.accepted, closures_rejected=closer.rejected,
         closures_duplicate=closer.rejected_duplicate,
         final_err_max_m=round(max(errs), 5),
         err_max_any_step_m=round(worst_any, 5))
    if not (max(errs) < FLEET_ERR_GATE_M and closer.accepted > 0):
        raise AssertionError(f"fleet: final error {max(errs)} m (gate "
                             f"{FLEET_ERR_GATE_M}), {closer.accepted} "
                             f"closures accepted")
    return total_ms / n_steps


def phase_fleet_split(dev, seq, n_steps=FLEET_STEPS):
    """The fleet run again with each stage between two syncs: where its
    step time goes. The syncs are this run's own, so its step time is
    reported apart from the fleet's."""
    split = FleetTimer()
    _, step_ms, _, _ = drive_fleet(dev, seq, n_steps, split)
    total_ms = float(np.sum(step_ms))
    line("fleet_split", steps=n_steps,
         instrumented_ms_per_step=round(total_ms / n_steps, 3),
         **{f"{k}_ms_per_step": round(v / n_steps, 3)
            for k, v in split.ms.items()},
         other_ms_per_step=round((total_ms - sum(split.ms.values()))
                                 / n_steps, 3))


def fleet_of_one(dev, fused, odom_noise=0.0, seed=0):
    """The fleet at B = 1 with synchronous closures on the golden loop,
    registering by ``fused`` (MultiAgentSlam's route), with the odometry
    moved by ``odom_noise`` m (normal, from ``seed``). Returns (per-scan
    poses, loop edges, keyframes, wall s)."""
    from pgslam_tpu_torch import replays
    from pgslam_tpu_torch.graph.pose_graph import LOOP_CONSTRAINT
    from pgslam_tpu_torch.parallel.multi_agent import MultiAgentSlam
    scans, odom, _ = replays.loop_sequence_golden()
    rng = np.random.default_rng(seed)
    fleet = MultiAgentSlam(replays.loop_config(), n_agents=1, device=dev,
                           fused=fused)
    fleet.loop_closer.queue_mode = False
    fleet.localizers[0].defer_graph_resync = False
    T_rs = np.eye(4, dtype=np.float32)
    per_scan = []
    t0 = time.perf_counter()
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        T_odom = T_odom.copy()
        T_odom[:3, 3] += odom_noise * rng.normal(size=3)
        fleet.add_data_batch(i, "world", T_odom[None], T_rs, [scan])
        per_scan.append(fleet.poses()[0].copy())
    wall = time.perf_counter() - t0
    g = fleet.get_graph()
    loops = int(np.sum(g.edge_type[:g.n_edges] == LOOP_CONSTRAINT))
    return np.stack(per_scan), loops, g.n_vertices, wall


def phase_fleet_golden(dev):
    """The fleet at B = 1 with synchronous closures on the golden loop,
    on each route. ``icp_core`` (``fused="off"``) against
    ``tests/fixtures/golden_replay.npz`` (+-1 scan, 0.10 m), as the CPU
    test runs it. K2 (``fused="auto"``, the card's route) scan by scan
    against K2's plain version on the same inputs (``fused="on"`` on the
    CPU), each scan within FLEET_K2_FACTOR times the envelope of controls
    up to it (the K2 route again with the odometry moved by
    FLEET_CONTROL_NOISE m, which shows how far last bits carry this
    sequence) and within FLEET_K2_TOL_M before they move."""
    from pgslam_tpu_torch import replays
    gold = replays.fixture("loop")
    runs = {"icp_core": fleet_of_one(dev, "off"),
            "k2": fleet_of_one(dev, "auto"),
            "k2_plain_cpu": fleet_of_one("cpu", "on")}
    scan_gap = lambda a, b: np.linalg.norm(a[:, :3, 3] - b[:, :3, 3],
                                           axis=1)
    env = np.max([scan_gap(fleet_of_one(dev, "auto", FLEET_CONTROL_NOISE,
                                        seed)[0], runs["k2"][0])
                  for seed in range(FLEET_CONTROLS)], axis=0)
    for route, (per_scan, loops, kf, wall) in runs.items():
        line("fleet_golden_loop", agents=1, registration=route,
             scans=len(per_scan), keyframes=kf, loop_edges=loops,
             gap_to_fixture_m=round(replays.max_pose_gap(
                 per_scan, gold["per_scan_poses"], window=1), 5),
             wall_s=round(wall, 2))
        if not (np.isfinite(per_scan).all()
                and loops == int(gold["n_loop_edges"])):
            raise AssertionError(f"fleet_golden_loop ({route}): loop edges "
                                 f"{loops}")
    core_gap = replays.max_pose_gap(runs["icp_core"][0],
                                    gold["per_scan_poses"], window=1)
    k2_gap = scan_gap(runs["k2"][0], runs["k2_plain_cpu"][0])
    limit = np.maximum(FLEET_K2_FACTOR * np.maximum.accumulate(env),
                       FLEET_K2_TOL_M)
    first = int(np.argmax(env > FLEET_K2_TOL_M)) if (env > FLEET_K2_TOL_M
                                                     ).any() else None
    line("fleet_golden_k2", gap_to_plain_m=float(k2_gap.max()),
         control_envelope_m=float(env.max()),
         first_scan_moved_1mm=first,
         worst_share_of_limit=float((k2_gap / limit).max()),
         gap_before_that_m=float(k2_gap[:first].max()) if first else None)
    if not (core_gap < POSE_TOL_M and (k2_gap <= limit).all()):
        bad = np.nonzero(k2_gap > limit)[0].tolist()
        raise AssertionError(f"fleet_golden_loop: icp_core {core_gap} m "
                             f"from the fixture (limit {POSE_TOL_M}); K2 "
                             f"beyond its limit at scans {bad}")


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
    V, E = args[0].shape[0], args[2].shape[0]
    bnd = lm_bound(V, E, it_k, int(sp["cg_steps"]))
    line("k3", shape="500_poses_500_edges", iterations=it_k,
         plain_iterations=it_p, plain_cg_steps=int(sp["cg_steps"]),
         final_cost=costs["final_cost"][0],
         plain_final_cost=costs["final_cost"][1], cost_rel_err=cost_err,
         closure_err_m=closure, rot_err=rot_err, max_abs_err=err,
         ms=round(ms, 4), plain_ms=round(pms, 4), bound_ms=round(bnd[0], 5))
    if not (err <= K3_POSE_TOL_M and rot_err <= K3_ROT_TOL
            and cost_err <= K3_COST_RTOL and it_k == it_p
            and closure < K3_CLOSURE_GATE_M):
        raise AssertionError(
            f"K3 disagrees with its plain version: pose gap {err} m, "
            f"rotation err {rot_err}, cost rel err {cost_err}, iterations "
            f"{it_k} vs {it_p}, closure {closure} m")
    return err, ms, pms, bnd


def lm_bound(V: int, E: int, lm_iterations: int, cg_steps: int):
    """K3's least time: its inputs (poses, masks, endpoints, measurements,
    covariances) read once and the poses written once; the operations of
    its LM iterations and of the CG steps (taken from the plain version,
    which K3 does not report)."""
    nbytes = 64 * V + V + E * (8 + 64 + 144 + 2) + 64 * V + 16
    flops = (lm_iterations * (LM_EDGE_FLOPS * E + LM_VERTEX_FLOPS * V)
             + cg_steps * (CG_EDGE_FLOPS * E + CG_VERTEX_FLOPS * V))
    return bound(nbytes, flops)


def phase_k4(dev):
    """One LM step's PCG solve at the initial poses of ``pgo_1k`` and
    ``pgo_16k`` under the default ``PGOConfig`` (up to 64 CG steps,
    cg_tol 1e-4): K4 against its plain version. Returns, per problem,
    (max abs err, ms, plain ms, bound)."""
    import torch
    from pgslam_tpu_torch.optim import pgo
    from pgslam_tpu_torch.optim.lm import edge_csr
    from pgslam_tpu_torch.optim.pcg import pcg_solve
    from pgslam_tpu_torch.pgo_problems import named_problem
    cfg = pgo.PGOConfig()
    kw = dict(cg_iterations=cfg.cg_iterations, cg_tol=cfg.cg_tol,
              return_iterations=True)
    out = {}
    for name in ("pgo_1k", "pgo_16k"):
        args, _ = named_problem(name, device=dev)
        prob = pgo.LMProblem(*args, config=cfg)
        blocks, b, D = prob.system(args[0])
        lam = torch.tensor(cfg.lambda_init, device=dev)
        P_inv, damp = pgo.block_jacobi(D, lam, args[1])
        sysargs = (blocks, P_inv, damp, b, prob.prior_info, prob.fixed,
                   prob.ef, prob.et)
        V, E = b.shape[0], blocks[0].shape[0]
        csr = edge_csr(prob.ef, prob.et, V)
        ms, (xk, sk) = timed(lambda: pcg_solve(*sysargs, csr=csr, **kw), 20)
        x2, _ = pcg_solve(*sysargs, csr=csr, **kw)
        pms, (xp, sp) = timed(lambda: pgo.pcg_solve_plain(*sysargs, **kw), 3)
        torch.cuda.synchronize()
        repeat = torch.equal(xk, x2)
        err = float((xk - xp).abs().max())
        scale = float(xp.abs().max())

        def rel_residual(x):
            Ax = pgo.system_matvec(blocks, damp, prob.prior_info, prob.fixed,
                                   prob.ef, prob.et, x)
            return float((Ax + b).norm() / b.norm())

        rk, rp = rel_residual(xk), rel_residual(xp)
        steps = int(sk)
        # Bound: the three block tensors, P_inv, damping, b, endpoints and
        # CSR order read once, x written once; the operations of the steps
        # this solve took and of its start.
        nbytes = 3 * 144 * E + V * (144 + 24 + 24) + 8 * E \
            + 4 * (V + 1 + 2 * E) + 24 * V
        bnd = bound(nbytes, steps * (CG_EDGE_FLOPS * E + CG_VERTEX_FLOPS * V)
                    + 96 * V)
        res_tol = K4_RESIDUAL_FACTOR * cfg.cg_tol ** 0.5
        line("k4", problem=name, V=V, E=E, grid=pcg_solve.grid,
             cg_steps=steps, plain_cg_steps=sp, max_abs_err=err,
             max_abs_plain=scale, rel_residual=rk, plain_rel_residual=rp,
             repeats_bitwise=repeat, ms=round(ms, 4), plain_ms=round(pms, 4),
             bound_ms=round(bnd[0], 6), bound_by=bnd[1])
        if not (err <= K4_X_RTOL * scale and rk <= res_tol
                and rp <= res_tol and repeat and pcg_solve.grid > 1):
            raise AssertionError(
                f"K4 {name}: err {err} vs {K4_X_RTOL} * {scale}, residuals "
                f"{rk} / {rp} vs {res_tol}, repeats {repeat}, grid "
                f"{pcg_solve.grid}")
        out[name] = (err, ms, pms, bnd)
    return out


def _pgo_gaps(pk, sk, pp, sp, cost_rtol=K3_COST_RTOL):
    """Pose gap (m), rotation entry error, final-cost error relative to
    the plain cost, and whether the cost error is within ``cost_rtol`` of
    the plain cost plus PGO_COST_ATOL."""
    gap = float((pk[:, :3, 3] - pp[:, :3, 3]).norm(dim=1).max())
    rot = float((pk[:, :3, :3] - pp[:, :3, :3]).abs().max())
    ck, cp = float(sk["final_cost"]), float(sp["final_cost"])
    cost = abs(ck - cp) / max(abs(cp), 1e-30)
    cost_ok = abs(ck - cp) <= cost_rtol * abs(cp) + PGO_COST_ATOL
    return gap, rot, cost, cost_ok


def phase_pgo(dev):
    """``optimize_pose_graph`` end to end on the large-graph problems,
    each route against its plain loop (the dense route against the same
    loop on the CPU), with K3 timed beside on ``pgo_1k``, and per problem
    and config a control that the limits must catch."""
    import dataclasses

    import torch
    from pgslam_tpu_torch.optim import pgo
    from pgslam_tpu_torch.optim.lm import lm_optimize
    from pgslam_tpu_torch.optim.pcg import pcg_solve
    from pgslam_tpu_torch.pgo_problems import named_problem
    bench = pgo.PGOConfig(max_iterations=4, cg_iterations=30, cg_tol=1e-3)
    default = pgo.PGOConfig()
    # The dense route runs 10 LM iterations: after the bench's 4 the fp32
    # Cholesky loops on the card and on the CPU are not yet at their floor.
    dense = dataclasses.replace(bench, max_iterations=10)
    failures = []
    cases = (("pgo_1k", "bench", bench, ("pcg_pallas",)),
             ("pgo_1k", "bench_10_iterations", dense, ("cholesky",)),
             ("pgo_1k", "default", default, ("pcg_pallas",)),
             ("pgo_16k", "default", default, ("pcg",)))
    for name, cname, cfg, solvers in cases:
        args, _ = named_problem(name, device=dev)
        V, E = args[0].shape[0], args[2].shape[0]
        pose_tol, cost_rtol = PGO_LIMITS[(name, cname)]
        repeat = (None, None)
        if cfg is dense:
            plain_name = "the dense loop on the CPU"
            cpu = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
            t0 = time.perf_counter()
            pc, sc = pgo.optimize_pose_graph(
                *cpu, config=dataclasses.replace(cfg, solver="cholesky"))
            ref_ms, ref = 1e3 * (time.perf_counter() - t0), (pc.to(dev), sc)
        else:
            plain_name = "the pcg_plain loop on the card"
            plain = lambda: pgo.lm_optimize_loop(*args, config=cfg,
                                                 solve="pcg_plain")
            ref_ms, ref = timed(plain, 1, warmup=0)
            # The plain loop does not repeat exactly on the card (index_add_
            # sums with atomics): its own spread, beside the kernel's gap.
            repeat = _pgo_gaps(*plain(), *ref)[::2]
        runs = [(s, dataclasses.replace(cfg, solver=s)) for s in solvers]
        if name == "pgo_1k" and cfg is not dense:
            runs.append(("lm_pallas", dataclasses.replace(
                cfg, solver="lm_pallas")))

        def within(gap, rot, cost_ok):
            return gap <= pose_tol and rot <= K3_ROT_TOL and cost_ok

        for solver, c in runs:
            path = pgo.route(c, V, E, dev)
            before = (pcg_solve.launches, lm_optimize.launches)
            ms, (pk, sk) = timed(
                lambda: pgo.optimize_pose_graph(*args, config=c), 3)
            k4_runs = pcg_solve.launches - before[0]
            k3_runs = lm_optimize.launches - before[1]
            gap, rot, cost, cost_ok = _pgo_gaps(pk, sk, *ref, cost_rtol)
            line("pgo", problem=name, config=cname, solver=solver,
                 route=path, k4_launches=k4_runs, k3_launches=k3_runs,
                 iterations=int(sk["iterations"]),
                 plain_iterations=int(ref[1]["iterations"]),
                 cg_steps=int(sk.get("cg_steps", -1)),
                 final_cost=float(sk["final_cost"]),
                 plain_final_cost=float(ref[1]["final_cost"]),
                 pose_gap_m=gap, pose_tol_m=pose_tol, rot_err=rot,
                 cost_rel_err=cost, cost_rtol=cost_rtol,
                 plain_repeat_gap_m=repeat[0],
                 plain_repeat_cost_rel_err=repeat[1],
                 ms=round(ms, 4), plain_ms=round(ref_ms, 4),
                 plain=plain_name.replace(" ", "_"))
            want_k4 = path == "pcg"
            if (k4_runs > 0) != want_k4 or (k3_runs > 0) != (path == "lm"):
                raise AssertionError(f"{name} {solver}: route {path} but "
                                     f"K4 ran {k4_runs}, K3 {k3_runs} times")
            if name == "pgo_16k" and not want_k4:
                raise AssertionError("pgo_16k under solver='pcg' did not "
                                     "route to K4")
            if not within(gap, rot, cost_ok):
                failures.append(
                    f"{name} {cname} {solver} disagrees with its plain "
                    f"loop: pose gap {gap} m, rotation err {rot}, cost rel "
                    f"err {cost}")
        # The control: the loop stopping every solve after one CG step (the
        # plain solve, so that K4's count holds only the routes' launches).
        pk, sk = pgo.lm_optimize_loop(
            *args, config=dataclasses.replace(cfg, cg_iterations=1),
            solve="pcg_plain")
        gap, rot, cost, cost_ok = _pgo_gaps(pk, sk, *ref, cost_rtol)
        caught = not within(gap, rot, cost_ok)
        line("pgo_control", problem=name, config=cname, cg_iterations=1,
             iterations=int(sk["iterations"]),
             final_cost=float(sk["final_cost"]), pose_gap_m=gap,
             pose_tol_m=pose_tol, rot_err=rot, cost_rel_err=cost,
             caught=caught)
        if not caught:
            failures.append(f"{name} {cname}: the one-step control passes "
                            f"the limits (pose gap {gap} m, rotation err "
                            f"{rot}, cost rel err {cost})")
    if failures:
        raise AssertionError("; ".join(failures))


def phase_crossover(dev):
    """K3 against the LM loop with K4 under the default ``PGOConfig``, at
    the padded shapes ``Optimizer`` sends: per power-of-two V, a ring
    trajectory of 3V/4 poses with V/8 loop edges (E = V after padding,
    a SLAM run's odometry chain with few closures) and one of V poses
    with V + 1 loop edges (E = 2V, ``pgo_1k``'s construction). The two are
    timed in turn, after one warm-up each, and compared by their medians
    (the loop's host time swings between calls)."""
    from pgslam_tpu_torch.optim import pgo
    from pgslam_tpu_torch.optim.lm import lm_optimize
    from pgslam_tpu_torch.pgo_problems import bucketed_problem
    cfg = pgo.PGOConfig()
    k3_faster = []
    for V in (512, 1024, 2048, 4096, 16384):
        for n_vertices, n_loop in ((3 * V // 4, V // 8), (V, V + 1)):
            args, _ = bucketed_problem(n_vertices, n_loop, device=dev)
            E = args[2].shape[0]
            reps = 5 if V <= 4096 else 2
            k3 = lambda: lm_optimize(*args, config=cfg)
            loop = lambda: pgo.lm_optimize_loop(*args, config=cfg,
                                                solve="pcg")
            run_times(k3, 0)
            run_times(loop, 0)
            k3_ms, loop_ms = [], []
            for _ in range(reps):
                t, (p3, s3) = run_times(k3, 1, warmup=0)
                k3_ms += t
                t, (p4, s4) = run_times(loop, 1, warmup=0)
                loop_ms += t
            k3_med, loop_med = float(np.median(k3_ms)), float(np.median(loop_ms))
            if k3_med < loop_med:
                k3_faster.append(V + E)
            gap = float((p3[:, :3, 3] - p4[:, :3, 3]).norm(dim=1).max())
            line("crossover", V=V, E=E, n_vertices=n_vertices,
                 n_edges=n_vertices - 1 + n_loop,
                 k3_ms=",".join(f"{t:.3f}" for t in k3_ms),
                 loop_ms=",".join(f"{t:.3f}" for t in loop_ms),
                 k3_median_ms=round(k3_med, 3),
                 loop_median_ms=round(loop_med, 3),
                 k3_iterations=int(s3["iterations"]),
                 loop_iterations=int(s4["iterations"]),
                 loop_cg_steps=int(s4["cg_steps"]), pose_gap_m=gap,
                 route=pgo.route(cfg, V, E, dev))
    line("crossover", k3_faster_at_sizes=",".join(map(str, k3_faster)),
         K3_MAX_SIZE=pgo.K3_MAX_SIZE)


def phase_replay(dev, name, keyframes, loops, solver=None):
    import dataclasses

    import torch
    from pgslam_tpu_torch import replays
    config, label = None, f"replay_{name}"
    if solver is not None:
        config = replays.REPLAYS[name][1]()
        config = dataclasses.replace(config, optimizer=dataclasses.replace(
            config.optimizer, pgo=dataclasses.replace(config.optimizer.pgo,
                                                      solver=solver)))
        label += f"_{solver}"
    t0 = time.perf_counter()
    per_scan, _, stats = replays.run_replay(name, device=dev,
                                            sync=torch.cuda.synchronize,
                                            config=config)
    wall = time.perf_counter() - t0
    gold = replays.fixture(name)
    gap = replays.max_pose_gap(per_scan, gold["per_scan_poses"])
    ms_scan = 1e3 * float(np.mean(stats["scan_seconds"]))
    line(label, scans=len(per_scan), keyframes=stats["n_keyframes"],
         loop_edges=stats["n_loops"], max_gap_m=round(gap, 5),
         ms_per_scan=round(ms_scan, 3), wall_s=round(wall, 2))
    if not (np.isfinite(per_scan).all() and gap < POSE_TOL_M
            and stats["n_keyframes"] == keyframes
            and stats["n_loops"] == loops):
        raise AssertionError(f"{label}: gap {gap}, keyframes "
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
    from pgslam_tpu_torch.optim.pcg import pcg_solve
    from pgslam_tpu_torch.fleet_problems import config5_sequence
    from pgslam_tpu_torch.replays import corridor_64k_sequence

    dev = torch.device("cuda", 0)
    phase_device_and_build()
    if "--crossover" in sys.argv[1:]:
        phase_crossover(dev)
        return 0
    seq = corridor_64k_sequence()
    scans = seq[0]
    k1_err, k1_times = phase_k1(dev, scans)
    (k2_err, k2_ms, k2_pms, k2_bnd), k2_aa_err = phase_k2(dev, seq)
    hcfg, refs, packets, offsets = headline_setup(dev)
    k2h_err, k2h_ms, k2h_pms, k2h_bnd = phase_k2_headline(dev, hcfg, refs,
                                                          packets, offsets)
    k3_err, k3_ms, k3_pms, k3_bnd = phase_k3(dev)
    k4 = phase_k4(dev)

    wrappers = (knn, fused_icp_register, lm_optimize, pcg_solve)

    def reset():
        for w in wrappers:
            w.launches = 0
        fused_icp_register.batch_sizes.clear()

    def counts():
        return [w.launches for w in wrappers]

    reset()
    phase_replay(dev, "corridor_64k", keyframes=4, loops=0)
    if knn.launches == 0:
        raise AssertionError("corridor_64k replay never launched K1")
    phase_replay(dev, "loop", keyframes=20, loops=1)
    per_scan = counts()
    if min(per_scan[:3]) == 0:
        raise AssertionError(f"a kernel of the per-scan path never ran: "
                             f"{per_scan}")

    reset()
    phase_pgo(dev)
    before = pcg_solve.launches
    phase_replay(dev, "loop", keyframes=20, loops=1, solver="pcg_pallas")
    if pcg_solve.launches == before:
        raise AssertionError("the loop replay under pcg_pallas never "
                             "launched K4")
    pgo_path = counts()

    reset()
    batch_ms = phase_batched(dev, hcfg, refs, packets, offsets)
    batched = counts()
    if batched[1] == 0 or fused_icp_register.batch_sizes[128] == 0:
        raise AssertionError("the batched path never launched K2 at B=128")
    del refs

    seq5 = config5_sequence()
    reset()
    fleet_ms = phase_fleet(dev, seq5)
    fleet = counts()
    fleet_batches = dict(fused_icp_register.batch_sizes)
    if min(fleet[:3]) == 0 or fleet_batches.get(16, 0) == 0:
        raise AssertionError(f"a kernel of the fleet path never ran (K1-K4 "
                             f"{fleet}, K2 batch sizes {fleet_batches})")
    phase_fleet_split(dev, seq5)
    phase_fleet_golden(dev)
    line("launches", per_scan=",".join(map(str, per_scan)),
         pgo=",".join(map(str, pgo_path)), batched=",".join(map(str, batched)),
         fleet=",".join(map(str, fleet)),
         fleet_k2_batch_sizes=",".join(f"{b}x{n}" for b, n
                                       in sorted(fleet_batches.items())),
         order="k1,k2,k3,k4")

    paths = {"per_scan": per_scan, "pgo": pgo_path, "batched": batched,
             "fleet": fleet}
    ms1, pms1, bnd1 = k1_times["2048x8192_k1"]
    k4_err, k4_ms, k4_pms, k4_bnd = k4["pgo_16k"]
    rows = [
        ("K1 knn", "knn.cu", "pgslam_tpu/ops/knn_pallas.py:173",
         k1_err, ms1, pms1, bnd1, {}),
        ("K2 icp_fused", "icp_fused.cu", "pgslam_tpu/ops/icp_pallas.py:667",
         max(k2h_err, k2_err, k2_aa_err), k2h_ms, k2h_pms, k2h_bnd,
         {"shape": "128 x 1024 vs 8192, batched_icp_config",
          "anderson": "in-kernel, m 2-4 checked",
          "anderson_max_abs_err": k2_aa_err,
          "verification_b1_ms": k2_ms, "verification_b1_plain_ms": k2_pms,
          "verification_b1_bound_ms": k2_bnd[0],
          "batched_ms_per_batch": batch_ms, "fleet_ms_per_step": fleet_ms}),
        ("K3 lm", "lm.cu", "pgslam_tpu/optim/lm_pallas.py:1142",
         k3_err, k3_ms, k3_pms, k3_bnd, {}),
        ("K4 pcg", "pcg.cu", "pgslam_tpu/optim/pcg_pallas.py:174",
         k4_err, k4_ms, k4_pms, k4_bnd, {}),
    ]
    # library_ms: no single PyTorch call computes any of these functions
    # (a masked k-NN, a whole ICP registration, a whole LM optimize, a
    # truncated PCG solve).
    kernels = []
    for k, (name, src, rep, err, ms, pms, bnd, extra) in enumerate(rows):
        by_path = {p: c[k] for p, c in paths.items()}
        kernels.append({"name": name, "route": "cuda",
                        "source": f"pgslam_tpu_torch/csrc/{src}",
                        "replaces": rep, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, "max_abs_err": err,
                        "ms": ms, "plain_ms": pms, "bound_ms": bnd[0],
                        "bound_by": bnd[1], "library_ms": None, **extra})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
