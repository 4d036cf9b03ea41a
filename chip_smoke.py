#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pgslam_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, one line each (the script raises and exits non-zero on the first
failure, and prints the final JSON line only when every phase passed):

1. device and build: the card from ``nvidia-smi``, then the hand-written
   kernels built from ``pgslam_tpu_torch/csrc`` and the native core
   (``pgslam_tpu_torch/native``, host g++);
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths (K1: 2048x8192 k=1, its coarse stage's
   256x8192 k=1, 8192x8192 k=8, 65536x65536 k=1 and the loop replay's
   512x1536 k=1, at the layout ``k1_layout`` chooses and at one slice of
   128 threads, with cdist + topk timed beside; K2: the 64k profile's loop-closure verification,
   2048 vs 8192 points, point-to-plane, coarse_div 8, every output of the
   registration and its final pass, without and with Anderson
   acceleration (windows 2-4), and the headline batch, 128 int16 sensor
   packets of 1024 points against 128 distinct 8192-point maps, every
   entry bit-equal to its own B = 1 launch and within the limits of the
   plain version from its start or from one a rounding away; K3: a
   500-pose loop under the profile's LM settings (poses, costs and
   iteration count) and ``pgo_1k`` under the default ``PGOConfig``, each
   launched three times for the same bits, with its cluster size; K4:
   one LM step's PCG solve of the ``pgo_1k`` and ``pgo_16k`` graphs and
   of the loop replay's padded 64 x 64 graph at their initial poses, with
   the default stop test and run to exactly 64 CG steps, at the layout
   ``k4_layout`` chooses: agreement, residuals, step counts and
   bit-for-bit repeats, device time per launch and per CG step), with
   CUDA-event times after a warm-up;
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
   against K2's plain version on the CPU;
7. the deferred path: the loop at ``sync_lag=2`` with deferred
   verification against the JAX package's run
   (``golden_replay_lag2.npz``: equal counts, gap 0.10 m);
   ``force_deferred`` at lag 0 against two classic replays; the loop at
   ``micro_batch=4`` (K2 at B = 4) in the JAX package's streaming
   envelopes against truth, its gap to ``golden_replay_stream4.npz``
   printed; BASELINE config 4's live loop, the 64k corridor at
   ``sync_lag=2``, against ``golden_replay_64k.npz``'s last pose and the
   lag-shifted truth, ms per scan beside lag 0's (deferred replays are
   synchronized once, after their flush); and ``PoseGraphSlamMT`` on the
   loop, lockstep (+-1 scan, 0.10 m) and free-running (final pose).
   Phase k2 also checks the streaming shape, 4 x 512 vs 1536;
8. config and persistence: the 300-scan clover (``replay_long``: 50
   keyframes, 3 closures, 3 optimizes, every scan within 0.10 m of
   ``golden_replay_long.npz`` up to the first scan whose decision
   differs from the JAX run's; then the truth envelope and final pose of
   ``pgslam_tpu``'s own non-bitwise paths and the ATE within 0.05 m of
   the fixture's; the replay again with plain K1 for the same bits, and
   K3 at its optimizes against the plain LM); ``slam_config.yaml``
   through ``from_yaml`` over the 2048-point clover
   (``replay_yaml_clover``) against ``golden_replay_yaml.npz``; the
   point-to-plane YAML through ``from_config_paths`` on the same scans
   (``replay_p2plane``: RandomSampling, ObservationDirection, MaxDist,
   normals at k = 10), twice for the same bits, held to the truth; the
   loop on the grid matcher (``replay_grid``) against
   ``golden_replay_grid.npz``, with its first local-map composition or
   keyframe count off the JAX run's (``golden_replay_grid_eval.npz``)
   and the overlaps there; and the loop checkpointed at scan 35 and
   resumed by a fresh facade (``resume``), with its KITTI, TUM and PLY
   files read back. Phase k1 also checks the YAML replays' shapes (1024
   x 3072 k = 1, 3072 x 3072 k = 10) and k = 16;
9. the single-scan K2 route (``PGSLAM_FUSED_SINGLE=1``): the loop and the
   64k corridor synchronized per scan with every scan registered by one
   K2 launch at B = 1 and none by ``icp_core`` (the loop against
   ``golden_replay.npz`` at ``FUSED1_LOOP_TOL_M``, the corridor at
   ``POSE_TOL_M``), ms per scan beside route-off replays run just before;
   then ``profile_replay`` of both replays with the route on and off
   (device idle share), and the native core: built by the host g++, the
   loop's scans streamed through ``ScanLoader`` from KITTI files and
   replayed, and the native Dijkstra against the Python heap on that
   replay's graph. Phase k2 also checks the route's shape, 1 x 512 vs
   1536;
10. the resident mirror (``optim/resident.py``, the default optimize
   path, which every earlier replay and fleet phase already takes), each
   sequence with the mirror and with the classic upload
   (``resident="off"``), timed, then again counting the synchronizing
   CUDA calls of each optimize (``torch.cuda.set_sync_debug_mode``):
   ``resident_loop`` (the golden loop), ``resident_growth`` (a ring like
   ``pgo_1k``'s growing from 512 keyframes over 16 optimizes, loop
   constraints queued, a host pose write, a bucket crossing) and
   ``resident_16k`` (``pgo_16k`` through the K4 loop with the quat7
   writeback, and once more with exact12): the same K3 and K4 launches,
   the poses after every optimize bit-equal to the classic path's (or
   within its own repeat gap, plus quat7's round-off), one
   synchronization (the fetch) per resident optimize on K3; optimizes,
   rebuilds and deltas, bytes up and down and ms per optimize both
   ways. A handler on the optimizer's logger fails the run if any
   resident optimize of any phase fell back to the classic path. Phase
   k4 also times pgo_16k padded as the Optimizer pads it;
11. the mesh (``parallel/multichip.py``, ``parallel/sharded_icp.py``,
   ``MultiAgentSlam(mesh=)``), every mesh position on this card unless
   the machine has more, each line with the mesh's device grid:
   ``mesh_match`` (K1 on tp = 2, 4, 8 reference shards, merged, bit-equal
   to K1 over the whole reference at the loop's 512 x 1536 and the
   verification's 2048 x 8192, k = 1 and 8, with masks and forced ties;
   run before the counters are zeroed), ``mesh_register``
   (``make_sharded_register`` at dp = 4 x tp = 2 against the same call on
   the CPU, and at one agent a group bit-equal to ``icp_core`` on the
   card), ``mesh_step`` (``sharded_icp_step`` under both merges, the same
   bits, and ``dryrun_multichip(8)``), ``mesh_fleet`` (config 5's 16
   agents for 40 steps on dp = 8 x tp = 2, ms per step beside phase
   fleet's, then tests/test_multi_agent.py:80-112's case against the
   single-device fleet, and the tp = 1 route, one K2 launch per dp
   chunk, bit-equal to the unchunked K2 batch), ``mesh_loop`` (the fleet
   of one on the golden loop at dp = 1 x tp = 8 against
   ``golden_replay.npz``) and ``mesh_devices`` (two cards, where the
   machine has them). The single-device references beside the mesh runs
   launch uncounted, so the path's counts are the mesh runs' own. Phase
   k1 also checks the shard shapes 512 x 768, 512 x 192 and 64 x 128.

The launch counters are zeroed before each of the paths 3-11 and read
after it; each path must have launched its kernels (K1-K3, K4, K2 at
B = 128, K1-K3 with K2 at B = 16, K1-K3 with K2 at B = 4, K1-K3, K1-K3
with K2 at B = 1 only, K3 and K4, K1-K3), and the launches line gives each
path's most-launched K1 shapes, every one of which phase k1 must have
checked and timed, and its most-launched K4 shapes, every one of which
must be one of phase k4's cases, with its mean CG steps a K4 launch. The
second-to-last line is the per-kernel JSON summary; the last is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --resident

builds the kernels and runs only path 10, the resident mirror's three
phases (about a minute).

    python3 chip_smoke.py --mesh-devices

builds the kernels and runs only phase ``mesh_devices``: on a machine
with two cards or more, the tp = 2 register across two cards and the
tp = 1 route with its dp chunks on both, each bit-equal to one card.

    python3 chip_smoke.py --crossover

builds the kernels and only times K3 against the LM loop with K4 at the
padded shapes ``Optimizer`` sends (the measurement behind
``optim.pgo.K3_MAX_SIZE``, about four minutes).

    python3 chip_smoke.py --k3-clusters

times K3 at phase k3's shapes at fixed cluster sizes and placements,
with 64 and with 1 CG step per LM iteration (about a minute).

    python3 chip_smoke.py --k2-layouts

times K2 at phase k2's verification shape, at the headline batch and at
its first 16 entries at fixed layouts (cluster size C, map slices S),
each against the layout ``k2_layout`` chooses, whose bits every one must
give (about a minute).

    python3 chip_smoke.py --replay-witness

runs the loop, grid and long replays on the card with K1 and K3, with
either or both replaced by its plain version, and on the machine's CPU;
prints where each run departs from its fixture and from the CPU run, and
K3 against the plain LM at every optimize of the card run; writes the
per-scan poses and compositions to ``chiprun_out/witness_*.npz`` (about
three minutes).

    python3 chip_smoke.py --k1-layouts

times K1 at phase k1's shapes at fixed layouts (slices S, threads a CTA
T, one query a thread; S = 1, T = 128 is the design before the slices),
each against the layout ``k1_layout`` chooses, whose bits
every one must give, and against the plain version.

    python3 chip_smoke.py --k4-layouts

times K4 at phase k4's cases and at the padded buckets of 128, 256 and
512 poses at fixed layouts (CTAs, cluster sizes 1-16,
the cluster and the cooperative grid barrier, the global placement),
each against the layout ``k4_layout`` chooses, whose bits every one must
give, by device time in two passes (about a minute).

    python3 chip_smoke.py --k4-tree DIR

imports ``pgslam_tpu_torch`` from the checkout at DIR (built there at
first use) and only times its K4 at phase k4's cases, called without a
plan; two checkouts are compared by running it for each in turns in one
call on one card.
"""

import collections
import contextlib
import json
import logging
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
# The deferred path. The streaming batch (micro_batch) and the lag of
# BASELINE config 4's live loop (examples/velodyne_slam.py:29-78).
STREAM_BATCH = 4
LIVE_LAG = 2
# force_deferred at lag 0 is held to the classic replay within the gap
# between two classic replays in the same process, plus this (m): the
# card's classic replay need not repeat its bits (index_add_ and scatter
# sum with atomics there).
DEFERRED0_SLACK_M = 1e-6
# tests/test_golden_replay.py:232-266's streaming envelopes against
# truth: the flushed final pose, and each scan against the nearest truth
# pose of its trailing window of micro_batch scans, below max(floor,
# factor x) the golden fixture's own error.
STREAM_FINAL_TRUTH_M = 0.15
STREAM_TRUTH_FLOOR_M, STREAM_TRUTH_FACTOR = 0.5, 2.5
# The 64k corridor at lag 2: each scan's error to the lag-shifted truth
# below max(floor, factor x) the lag-0 fixture's own
# (tests/test_golden_replay.py:311-318's lag-2 envelope).
LAG2_TRUTH_FLOOR_M, LAG2_TRUTH_FACTOR = 0.30, 2.0
# The loop replay's K1 shape (queries, references, k): its reading of 512
# points against the local map of three 512-point keyframes; every K1
# launch of the replay has it (knn.shapes; 907 launches on an H100).
K1_LOOP_SHAPE = (512, 1536, 1)
# Each path's most-launched K1 shapes that the smoke reads after it; every
# one must be among phase k1's shapes, which are checked and timed.
K1_TOP_SHAPES = 3
# The config-and-persistence path. The long replay (300 scans, three
# closures) is held to the fixture's decisions where it shares them: the
# same keyframe, closure and optimize counts, and every scan up to its
# first local-map composition that differs from the JAX run's within
# POSE_TOL_M. The fixture decides at knife edges (at scan 90 a keyframe
# spawns at an overlap of 409 inliers of 512 against a threshold of
# 409.6), so a run on other arithmetic may take the other branch there,
# K1 and K3 or no (PERF.md, section 6). Over the whole run it is held to
# the CPU test's other limits (tests/test_torch_long_replay.py): each
# scan's error to the truth below max(LONG_TRUTH_FLOOR_M,
# LONG_TRUTH_FACTOR x) the fixture's (pgslam_tpu's own envelope for its
# non-bitwise paths on this fixture, tests/test_golden_replay.py:357-374),
# the ATE no worse than the fixture's plus LONG_ATE_SLACK_M, the final
# pose within POSE_TOL_M of the fixture's.
LONG_TRUTH_FLOOR_M, LONG_TRUTH_FACTOR = 0.8, 1.5
LONG_ATE_SLACK_M = 0.05
LONG_COUNTS = {"n_keyframes": 50, "n_loops": 3, "opt_runs": 3}
# A replay run departs from another at the first scan more than this
# apart (phase_replay_witness).
WITNESS_TOL_M = 1e-4
# replay_grid prints this many scans whose ICP iterations differ from the
# JAX run's (scan:card/JAX).
ICP_STOPS_SHOWN = 4
# The point-to-plane replay draws RandomSampling's keep masks from torch
# generators, not Threefry, so it is held to the truth: its largest
# per-scan error below the JAX package's run's (golden_replay_p2plane.npz)
# plus P2PLANE_TRUTH_MARGIN_M, and a keyframe count within
# P2PLANE_KEYFRAME_WINDOW of that run's; both set before the first card
# run from the JAX run and two CPU runs of the port under other seeds
# (PERF.md, section 6).
P2PLANE_TRUTH_MARGIN_M = 1.0
P2PLANE_KEYFRAME_WINDOW = 3
# The resumed loop: a checkpoint after scan RESUME_AT - 1.
RESUME_AT = 35
# The single-scan K2 route (PGSLAM_FUSED_SINGLE). The loop with the route
# on is held to FUSED1_LOOP_TOL_M of golden_replay.npz, set before the
# first card run (PERF.md, section 6) at 1.5 times the largest of
# the JAX package's own fused route on the loop (0.10389 m), the route on
# the CPU (0.04999 m) and 16 CPU runs with the odometry moved by 1e-6 m
# (up to 0.12967 m); the corridor keeps POSE_TOL_M.
FUSED1_LOOP_TOL_M = 0.20
# The native phase: the loop's scans streamed through ScanLoader from
# this many KITTI files.
NATIVE_SCANS = 70
# The resident mirror's phases. resident_growth: a ring like pgo_1k's,
# RESIDENT_GROWTH_START keyframes, RESIDENT_GROWTH_APPEND more before each
# later optimize, RESIDENT_GROWTH_LOOPS loop constraints queued per
# optimize, one host pose write before optimize RESIDENT_DIRTY_AT.
RESIDENT_GROWTH_START = 512
RESIDENT_GROWTH_CALLS = 16
RESIDENT_GROWTH_APPEND = 32
RESIDENT_GROWTH_LOOPS = 2
RESIDENT_DIRTY_AT = 8
# resident_16k's writeback (quat7) against the classic path's poses, on
# top of the limits the K4 loop is held to against itself (its index_add_
# sums use atomics, so its runs differ; PGO_LIMITS for pgo_16k and
# K3_ROT_TOL): quat7's round-off. On the CPU its round trip of pgo_16k's
# poses moved rotations by at most 3.41e-7 rad (4.77e-7 in a matrix
# entry) and translations by nothing.
QUAT7_ROT_TOL = 1e-6      # rotation matrix entries
QUAT7_TRANS_TOL = 0.0
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


def device_ms(fn, kernel: str, reps: int = 3):
    """Mean device milliseconds of a launch of the kernel named
    ``kernel``, from a torch.profiler trace of ``reps`` calls of ``fn``
    (CUDA events around a call also count the wrapper's host work and its
    small kernels before and after)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    total = sum(getattr(e, "device_time_total", 0.0) for e in hits)
    return total / max(1, sum(e.count for e in hits)) / 1e3


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
    # The native core (host g++) builds here, not inside the first timed
    # replay's first Dijkstra.
    from pgslam_tpu_torch import native
    t0 = time.perf_counter()
    if not native.native_available():
        raise AssertionError("the native core did not build or load")
    line("native_build", seconds=round(time.perf_counter() - t0, 3),
         library=os.path.basename(native.library_path()))
    from pgslam_tpu_torch.ops.icp_fused import device_limits
    budget, active = device_limits(torch.cuda.current_device())
    line("k2_limits", cta_smem_bytes=budget, clusters_held_at_once=",".join(
        f"C{c}:{n}" for c, n in active.items()))
    return smi


def k1_cases(scans):
    """Phase k1's shapes (name, query, reference, k, reps): the 64k
    profile's scan-to-map match (2048 x 8192), its coarse stage (every
    8th of those 2048 points, coarse_div 8), its normals (8192 x 8192,
    k = 8) and a whole scan against a whole scan, from the corridor's
    scans 0 and 1; the loop replay's one shape (K1_LOOP_SHAPE), scan
    3 of its sequence against the map of scans 0-2, in the world frame;
    and the YAML replays' shapes on the 2048-point clover (a scan's
    keyframe capacity of 1024 points against the local map of three
    keyframes; that map's normals at k = 10, the point-to-plane YAML's
    SurfaceNormal, and at k = 16, K1's largest k); and the mesh path's
    shard shapes: a 512-point reading against one of the two shards of a
    1536-point map (the mesh fleet, tp = 2) and one of its eight (the
    loop at tp = 8), and the dry run's 64 points against one of its two
    128-point shards, from the loop's scans."""
    from pgslam_tpu_torch.replays import (loop_sequence_golden,
                                          yaml_clover_sequence)
    s0, s1 = scans[0], scans[1]
    loop, _, truth = loop_sequence_golden()
    world = [(c @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
             for c, T in zip(loop[:4], truth[:4])]
    nq, nr, k = K1_LOOP_SHAPE
    clover, _, ctruth = yaml_clover_sequence()
    cworld = [(c[:1024] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
              for c, T in zip(clover[:4], ctruth[:4])]
    cmap = np.concatenate(cworld[:3])
    return [("2048x8192_k1", s1[:2048], s0[:8192], 1, 20),
            ("256x8192_k1_coarse", s1[:2048][::8], s0[:8192], 1, 20),
            ("8192x8192_k8", s0[:8192], s0[:8192], 8, 10),
            ("65536x65536_k1", s1, s0, 1, 3),
            ("512x1536_k1_loop", world[3][:nq], np.concatenate(world[:3])[:nr],
             k, 50),
            ("1024x3072_k1_yaml", cworld[3], cmap, 1, 50),
            ("3072x3072_k10_normals", cmap, cmap, 10, 20),
            ("3072x3072_k16", cmap, cmap, 16, 20),
            ("512x768_k1_mesh_fleet", world[3][:512],
             np.concatenate(world[:3])[:768], 1, 50),
            ("512x192_k1_mesh_loop", world[3][:512],
             np.concatenate(world[:3])[:192], 1, 50),
            ("64x128_k1_mesh_dryrun", world[3][:64],
             np.concatenate(world[:3])[:128], 1, 50)]


def k1_inputs(dev, q, r):
    """Phase k1's tensors: every query, and the references but their last
    sixteenth, unmasked."""
    import torch
    qt = torch.as_tensor(q, device=dev)
    rt = torch.as_tensor(r, device=dev)
    qm = torch.ones(len(q), dtype=torch.bool, device=dev)
    rm = torch.ones(len(r), dtype=torch.bool, device=dev)
    rm[-len(r) // 16:] = False           # masked references too
    return qt, qm, rt, rm


def k1_check(name, mk, mp):
    """K1's result against the plain version's: ids equal, the same finite
    pattern, d2 within K1_D2_RTOL of its scale. Returns the d2 error."""
    import torch
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
    return err


def k1_layout_name(lay) -> str:
    """A K1Layout as S (slices) x T (threads)."""
    return f"S{lay.slices}xT{lay.threads}"


def k1_timed(fn, reps):
    """(CUDA-event ms, device ms of the kernel from the profiler, result)
    of a K1 call. A trace that caught no launch of the kernel (seen on an
    H100 for single microsecond-long launches) is taken again, up to
    three times; after that the device time is None, not a measurement."""
    ms, out = timed(fn, reps)
    for _ in range(3):
        dms = device_ms(fn, "knn_kernel", max(3, reps // 2))
        if dms > 0:
            return ms, dms, out
    return ms, None, out


def r4(v):
    """``v`` rounded to 4 places, None (not measured) kept."""
    return None if v is None else round(v, 4)


def cdist_topk(q, r, k):
    """The two-call yardstick beside K1: ``torch.cdist`` and the k least
    (``argmin`` for k = 1). It ignores the masks, and the port never
    calls it."""
    import torch
    d = torch.cdist(q, r)
    return d.argmin(dim=1) if k == 1 else d.topk(k, dim=1, largest=False)


def phase_k1(dev, scans):
    """K1 at each of :func:`k1_cases`'s shapes, at the layout k1_layout
    chooses and at the one-slice layout of one query a thread (the design
    before the slices), each against the plain version, with CUDA-event
    and device times, the plain version's time, cdist + topk's and the
    bound."""
    import torch
    from pgslam_tpu_torch.ops.knn import k1_layout, knn, knn_plain
    worst = 0.0
    times = {}
    for name, q, r, k, reps in k1_cases(scans):
        qt, qm, rt, rm = k1_inputs(dev, q, r)
        n, m = len(q), len(r)
        pms, mp = timed(lambda: knn_plain(qt, qm, rt, rm, k=k),
                        max(1, reps // 4))
        ms, dms, mk = k1_timed(lambda: knn(qt, qm, rt, rm, k=k), reps)
        lay = knn.layout
        err = k1_check(name, mk, mp)
        base = k1_layout(n, m, k, 1, slices=1, threads=128)
        bms, bdms, mb = k1_timed(lambda: knn(qt, qm, rt, rm, k=k,
                                             layout=base), reps)
        err = max(err, k1_check(f"{name} at {k1_layout_name(base)}", mb, mp))
        cms, _ = timed(lambda: cdist_topk(qt, rt, k), max(1, reps // 4))
        torch.cuda.empty_cache()
        worst = max(worst, err)
        bnd = bound(13 * n + 13 * m + 8 * n * k, PAIR_FLOPS * n * m)
        times[name] = dict(shape=(n, m, k), ms=ms, device_ms=dms,
                           plain_ms=pms, bound=bnd,
                           layout=k1_layout_name(lay), s1_ms=bms,
                           s1_device_ms=bdms, cdist_topk_ms=cms)
        line("k1", shape=name, layout=k1_layout_name(lay),
             ctas=lay.ctas(n), ids_equal=True, max_abs_err=err,
             ms=round(ms, 4), device_ms=r4(dms),
             s1_layout=k1_layout_name(base), s1_ms=round(bms, 4),
             s1_device_ms=r4(bdms), plain_ms=round(pms, 4),
             cdist_topk_ms=round(cms, 4), bound_ms=round(bnd[0], 5),
             bound_by=bnd[1])
    return worst, times


K1_LAYOUTS = [(S, T) for S in (1, 2, 4, 8, 16) for T in (128, 32)]


def phase_k1_layouts(dev, scans):
    """K1 at each of :func:`k1_cases`'s shapes at fixed layouts (S, T),
    S = 1, T = 128 (the design before the slices) among them, each
    against the layout k1_layout chooses, whose bits every one must give,
    and against the plain version; CUDA-event and device times."""
    import torch
    from pgslam_tpu_torch.ops.knn import k1_layout, knn, knn_plain
    for name, q, r, k, reps in k1_cases(scans):
        qt, qm, rt, rm = k1_inputs(dev, q, r)
        n, m = len(q), len(r)
        mp = knn_plain(qt, qm, rt, rm, k=k)
        ms, dms, want = k1_timed(lambda: knn(qt, qm, rt, rm, k=k), reps)
        chosen = knn.layout
        k1_check(name, want, mp)
        line("k1_layouts", shape=name, layout=k1_layout_name(chosen),
             chosen=True, ctas=chosen.ctas(n), ms=round(ms, 4),
             device_ms=r4(dms))
        for S, T in K1_LAYOUTS:
            lay = k1_layout(n, m, k, 1, slices=S, threads=T)
            if lay == chosen:
                continue
            ms, dms, got = k1_timed(lambda: knn(qt, qm, rt, rm, k=k,
                                                layout=lay), reps)
            equal = torch.equal(got.ids, want.ids) and torch.equal(
                got.dists2, want.dists2)
            line("k1_layouts", shape=name, layout=k1_layout_name(lay),
                 chosen=False, ctas=lay.ctas(n), ms=round(ms, 4),
                 device_ms=r4(dms), bits_equal=equal)
            if not equal:
                raise AssertionError(f"K1 at {name} with layout {lay} "
                                     "gives other bits")
            k1_check(f"{name} at {k1_layout_name(lay)}", got, mp)


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


def k2_bound(B: int, n: int, m: int, iterations: int):
    """K2's least time for ``B`` registrations of ``n`` reading points
    against ``m`` map points that ran ``iterations`` fine iterations in
    all: each fine iteration and each entry's final pass an n x m search
    (the coarse stage's count is not reported, so it is left out and the
    bound stays a lower bound); every input read once, every output row
    written once."""
    pairs = n * m * (iterations + B)
    return bound(B * (13 * n + 25 * m + 4 * (16 + 56)), PAIR_FLOPS * pairs)


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
    layout = fused_icp_register.layout
    dms = device_ms(lambda: fused_icp_register(rd, rf, T0, cfg),
                    "icp_fused_kernel")
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
    bnd = k2_bound(B, n, m, int(res.iterations.to(torch.int64).sum()))
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
         **extra, layout=layout_name(layout), ms=round(ms, 4),
         device_ms=round(dms, 4), plain_ms=round(pms, 4),
         bound_ms=round(bnd[0], 5), bound_by=bnd[1])
    if not (n_matched == B and b1_equal == B):
        bad = (~matched).nonzero().flatten().tolist()
        raise AssertionError(
            f"K2 {label} {info} disagrees with its plain version: "
            f"{n_within} of {B} entries within the limits, {n_matched} "
            f"with a control start's (unmatched: {bad}), {b1_equal} of {B} "
            f"equal to their B = 1 launch, T err {err}, iteration gap "
            f"{it_gap} (limit {slack})")
    return err, ms, pms, bnd, res, plain, layout, dms


def layout_name(layout) -> str:
    """A K2Layout's cluster size C and map slices S, for the log."""
    return f"C{layout.clusters}xS{layout.slices}"


def verification_inputs(dev, seq):
    """A loop-closure verification as the 64k profile runs it: scan 1
    against the 3-keyframe map of scans 0-2 in scan 1's frame, from an
    odometry-like guess. Returns (cfg, reading, reference, T0)."""
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
    return cfg, rd, rf, T0


def phase_k2(dev, seq):
    """The verification of :func:`verification_inputs`, then the same
    registration with Anderson acceleration, windows 2 to 4."""
    import dataclasses
    cfg, rd, rf, T0 = verification_inputs(dev, seq)
    out = k2_compare(dev, "k2", rd, rf, T0, cfg, 5, 2, error=cfg.error,
                     coarse_div=cfg.coarse_div, anderson_m=0)
    aa_err = 0.0
    for m in (2, 3, 4):
        aa = k2_compare(dev, "k2", rd, rf, T0,
                        dataclasses.replace(cfg, anderson_m=m), 3, 1,
                        error=cfg.error, coarse_div=cfg.coarse_div,
                        anderson_m=m)
        aa_err = max(aa_err, aa[0])
    return out[:4] + out[6:8], aa_err


def stream_inputs(dev):
    """The streaming path's K2 batch (``micro_batch=4``) on the golden
    loop: scans 3-6 (512 points) against four copies of one local map,
    scans 0-2 in scan 2's frame (1536 points), from odometry guesses,
    under the loop's point-to-point config. The copies are materialized,
    as ``localizer.prepare_register_stream`` does. Returns (cfg, readings,
    references, T0)."""
    import torch
    from pgslam_tpu_torch.cloud import make_cloud, stack_clouds
    from pgslam_tpu_torch.replays import loop_config, loop_sequence_golden
    cfg = loop_config()
    cap = cfg.localizer.keyframe_cloud_capacity
    scans, odom, _ = loop_sequence_golden()
    inv = np.linalg.inv(np.asarray(odom[2], np.float64))
    rel = [inv @ np.asarray(o, np.float64) for o in odom[:7]]
    local = np.concatenate([s @ T[:3, :3].T + T[:3, 3]
                            for s, T in zip(scans[:3], rel[:3])])
    ref = make_cloud(local.astype(np.float32), capacity=3 * cap, device=dev)
    B = STREAM_BATCH
    rf = ref.map(lambda a: a[None].expand(B, *a.shape).contiguous())
    rd = stack_clouds([make_cloud(scans[3 + j], capacity=cap, device=dev)
                       for j in range(B)])
    T0 = torch.as_tensor(np.stack(rel[3:3 + B]).astype(np.float32),
                         device=dev)
    return cfg.localizer.icp, rd, rf, T0


def phase_k2_stream(dev):
    """K2 at the streaming shape: every entry bit-equal to its own B = 1
    launch and within phase k2's limits of the plain version."""
    cfg, rd, rf, T0 = stream_inputs(dev)
    out = k2_compare(dev, "k2_stream", rd, rf, T0, cfg, 5, 2,
                     controls=K2_CONTROLS, error=cfg.error,
                     coarse_div=cfg.coarse_div, anderson_m=0)
    return out[:4] + out[6:8]


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
    # The bound of the batch's first 16 entries, the B = 16 case
    # ``--k2-layouts`` times.
    b16 = k2_bound(16, packets[0].shape[1], refs.points.shape[1],
                   int(out[4].iterations[:16].sum()))
    return out[:4] + out[6:8] + (b16,)


K2_LAYOUTS = ((1, 1), (1, 4), (2, 8), (4, 4), (8, 2), (8, 16), (16, 4),
              (16, 16))


def phase_k2_layouts(dev, seq):
    """K2 at the verification shape (B = 1), the headline batch (B = 128)
    and its first 16 entries (the fleet's batch) at fixed layouts (C, S):
    five CUDA-event runs each after a warm-up and the kernel's device time
    from the profiler, every one bit for bit the result of the layout
    ``k2_layout`` chooses; then, at the chosen layout, the device time of
    one fine iteration against the whole map and against 256 of its
    points."""
    import dataclasses

    import torch
    from pgslam_tpu_torch.ops.icp_fused import fused_icp_register, k2_layout
    cfg, rd, rf, T0 = verification_inputs(dev, seq)
    hcfg, refs, packets, _ = headline_setup(dev)
    B = refs.points.shape[0]
    hrd = packet_cloud(dev, packets[0])
    hT0 = torch.eye(4, device=dev).expand(B, 4, 4).contiguous()
    first16 = lambda c: c.map(lambda a: a[:16].contiguous())
    shapes = (("verification_1x2048x8192", cfg, rd, rf, T0),
              ("headline_128x1024x8192", hcfg, hrd, refs, hT0),
              ("headline_16x1024x8192", hcfg, first16(hrd), first16(refs),
               hT0[:16].contiguous()))
    fields = ("T", "iterations", "converged", "overlap", "residual", "cov")
    for name, c, a, b, t in shapes:
        ms, want = timed(lambda: fused_icp_register(a, b, t, c), 5)
        chosen = fused_icp_register.layout
        dms = device_ms(lambda: fused_icp_register(a, b, t, c),
                        "icp_fused_kernel")
        line("k2_layouts", shape=name, layout=layout_name(chosen),
             chosen=True, ms=round(ms, 4), device_ms=round(dms, 4))
        nq, nr = a.points.shape[1], b.points.shape[1]
        for C, S in K2_LAYOUTS:
            if (C, S) == (chosen.clusters, chosen.slices):
                continue
            try:
                lay = k2_layout(nq, nr, a.points.shape[0], clusters=C,
                                slices=S)
            except ValueError as e:
                line("k2_layouts", shape=name, layout=f"C{C}xS{S}",
                     skipped=str(e).replace(" ", "_"))
                continue
            ms, got = timed(lambda: fused_icp_register(a, b, t, c,
                                                       layout=lay), 5)
            dms = device_ms(lambda: fused_icp_register(a, b, t, c,
                                                       layout=lay),
                            "icp_fused_kernel")
            equal = all(torch.equal(getattr(got, f), getattr(want, f))
                        for f in fields)
            line("k2_layouts", shape=name, layout=layout_name(lay),
                 chosen=False, ms=round(ms, 4), device_ms=round(dms, 4),
                 bits_equal=equal)
            if not equal:
                raise AssertionError(f"K2 at {name} with layout {lay} "
                                     "gives other bits")
        # Where a registration's time goes at the chosen layout: device
        # time of 1 and 9 fine iterations (no coarse stage, no early stop)
        # gives the time of one fine iteration and its pair rate; against
        # the first 256 map points, an iteration's cost besides matching.
        nq, nr = a.points.shape[1], b.points.shape[1]
        B1 = a.points.shape[0]
        for label, ref in (("", b), ("_map256", b.map(
                lambda v: v[:, :256].contiguous()))):
            per = {}
            for its in (1, 9):
                cc = dataclasses.replace(c, max_iterations=its, coarse_div=0,
                                         trans_eps=0.0, rot_eps=0.0,
                                         anderson_m=0)
                f = lambda: fused_icp_register(a, ref, t, cc)
                f()
                per[its] = device_ms(f, "icp_fused_kernel", 5)
            us = 1e3 * (per[9] - per[1]) / 8
            pairs = B1 * nq * ref.points.shape[1]
            line("k2_iteration", shape=name + label,
                 layout=layout_name(fused_icp_register.layout),
                 us_per_fine_iteration=round(us, 2),
                 g_pairs_per_s=round(pairs / us / 1e3, 2),
                 g_pairs_per_s_per_cta=round(
                     pairs / us / 1e3 / (B1 * fused_icp_register.layout
                                         .clusters), 3))


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


def drive_fleet(dev, seq, n_steps, split=None, mesh=None):
    """BASELINE config 5: 16 agents over one shared pose graph
    (``scripts/bench_configs.py:286-334``), agent b on scan i + b % 3 of
    the 72-scan corridor, through ``MultiAgentSlam.add_data_batch``, with
    a sync after each step. With ``split`` (a FleetTimer) the fleet's
    stages are timed too; with ``mesh`` the fleet registers over it.
    Returns (fleet, ms per step, largest error to truth over the steps,
    each agent's final error)."""
    import torch
    from pgslam_tpu_torch import fleet_problems as FP
    from pgslam_tpu_torch.parallel import multi_agent
    scans, odom, truth = seq
    B = 16
    fleet = multi_agent.MultiAgentSlam(FP.fleet_config(), n_agents=B,
                                       device=dev, mesh=mesh)
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
    and each agent's error to truth. Returns (ms per step, the agents'
    final poses, vertices)."""
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
    return total_ms / n_steps, fleet.poses(), fleet.get_graph().n_vertices


def phase_fleet_split(dev, seq, n_steps=FLEET_STEPS):
    """The fleet run again with each stage between two syncs: where its
    step time goes. The syncs are this run's own, so its step time is
    reported apart from the fleet's. Also K2's bound at the fleet's
    launches (registrations and verifications, B = 16), from each
    launch's shape and iterations: returns (mean bound ms a launch, what
    bounds it, launches)."""
    from pgslam_tpu_torch.parallel import batched
    split = FleetTimer()
    k2 = batched.fused_icp_register
    bounds = []

    def recorded(rd, rf, T0, cfg, *a, **k):
        res = k2(rd, rf, T0, cfg, *a, **k)
        B, n = rd.points.shape[:2]
        bounds.append(k2_bound(B, n, rf.points.shape[1],
                               int(res.iterations.sum())))
        return res

    batched.fused_icp_register = recorded
    try:
        _, step_ms, _, _ = drive_fleet(dev, seq, n_steps, split)
    finally:
        batched.fused_icp_register = k2
    total_ms = float(np.sum(step_ms))
    b16 = (float(np.mean([b[0] for b in bounds])), bounds[0][1]) \
        if bounds else (None, None)
    line("fleet_split", steps=n_steps,
         instrumented_ms_per_step=round(total_ms / n_steps, 3),
         **{f"{k}_ms_per_step": round(v / n_steps, 3)
            for k, v in split.ms.items()},
         other_ms_per_step=round((total_ms - sum(split.ms.values()))
                                 / n_steps, 3),
         k2_launches=len(bounds), k2_bound_ms_per_launch=b16[0],
         k2_bound_by=b16[1])
    return b16[0], b16[1], len(bounds)


def fleet_of_one(dev, fused, odom_noise=0.0, seed=0, mesh=None):
    """The fleet at B = 1 with synchronous closures on the golden loop,
    registering by ``fused`` (MultiAgentSlam's route), or over ``mesh``,
    with the odometry moved by ``odom_noise`` m (normal, from ``seed``).
    Returns (per-scan poses, loop edges, keyframes, wall s)."""
    from pgslam_tpu_torch import replays
    from pgslam_tpu_torch.graph.pose_graph import LOOP_CONSTRAINT
    from pgslam_tpu_torch.parallel.multi_agent import MultiAgentSlam
    scans, odom, _ = replays.loop_sequence_golden()
    rng = np.random.default_rng(seed)
    fleet = MultiAgentSlam(replays.loop_config(), n_agents=1, device=dev,
                           fused=fused, mesh=mesh)
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
    """K3 as the main paths run it, each shape launched three times (the
    three must give the same bits) and timed after a warm-up: the 500-pose
    loop under the 64k profile's ``PGOConfig`` (the default: 50 LM
    iterations, 64 PCG steps, cg_tol 1e-4) against its plain version at
    the K3 limits, and ``pgo_1k`` under the default ``PGOConfig`` against
    its plain version at phase pgo's limits. Returns, per shape, (max abs
    err, ms, plain ms, bound, cluster layout)."""
    import torch
    from pgslam_tpu_torch.optim.lm import lm_optimize
    from pgslam_tpu_torch.optim.pgo import PGOConfig, lm_optimize_plain
    from pgslam_tpu_torch.pgo_problems import named_problem
    from pgslam_tpu_torch.replays import velodyne_config
    loop_args, true = loop_500(dev)
    shapes = (("500_poses_500_edges", loop_args,
               velodyne_config().optimizer.pgo),
              ("pgo_1k_default", named_problem("pgo_1k", device=dev)[0],
               PGOConfig()))
    out = {}
    for name, args, cfg in shapes:
        ms, _ = timed(lambda: lm_optimize(*args, config=cfg), 5)
        runs = [lm_optimize(*args, config=cfg) for _ in range(3)]
        layout = lm_optimize.layout
        pms, (pp, sp) = timed(lambda: lm_optimize_plain(*args, config=cfg), 1)
        torch.cuda.synchronize()
        pk, sk = runs[0]
        repeats = all(torch.equal(pk, p) and all(
            torch.equal(sk[k], s[k]) for k in sk) for p, s in runs[1:])
        err = float((pk[:, :3, 3] - pp[:, :3, 3]).norm(dim=1).max())
        rot_err = float((pk[:, :3, :3] - pp[:, :3, :3]).abs().max())
        costs = {k: (float(sk[k]), float(sp[k]))
                 for k in ("initial_cost", "final_cost")}
        cost_err = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in costs.values())
        it_k, it_p = int(sk["iterations"]), int(sp["iterations"])
        V, E = args[0].shape[0], args[2].shape[0]
        bnd = lm_bound(V, E, it_k, int(sp["cg_steps"]))
        if name == "500_poses_500_edges":
            closure = float(np.linalg.norm(pk[-1, :3, 3].cpu().numpy()
                                           - true[-1, :3, 3]))
            ok = (err <= K3_POSE_TOL_M and rot_err <= K3_ROT_TOL
                  and cost_err <= K3_COST_RTOL and it_k == it_p
                  and closure < K3_CLOSURE_GATE_M)
        else:
            closure = None
            pose_tol, cost_rtol = PGO_LIMITS[("pgo_1k", "default")]
            gap, rot, _, cost_ok = _pgo_gaps(pk, sk, pp, sp, cost_rtol)
            ok = gap <= pose_tol and rot <= K3_ROT_TOL and cost_ok
        line("k3", shape=name, V=V, E=E, clusters=layout.clusters,
             in_smem=layout.in_smem, smem_bytes=layout.smem_bytes,
             iterations=it_k, plain_iterations=it_p,
             plain_cg_steps=int(sp["cg_steps"]),
             final_cost=costs["final_cost"][0],
             plain_final_cost=costs["final_cost"][1], cost_rel_err=cost_err,
             closure_err_m=closure, rot_err=rot_err, max_abs_err=err,
             repeats_bitwise=repeats, ms=round(ms, 4),
             plain_ms=round(pms, 4), bound_ms=round(bnd[0], 5),
             bound_by=bnd[1])
        if not (ok and repeats and layout.clusters > 1):
            raise AssertionError(
                f"K3 {name} disagrees with its plain version or itself: "
                f"pose gap {err} m, rotation err {rot_err}, cost rel err "
                f"{cost_err}, iterations {it_k} vs {it_p}, closure "
                f"{closure} m, repeats {repeats}, clusters "
                f"{layout.clusters}")
        out[name] = (err, ms, pms, bnd, layout)
    return out


def lm_bound(V: int, E: int, lm_iterations: int, cg_steps: int):
    """K3's least time: its inputs (poses, masks, endpoints, measurements,
    covariances) read once and the poses written once; the operations of
    its LM iterations and of the CG steps (taken from the plain version,
    which K3 does not report)."""
    nbytes = 64 * V + V + E * (8 + 64 + 144 + 2) + 64 * V + 16
    flops = (lm_iterations * (LM_EDGE_FLOPS * E + LM_VERTEX_FLOPS * V)
             + cg_steps * (CG_EDGE_FLOPS * E + CG_VERTEX_FLOPS * V))
    return bound(nbytes, flops)


K4_CASES = ("pgo_1k", "pgo_16k", "loop_64", "pgo_16k_padded")
# Padded graphs, (poses, loop edges) padded as Optimizer pads them.
# loop_64 is the graph of the loop replay's optimize (20 keyframes, 19
# odometry edges and one loop edge; 64 poses, 64 edges), the shape the
# replay under pcg_pallas launches K4 at; pgo_16k_padded is pgo_16k as
# Optimizer sends it (20479 edges padded to 32768), the shape of phase
# resident_16k; the others are the next buckets of a growing map (4, 8
# and 16 vertex tiles), which --k4-layouts also times.
K4_PADDED = {"loop_64": (20, 1), "padded_128": (100, 10),
             "padded_256": (200, 20), "padded_512": (400, 40),
             "pgo_16k_padded": (16384, 4096)}
# The two systems phase k4 times K4 at: one LM step's system at the
# initial poses under the default PGOConfig (cg_tol 1e-4, 4-6 steps), and
# the same system run to exactly cg_iterations = 64 steps (cg_tol 0), the
# per-step time the LM loop's launches pay (15.4 steps a launch on
# average at pgo_16k under the default config).
K4_SYSTEMS = (("initial", 1e-4), ("64_steps", 0.0))


def k4_system(dev, name):
    """(system arguments of pcg_solve, the graph's args) of one LM step at
    the initial poses of ``name`` (one of :data:`K4_CASES`) under the
    default ``PGOConfig``."""
    import torch
    from pgslam_tpu_torch.optim import pgo
    from pgslam_tpu_torch.pgo_problems import bucketed_problem, named_problem
    if name in K4_PADDED:
        args, _ = bucketed_problem(*K4_PADDED[name], device=dev)
    else:
        args, _ = named_problem(name, device=dev)
    cfg = pgo.PGOConfig()
    prob = pgo.LMProblem(*args, config=cfg)
    blocks, b, D = prob.system(args[0])
    lam = torch.tensor(cfg.lambda_init, device=dev)
    P_inv, damp = pgo.block_jacobi(D, lam, args[1])
    return (blocks, P_inv, damp, b, prob.prior_info, prob.fixed, prob.ef,
            prob.et), args


def k4_bound(V: int, E: int, steps: int):
    """K4's least time: the three block tensors, P_inv, damping, b and the
    CSR order read once, x written once; the operations of the steps the
    solve took and of its start."""
    nbytes = 3 * 144 * E + V * (144 + 24 + 24) + 4 * (V + 1 + 2 * E) \
        + 24 * V
    return bound(nbytes, steps * (CG_EDGE_FLOPS * E + CG_VERTEX_FLOPS * V)
                 + 96 * V)


def k4_timed(fn, reps):
    """(CUDA-event ms, device ms of the kernel from the profiler, result)
    of a K4 call, the device trace retaken as :func:`k1_timed` does."""
    ms, out = timed(fn, reps)
    for _ in range(3):
        dms = device_ms(fn, "pcg_kernel", reps)
        if dms > 0:
            return ms, dms, out
    return ms, None, out


def k4_layout_name(lay) -> str:
    """A K4Layout as CTAs x cluster, barrier and placement."""
    return (f"G{lay.ctas}xC{lay.cluster}_{lay.barrier}_"
            f"{'smem' if lay.in_smem else 'global'}")


def phase_k4(dev):
    """K4 at the shapes the LM loop launches (:data:`K4_CASES`), at both
    of :data:`K4_SYSTEMS`, at the layout ``k4_layout`` chooses, with its
    plan built once as the loop builds it: against its plain version (x within
    K4_X_RTOL of max|x_plain|, residuals within K4_RESIDUAL_FACTOR *
    sqrt(1e-4), the step counts equal), three launches for the same bits,
    CUDA-event and device times per launch and per CG step (the 64-step
    solve's device time less the initial one's over the steps between),
    the events' excess over the device time, and the bound. Returns
    {(problem, system): dict}."""
    import torch
    from pgslam_tpu_torch.optim import pgo
    from pgslam_tpu_torch.optim.pcg import k4_plan, pcg_solve
    res_tol = K4_RESIDUAL_FACTOR * pgo.PGOConfig().cg_tol ** 0.5
    out = {}
    for name in K4_CASES:
        sysargs, args = k4_system(dev, name)
        blocks, b = sysargs[0], sysargs[3]
        V, E = b.shape[0], blocks[0].shape[0]
        plan = k4_plan(sysargs[6], sysargs[7], V, args[6])
        lay = plan.layout
        for system, tol in K4_SYSTEMS:
            kw = dict(cg_iterations=64, cg_tol=tol, return_iterations=True)
            call = lambda: pcg_solve(*sysargs, plan=plan, **kw)
            ms, dms, (xk, sk) = k4_timed(call, 20)
            runs = [call()[0] for _ in range(3)]
            pms, (xp, sp) = timed(
                lambda: pgo.pcg_solve_plain(*sysargs, **kw), 3)
            torch.cuda.synchronize()
            repeat = all(torch.equal(xk, x) for x in runs)
            err = float((xk - xp).abs().max())
            scale = float(xp.abs().max())

            def rel_residual(x):
                Ax = pgo.system_matvec(blocks, sysargs[2], sysargs[4],
                                       sysargs[5], sysargs[6], sysargs[7], x)
                return float((Ax + b).norm() / b.norm())

            rk, rp = rel_residual(xk), rel_residual(xp)
            steps = int(sk)
            bnd = k4_bound(V, E, steps)
            out[(name, system)] = dict(
                V=V, E=E, steps=steps, ms=ms, device_ms=dms, plain_ms=pms,
                bound=bnd, err=err, layout=lay)
            line("k4", problem=name, system=system, V=V, E=E,
                 layout=k4_layout_name(lay), smem_bytes=lay.smem_bytes,
                 cg_steps=steps, plain_cg_steps=sp, max_abs_err=err,
                 max_abs_plain=scale, rel_residual=rk,
                 plain_rel_residual=rp, repeats_bitwise=repeat,
                 ms=round(ms, 4), device_ms=r4(dms),
                 events_minus_device_ms=(None if dms is None
                                         else round(ms - dms, 4)),
                 device_ms_per_step=(None if dms is None
                                     else round(dms / steps, 5)),
                 plain_ms=round(pms, 4), bound_ms=round(bnd[0], 6),
                 bound_by=bnd[1])
            if not (err <= K4_X_RTOL * scale and rk <= res_tol
                    and rp <= res_tol and repeat and steps == sp
                    and lay.ctas > 1 and lay.in_smem):
                raise AssertionError(
                    f"K4 {name} {system}: err {err} vs {K4_X_RTOL} * "
                    f"{scale}, residuals {rk} / {rp} vs {res_tol}, steps "
                    f"{steps} vs {sp}, repeats {repeat}, layout {lay}")
        first, full = out[(name, "initial")], out[(name, "64_steps")]
        if (first["device_ms"] is not None and full["device_ms"] is not None
                and full["steps"] > first["steps"]):
            per_step = (full["device_ms"] - first["device_ms"]) \
                / (full["steps"] - first["steps"])
            line("k4_step", problem=name, layout=k4_layout_name(lay),
                 device_ms_per_step=round(per_step, 5),
                 device_ms_launch_and_load=round(
                     first["device_ms"] - first["steps"] * per_step, 5))
            full["device_ms_per_step"] = per_step
    return out


# Phase k4's fixed layouts for --k4-layouts: (CTAs, cluster) with each
# barrier (optim.pcg.BARRIERS), per problem; None leaves the value to
# k4_layout (4 CTAs at pgo_1k and 64 at pgo_16k do not fit shared memory
# and run from global scratch). G8xC8 and G88xC8 with the cluster
# barrier were the first defaults of this design, clusters of 2 with the
# grid barrier the second. The global placement is also timed at the
# chosen layout.
K4_FIXED = {"pgo_1k": [(32, 2), (32, 4), (32, 8), (32, 16), (16, 1),
                       (16, 2), (16, 16), (8, 1), (8, 8), (24, 8),
                       (4, None)],
            "pgo_16k": [(132, 2), (120, 4), (120, 8), (112, 16), (112, 8),
                        (96, 8), (88, 8), (66, 2), (64, 4)],
            "loop_64": [(2, 2), (1, 1)],
            "padded_128": [(4, 4), (2, 2)],
            "padded_256": [(8, 8), (4, 4)],
            "padded_512": [(16, 16), (8, 8)]}


def phase_k4_layouts(dev):
    """K4 at the graphs of :data:`K4_FIXED` (phase k4's cases and the
    padded buckets) at fixed layouts (CTAs, cluster size, both
    barriers, the global placement), each checked bit for bit against the
    layout k4_layout chooses and timed by device time over two passes
    (their spread is the runs' spread)."""
    import torch
    from pgslam_tpu_torch.optim.pcg import k4_plan, pcg_solve
    for name in K4_FIXED:
        sysargs, args = k4_system(dev, name)
        V = sysargs[3].shape[0]
        plans = [k4_plan(sysargs[6], sysargs[7], V, args[6])]
        chosen = plans[0].layout
        forced = [dict(barrier="cluster")]
        for g, c in K4_FIXED[name]:
            for barrier in ("cluster", "grid"):
                forced.append(dict(ctas=g, cluster=c, barrier=barrier))
        forced.append(dict(in_smem=False))
        for kw in forced:
            try:
                plan = k4_plan(sysargs[6], sysargs[7], V, args[6], **kw)
            except (RuntimeError, ValueError) as e:
                line("k4_layouts", problem=name, forced=kw,
                     refused=str(e).replace(" ", "_")[:120])
                continue
            if all(plan.layout != p.layout for p in plans):
                plans.append(plan)
        for system, tol in K4_SYSTEMS:
            kw = dict(cg_iterations=64, cg_tol=tol)
            want = pcg_solve(*sysargs, plan=plans[0], **kw)
            times = {}
            for rnd in range(2):
                for i, plan in enumerate(plans):
                    call = lambda: pcg_solve(*sysargs, plan=plan, **kw)
                    _, dms, got = k4_timed(call, 10)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"K4 {name} {system} at {plan.layout} gives "
                            "other bits than the chosen layout")
                    times.setdefault(i, []).append(dms)
            for i, plan in enumerate(plans):
                lay = plan.layout
                line("k4_layouts", problem=name, system=system,
                     layout=k4_layout_name(lay), chosen=i == 0,
                     smem_bytes=lay.smem_bytes, bits_equal=True,
                     device_ms=",".join(str(r4(t)) for t in times[i]))
            best = min(range(len(plans)), key=lambda i: min(
                t for t in times[i] if t is not None))
            line("k4_layouts", problem=name, system=system,
                 chosen=k4_layout_name(chosen),
                 chosen_device_ms=",".join(str(r4(t)) for t in times[0]),
                 fastest=k4_layout_name(plans[best].layout),
                 fastest_device_ms=",".join(str(r4(t))
                                            for t in times[best]))


def phase_k4_tree(dev, tree):
    """K4 of the checkout at ``tree``, whose ``pgslam_tpu_torch`` this
    process imported, at phase k4's cases and systems, called as a user
    calls ``pcg_solve`` (no plan: the wrapper builds what it needs at each
    call): CUDA-event and device ms per launch, and device ms per CG step
    (the 64-step solve's less the initial one's over the steps between).
    Two checkouts are compared by running this for each in turns in one
    call on one card (parent, change, change, parent)."""
    from pgslam_tpu_torch.optim.pcg import pcg_solve
    for name in K4_CASES:
        sysargs, _ = k4_system(dev, name)
        got = {}
        for system, tol in K4_SYSTEMS:
            kw = dict(cg_iterations=64, cg_tol=tol, return_iterations=True)
            ms, dms, (_, steps) = k4_timed(
                lambda: pcg_solve(*sysargs, **kw), 20)
            got[system] = (dms, int(steps))
            line("k4_tree", tree=tree, problem=name, system=system,
                 cg_steps=int(steps), ms=round(ms, 4), device_ms=r4(dms))
        (d0, s0), (d1, s1) = got["initial"], got["64_steps"]
        if d0 is not None and d1 is not None and s1 > s0:
            line("k4_tree_step", tree=tree, problem=name,
                 device_ms_per_step=round((d1 - d0) / (s1 - s0), 5))


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
    for V in (512, 1024, 2048, 4096, 8192, 16384):
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
            layout = lm_optimize.layout
            line("crossover", V=V, E=E, n_vertices=n_vertices,
                 clusters=layout.clusters, in_smem=layout.in_smem,
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


def phase_k3_clusters(dev):
    """What bounds K3: phase k3's two shapes at fixed cluster sizes (in
    shared memory where it fits, and in global scratch), each with 64 and
    with 1 CG step per LM iteration; the difference over the CG steps
    between is the time of one CG step. ``lm.cluster_layout`` is replaced
    for the run by a split at the given size."""
    from pgslam_tpu_torch.optim import lm
    from pgslam_tpu_torch.optim.pgo import PGOConfig
    from pgslam_tpu_torch.pgo_problems import named_problem
    chosen = lm.cluster_layout

    def fixed(C, in_smem):
        def layout(ptr, budget, *_):
            ptr = np.asarray(ptr, dtype=np.int64)
            vstart = lm._split(np.cumsum(4 * lm.VERTEX_WORDS + 4
                                         * lm.SLOT_WORDS * np.diff(ptr)), C)
            NV, NS, nbytes = lm._sizes(ptr, vstart)
            smem = in_smem and nbytes <= budget
            return lm.ClusterLayout(C, smem, tuple(vstart.tolist()), NV, NS,
                                    nbytes if smem else 0, int(ptr[-1]))
        return layout

    shapes = (("500_poses_500_edges", loop_500(dev)[0]),
              ("pgo_1k_default", named_problem("pgo_1k", device=dev)[0]))
    try:
        for name, args in shapes:
            for C in (None, 2, 4, 8, 12, 16):
                for in_smem in (True, False):
                    if C is None and not in_smem:
                        continue
                    lm.cluster_layout = chosen if C is None \
                        else fixed(C, in_smem)
                    ms = {}
                    for cg in (64, 1):
                        cfg = PGOConfig(cg_iterations=cg)
                        ms[cg], _ = timed(
                            lambda: lm.lm_optimize(*args, config=cfg), 3)
                    layout = lm.lm_optimize.layout
                    line("k3_clusters", shape=name, chosen=C is None,
                         clusters=layout.clusters, in_smem=layout.in_smem,
                         ms=round(ms[64], 4), ms_cg_iterations_1=round(ms[1], 4))
    finally:
        lm.cluster_layout = chosen


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


def _sync():
    import torch
    torch.cuda.synchronize()


def _ms_per_scan(per_scan, stats):
    """Wall ms per scan of a replay synchronized once, after its flush."""
    return 1e3 * stats["seconds"] / stats.get("n_scans", len(per_scan))


def _truth_errs(per_scan, truth, lag=0):
    """tests/test_golden_replay.py::_truth_errs: each scan's error to the
    truth pose ``lag`` scans back (the reported pose trails by the commit
    lag); the last, flushed pose against the last truth."""
    t = np.stack(truth)
    idx = np.maximum(np.arange(len(per_scan)) - lag, 0)
    idx[-1] = len(per_scan) - 1
    return np.linalg.norm(per_scan[:, :3, 3] - t[idx, :3, 3], axis=1)


def _counts_line(stats, fix):
    return dict(keyframes=stats["n_keyframes"], loop_edges=stats["n_loops"],
                fixture_keyframes=int(fix["n_keyframes"]),
                fixture_loop_edges=int(fix["n_loop_edges"]))


def phase_loop_lag2(dev):
    """The loop at sync_lag 2 with deferred verification against the JAX
    package's run (golden_replay_lag2.npz): equal counts, every scan
    within POSE_TOL_M."""
    from pgslam_tpu_torch import replays
    per_scan, _, stats = replays.run_replay(
        "loop_lag2", device=dev, sync=_sync, sync_every_scan=False)
    fix = replays.fixture("loop_lag2")
    gap = replays.max_pose_gap(per_scan, fix["per_scan_poses"])
    ms = _ms_per_scan(per_scan, stats)
    line("replay_loop_lag2", scans=len(per_scan), **_counts_line(stats, fix),
         max_gap_m=round(gap, 5), ms_per_scan=round(ms, 3))
    if not (np.isfinite(per_scan).all() and gap <= POSE_TOL_M
            and stats["n_keyframes"] == int(fix["n_keyframes"])
            and stats["n_loops"] == int(fix["n_loop_edges"])):
        raise AssertionError(f"replay_loop_lag2: gap {gap}, {_brief(stats)}")
    return ms


def classic_baselines(dev):
    """The classic (lag-0, unforced) replays the deferred path is compared
    with, run before that path's counters are reset so that its launch
    counts are its own: two loop replays and the 64k corridor
    synchronized once after the flush."""
    from pgslam_tpu_torch import replays
    loops = [replays.run_replay("loop", device=dev) for _ in range(2)]
    corridor = replays.run_replay("corridor_64k", device=dev, sync=_sync,
                                  sync_every_scan=False)
    return loops, corridor


def phase_loop_deferred0(dev, classics):
    """force_deferred at lag 0 against two classic replays in this
    process (``classics``): equal counts, and the deferred replay's gap
    to the nearer classic one within the classics' own gap plus
    DEFERRED0_SLACK_M."""
    from pgslam_tpu_torch import replays
    runs = [*classics, replays.run_replay("loop", device=dev,
                                          force_deferred=True)]
    between = replays.max_pose_gap(runs[0][0], runs[1][0])
    gap = min(replays.max_pose_gap(runs[2][0], r[0]) for r in runs[:2])
    counts = [(r[2]["n_keyframes"], r[2]["n_loops"]) for r in runs]
    line("replay_loop_deferred0", classic_vs_classic_m=between,
         deferred0_vs_classic_m=gap, bit_equal=bool(
             np.array_equal(runs[2][0], runs[0][0])),
         counts=",".join(f"{k}/{n}" for k, n in counts))
    if not (gap <= between + DEFERRED0_SLACK_M
            and len(set(counts)) == 1):
        raise AssertionError(f"replay_loop_deferred0: gap {gap} against "
                             f"{between}, counts {counts}")


def phase_loop_stream4(dev):
    """The loop at micro_batch 4 (K2 at B = 4 on the card) held to the
    JAX package's streaming envelopes against truth; its gap to the JAX
    package's CPU run (golden_replay_stream4.npz) is printed."""
    from pgslam_tpu_torch import replays
    per_scan, _, stats = replays.run_replay(
        "loop_stream4", device=dev, sync=_sync, sync_every_scan=False)
    _, _, truth = replays.loop_sequence_golden()
    t = np.stack(truth)
    gold_te = _truth_errs(replays.fixture("loop")["per_scan_poses"],
                          truth).max()
    te = max(np.linalg.norm(per_scan[i][:3, 3]
                            - t[max(0, i - STREAM_BATCH):i + 1, :3, 3],
                            axis=1).min() for i in range(len(per_scan) - 1))
    final = float(np.linalg.norm(per_scan[-1][:3, 3] - t[-1][:3, 3]))
    fix = replays.fixture("loop_stream4")
    gap = replays.max_pose_gap(per_scan, fix["per_scan_poses"])
    limit = max(STREAM_TRUTH_FLOOR_M, STREAM_TRUTH_FACTOR * gold_te)
    ms = _ms_per_scan(per_scan, stats)
    line("replay_loop_stream4", scans=len(per_scan),
         **_counts_line(stats, fix), truth_err_m=round(float(te), 5),
         truth_limit_m=round(float(limit), 5), final_truth_err_m=round(
             final, 5),
         gap_to_jax_cpu_m=round(gap, 5), ms_per_scan=round(ms, 3))
    if not (np.isfinite(per_scan).all() and stats["n_loops"] >= 1
            and te < limit and final < STREAM_FINAL_TRUTH_M
            and gap <= POSE_TOL_M
            and stats["n_keyframes"] == int(fix["n_keyframes"])
            and stats["n_loops"] == int(fix["n_loop_edges"])):
        raise AssertionError(f"replay_loop_stream4: truth err {te} "
                             f"(limit {limit}), final {final}, gap to the "
                             f"JAX run {gap}, {_brief(stats)}")
    return ms


def phase_corridor_lag2(dev, truth, lag0, ms_synced):
    """BASELINE config 4's live loop: the 64k corridor at sync_lag 2 with
    deferred verification, its flushed final pose within POSE_TOL_M of
    golden_replay_64k.npz's last and each scan's error to the lag-shifted
    truth within the lag-2 envelope; ms per scan beside the lag-0
    replay's (``lag0``, a :func:`classic_baselines` run), both
    synchronized once after the flush (and the lag-0 replay synchronized
    per scan, ``ms_synced``)."""
    from pgslam_tpu_torch import replays
    per_scan, _, stats = replays.run_replay(
        "corridor_64k_lag2", device=dev, sync=_sync, sync_every_scan=False)
    gold = replays.fixture("corridor_64k")["per_scan_poses"]
    final = float(np.linalg.norm(per_scan[-1][:3, 3] - gold[-1][:3, 3]))
    te = _truth_errs(per_scan, truth, lag=LIVE_LAG).max()
    limit = max(LAG2_TRUTH_FLOOR_M,
                LAG2_TRUTH_FACTOR * _truth_errs(gold, truth).max())
    ms0, ms2 = _ms_per_scan(lag0[0], lag0[2]), _ms_per_scan(per_scan, stats)
    line("replay_corridor_64k_lag2", scans=len(per_scan),
         keyframes=stats["n_keyframes"], loop_edges=stats["n_loops"],
         final_gap_m=round(final, 5), truth_err_m=round(float(te), 5),
         truth_limit_m=round(float(limit), 5),
         ms_per_scan_lag2=round(ms2, 3), ms_per_scan_lag0=round(ms0, 3),
         ms_per_scan_lag0_synced_per_scan=round(ms_synced, 3))
    if not (np.isfinite(per_scan).all() and final < POSE_TOL_M
            and te < limit):
        raise AssertionError(f"replay_corridor_64k_lag2: final gap {final}, "
                             f"truth err {te} (limit {limit})")
    return ms0, ms2


def phase_mt_loop(dev):
    """PoseGraphSlamMT on the golden loop: lockstep (idle after every
    scan) within POSE_TOL_M of golden_replay.npz at +-1 scan, then
    free-running (idle once at the end) with its final pose within
    POSE_TOL_M of the fixture's last."""
    from pgslam_tpu_torch import replays
    gold = replays.fixture("loop")
    per_scan, _, stats = replays.run_replay_mt("loop", device=dev, sync=_sync)
    gap = replays.max_pose_gap(per_scan, gold["per_scan_poses"], window=1)
    free, _, fstats = replays.run_replay_mt("loop", device=dev,
                                            lockstep=False, sync=_sync)
    final = float(np.linalg.norm(free[-1][:3, 3]
                                 - gold["per_scan_poses"][-1][:3, 3]))
    ms = _ms_per_scan(free, fstats)
    line("mt_loop", lockstep_max_gap_m=round(gap, 5),
         lockstep_keyframes=stats["n_keyframes"],
         lockstep_loop_edges=stats["n_loops"], free_final_gap_m=round(
             final, 5), free_keyframes=fstats["n_keyframes"],
         free_loop_edges=fstats["n_loops"], free_ms_per_scan=round(ms, 3),
         lockstep_ms_per_scan=round(_ms_per_scan(per_scan, stats), 3))
    if not (gap < POSE_TOL_M and final < POSE_TOL_M
            and stats["n_loops"] == int(gold["n_loop_edges"])):
        raise AssertionError(f"mt_loop: lockstep gap {gap}, free final "
                             f"{final}, {_brief(stats)}")
    return ms


def _brief(stats) -> dict:
    """A replay's stats without its per-scan records."""
    return {k: v for k, v in stats.items() if "seconds" not in k
            and k not in ("compositions", "overlaps", "keyframes",
                          "iterations")}


def _counts_equal(stats, fix, keys=("n_keyframes", "n_loops")):
    fixture_key = {"n_loops": "n_loop_edges"}
    return all(stats[k] == int(fix[fixture_key.get(k, k)]) for k in keys)


def phase_replay_long(dev):
    """The 300-scan clover (three closures and their re-anchors) against
    golden_replay_long.npz. Held: equal keyframe, closure and optimize
    counts; every scan up to the first whose local-map composition
    differs from the JAX run's (golden_replay_long_eval.npz) within
    POSE_TOL_M; then each scan's error to the truth inside the fixture's
    envelope, the ATE no worse than the fixture's plus LONG_ATE_SLACK_M
    and the final pose within POSE_TOL_M. The kernels are held on the
    replay itself: the same replay with K1 replaced by its plain version
    gives the same bits, and K3 at each of the replay's optimizes stays
    within K3_POSE_TOL_M of the plain LM on the same inputs. Printed
    beside: the decision scan, the overlaps there, the per-scan gap (also
    at +-1 scan) and the swaps against the fixture's, ms per scan
    (synchronized per scan), and ATE and RPE against the fixture's."""
    from pgslam_tpu_torch import eval as ev
    from pgslam_tpu_torch import replays
    from pgslam_tpu_torch.optim import pgo
    from pgslam_tpu_torch.optim.lm import lm_optimize
    recorder = _RecordLM()
    with recorder:
        per_scan, _, stats = replays.run_replay("long", device=dev,
                                                sync=_sync)
    ms = 1e3 * float(np.mean(stats["scan_seconds"]))
    fix = replays.fixture("long")
    gold = fix["per_scan_poses"]
    fev = np.load(os.path.join(replays.FIXTURES,
                               "golden_replay_long_eval.npz"))
    decide = _first_comp_change(stats["compositions"], [
        tuple(c[c >= 0]) for c in fev["compositions"]])
    shared = len(per_scan) if decide is None else decide
    shared_gap = replays.max_pose_gap(per_scan[:shared], gold[:shared])
    truth = np.stack(replays.long_sequence()[2])
    te = _truth_errs(per_scan, truth).max()
    limit = max(LONG_TRUTH_FLOOR_M,
                LONG_TRUTH_FACTOR * _truth_errs(gold, truth).max())
    ate, fixture_ate = ev.ate_rmse(per_scan, truth), float(fev["ate_rmse"])
    final = float(np.linalg.norm(per_scan[-1][:3, 3] - gold[-1][:3, 3]))
    rpe_t, rpe_r = ev.rpe(per_scan, truth)
    with _Uncounted():
        with _PlainRoutes(k1=True, k3=False):
            plain_k1 = replays.run_replay("long", device=dev, sync=_sync)[0]
        k3_gap = 0.0
        for args, config in recorder.problems:
            on_card = [a.to(dev) if hasattr(a, "to") else a for a in args]
            k3 = lm_optimize(*on_card, config=config)[0]
            plain = pgo.lm_optimize_plain(*on_card, config=config)[0]
            k3_gap = max(k3_gap, float((k3[:, :3, 3] - plain[:, :3, 3])
                                       .abs().max()))
    k1_bits = bool(np.array_equal(per_scan, plain_k1))
    counts = {k: stats[k] for k in LONG_COUNTS}
    at = lambda a, i: None if i is None or a[i] is None \
        else round(float(a[i]), 5)
    line("replay_long", scans=len(per_scan),
         counts=",".join(f"{k}:{v}" for k, v in counts.items()),
         first_decision_off_fixture=decide,
         overlap_there=at(stats["overlaps"], decide),
         fixture_overlap_there=at(fev["overlaps"], decide),
         gap_before_it_m=round(shared_gap, 5),
         swaps=stats["n_swaps"], fixture_swaps=int(fix["n_swaps"]),
         max_gap_m=round(replays.max_pose_gap(per_scan, gold), 5),
         window1_gap_m=round(replays.max_pose_gap(per_scan, gold, window=1),
                             5),
         final_gap_m=round(final, 5),
         truth_err_m=round(float(te), 5), truth_limit_m=round(float(limit),
                                                              5),
         ms_per_scan=round(ms, 3), ate_m=round(ate, 5),
         fixture_ate_m=round(fixture_ate, 5),
         rpe_m=round(rpe_t, 5), fixture_rpe_m=round(float(fev["rpe_trans"]),
                                                   5),
         rpe_rad=round(rpe_r, 5),
         fixture_rpe_rad=round(float(fev["rpe_rot"]), 5),
         k1_plain_bits_equal=k1_bits, optimizes=len(recorder.problems),
         k3_vs_plain_m=k3_gap)
    if not (np.isfinite(per_scan).all() and counts == LONG_COUNTS
            and _counts_equal(stats, fix, LONG_COUNTS)
            and shared_gap <= POSE_TOL_M and te < limit
            and ate <= fixture_ate + LONG_ATE_SLACK_M and final < POSE_TOL_M
            and k1_bits and len(recorder.problems) == LONG_COUNTS["opt_runs"]
            and k3_gap <= K3_POSE_TOL_M):
        raise AssertionError(
            f"replay_long: gap {shared_gap} before scan {decide}, truth err "
            f"{te} (limit {limit}), ATE {ate} (fixture {fixture_ate}), final "
            f"{final}, K1 bits {k1_bits}, K3 {k3_gap}, {counts}")
    return ms


def phase_replay_yaml(dev):
    """examples/slam_config.yaml through from_yaml over the 2048-point
    clover against the JAX package's run (golden_replay_yaml.npz): equal
    keyframe and loop counts, every scan within POSE_TOL_M, K1 and K3
    launched."""
    from pgslam_tpu_torch import replays
    from pgslam_tpu_torch.ops.knn import knn
    from pgslam_tpu_torch.optim.lm import lm_optimize
    from pgslam_tpu_torch.slam import PoseGraphSlam
    slam = PoseGraphSlam.from_yaml(replays.SLAM_YAML, device=dev)
    if slam.config != replays.yaml_config() or slam.device != dev:
        raise AssertionError("from_yaml gives another config or device")
    k1, k3 = knn.launches, lm_optimize.launches
    per_scan, _, stats = replays.run_replay("yaml_clover", device=dev,
                                            sync=_sync)
    fix = replays.fixture("yaml_clover")
    gap = replays.max_pose_gap(per_scan, fix["per_scan_poses"])
    k1, k3 = knn.launches - k1, lm_optimize.launches - k3
    ms = 1e3 * float(np.mean(stats["scan_seconds"]))
    line("replay_yaml_clover", scans=len(per_scan),
         **_counts_line(stats, fix), max_gap_m=round(gap, 5),
         k1_launches=k1, k3_launches=k3, ms_per_scan=round(ms, 3))
    if not (np.isfinite(per_scan).all() and gap <= POSE_TOL_M
            and _counts_equal(stats, fix) and stats["n_loops"] >= 1
            and k1 > 0 and k3 > 0):
        raise AssertionError(f"replay_yaml_clover: gap {gap}, K1 {k1}, "
                             f"K3 {k3}, {_brief(stats)}")
    return ms


def phase_replay_p2plane(dev):
    """from_config_paths(icp_point_to_plane.yaml, slam_config.yaml's input
    filters, icp_point_to_plane.yaml) over the same scans, twice: the same
    bits both times, the largest per-scan error to the truth below the JAX
    package's run's (golden_replay_p2plane.npz) plus
    P2PLANE_TRUTH_MARGIN_M, keyframes within P2PLANE_KEYFRAME_WINDOW of
    its count, and K1 launched at k = 10 (the normals)."""
    import tempfile

    from pgslam_tpu_torch import replays
    from pgslam_tpu_torch.ops.knn import knn
    from pgslam_tpu_torch.slam import PoseGraphSlam
    with tempfile.TemporaryDirectory() as tmp:
        slam = PoseGraphSlam.from_config_paths(
            replays.P2PLANE_YAML, replays.input_filters_yaml(tmp),
            replays.P2PLANE_YAML, device=dev)
    if slam.config != replays.p2plane_config():
        raise AssertionError("from_config_paths gives another config")
    k10 = lambda: sum(c for (_, _, k), c in knn.shapes.items() if k == 10)
    before = k10()
    runs = [replays.run_replay("p2plane", device=dev, sync=_sync)
            for _ in range(2)]
    (per_scan, _, stats), again = runs[0], runs[1][0]
    truth = np.stack(replays.yaml_clover_sequence()[2])
    err = np.linalg.norm(per_scan[:, :3, 3] - truth[:, :3, 3], axis=1)
    fix = replays.fixture("p2plane")
    jax_err = np.linalg.norm(fix["per_scan_poses"][:, :3, 3]
                             - truth[:, :3, 3], axis=1).max()
    limit = float(jax_err) + P2PLANE_TRUTH_MARGIN_M
    repeat = bool(np.array_equal(per_scan, again))
    k10_launches = k10() - before
    ms = 1e3 * float(np.mean(stats["scan_seconds"]))
    line("replay_p2plane", scans=len(per_scan), **_counts_line(stats, fix),
         truth_err_m=round(float(err.max()), 5),
         jax_truth_err_m=round(float(jax_err), 5),
         truth_limit_m=round(limit, 5),
         final_truth_err_m=round(float(err[-1]), 5), bits_repeat=repeat,
         k1_k10_launches=k10_launches, ms_per_scan=round(ms, 3))
    if not (np.isfinite(per_scan).all() and repeat and err.max() < limit
            and abs(stats["n_keyframes"] - int(fix["n_keyframes"]))
            <= P2PLANE_KEYFRAME_WINDOW and k10_launches > 0):
        raise AssertionError(f"replay_p2plane: truth err {err.max()} "
                             f"(limit {limit}), repeat {repeat}, K1 at "
                             f"k = 10 {k10_launches}, {_brief(stats)}")
    return ms


def phase_replay_grid(dev):
    """The golden loop on the grid matcher against the JAX package's run
    (golden_replay_grid.npz): equal counts, every scan within POSE_TOL_M.
    Printed beside: the first scan whose local-map composition or
    keyframe count leaves the JAX run's (golden_replay_grid_eval.npz),
    the registration overlaps there against the keyframe threshold
    (LocalizerConfig.overlap_threshold) and the two compositions, and the
    largest gap before that scan; and the first scans whose registration
    took another number of ICP iterations than the JAX run's (where the
    convergence checker stopped on the other side of its eps;
    ``scripts/grid_replay_stops.py`` prints the checker's margins)."""
    from pgslam_tpu_torch import replays
    per_scan, _, stats = replays.run_replay("grid", device=dev, sync=_sync)
    fix = replays.fixture("grid")
    gap = replays.max_pose_gap(per_scan, fix["per_scan_poses"])
    ms = 1e3 * float(np.mean(stats["scan_seconds"]))
    fev = np.load(os.path.join(replays.FIXTURES,
                               "golden_replay_grid_eval.npz"))
    jax_comps = [tuple(c[c >= 0]) for c in fev["compositions"]]
    decide = _first_comp_change(stats["compositions"], jax_comps)
    kf_off = _first_above(np.abs(np.asarray(stats["keyframes"])
                                 - fev["keyframes"]), 0)
    first = min((i for i in (decide, kf_off) if i is not None),
                default=None)
    its = np.array([-1 if i is None else i for i in stats["iterations"]])
    icp_off = np.flatnonzero(its != fev["iterations"])[:ICP_STOPS_SHOWN]
    threshold = replays.grid_config().localizer.overlap_threshold
    at = lambda a, i: None if i is None or a[i] is None \
        else round(float(a[i]), 5)
    line("replay_grid", scans=len(per_scan), **_counts_line(stats, fix),
         first_scan_off_fixture=_first_above(replays.per_scan_gaps(
             per_scan, fix["per_scan_poses"]), WITNESS_TOL_M),
         first_decision_off_fixture=first,
         first_composition_off=decide, first_keyframe_count_off=kf_off,
         overlap_there=at(stats["overlaps"], first),
         fixture_overlap_there=at(fev["overlaps"], first),
         overlap_threshold=threshold,
         fixture_margin_there=(None if first is None else round(
             float(fev["overlaps"][first]) - threshold, 5)),
         composition_there=(None if first is None else
                            "-".join(map(str, stats["compositions"][first]))),
         fixture_composition_there=(None if first is None else
                                    "-".join(map(str, jax_comps[first]))),
         gap_before_it_m=round(replays.max_pose_gap(
             per_scan[:first], fix["per_scan_poses"][:first])
             if first else 0.0, 5),
         icp_iterations_off_fixture=",".join(
             f"{i}:{its[i]}/{fev['iterations'][i]}" for i in icp_off)
         or None,
         max_gap_m=round(gap, 5), ms_per_scan=round(ms, 3))
    if not (np.isfinite(per_scan).all() and gap <= POSE_TOL_M
            and _counts_equal(stats, fix, ("n_keyframes", "n_loops",
                                           "opt_runs", "n_swaps"))):
        raise AssertionError(f"replay_grid: gap {gap}, {_brief(stats)}")
    return ms


def phase_resume(dev):
    """The loop checkpointed after scan RESUME_AT - 1 and resumed by a
    fresh facade: the resumed scans within POSE_TOL_M of
    golden_replay.npz (their gap to the uninterrupted card run printed),
    equal counts; the KITTI and TUM trajectories and the global_map PLY
    written and read back (KITTI and PLY exactly, TUM within 1e-6)."""
    import tempfile

    from pgslam_tpu_torch import io, replays
    gold = replays.fixture("loop")
    with tempfile.TemporaryDirectory() as tmp:
        full, resumed, slam = replays.run_replay_resumed(
            "loop", RESUME_AT, os.path.join(tmp, "ckpt.npz"), device=dev,
            sync=_sync)
        gap = replays.max_pose_gap(resumed, gold["per_scan_poses"][RESUME_AT:])
        gap_card = replays.max_pose_gap(resumed, full[RESUME_AT:])
        traj = slam.trajectory()
        gmap = slam.global_map()
        io.save_trajectory_kitti(os.path.join(tmp, "t.kitti"), traj)
        io.save_trajectory_tum(os.path.join(tmp, "t.tum"), traj)
        io.save_cloud_ply(os.path.join(tmp, "map.ply"), gmap)
        kitti = io.load_trajectory_kitti(os.path.join(tmp, "t.kitti"))
        ts, tum = io.load_trajectory_tum(os.path.join(tmp, "t.tum"))
        ply = io.load_cloud_ply(os.path.join(tmp, "map.ply"), device=dev)
        files_ok = bool(
            np.array_equal(kitti, traj)
            and np.array_equal(ts, np.arange(len(traj)))
            and np.abs(tum - traj).max() <= 1e-6
            and np.array_equal(ply.points.cpu().numpy(), gmap))
    keyframes, loops = slam.get_graph().n_vertices, slam.n_loop_edges()
    line("resume", at_scan=RESUME_AT, scans=len(resumed),
         max_gap_to_fixture_m=round(gap, 5),
         max_gap_to_uninterrupted_m=round(gap_card, 6), keyframes=keyframes,
         loop_edges=loops, fixture_keyframes=len(gold["trajectory"]),
         fixture_loop_edges=int(gold["n_loop_edges"]),
         map_points=len(gmap), files_round_trip=files_ok)
    if not (np.isfinite(resumed).all() and gap <= POSE_TOL_M and files_ok
            and keyframes == len(gold["trajectory"])
            and loops == int(gold["n_loop_edges"])):
        raise AssertionError(f"resume: gap {gap}, files {files_ok}, "
                             f"{keyframes}/{loops}")


def _first_above(gaps, tol):
    """The first index whose gap exceeds ``tol``, or None."""
    ix = np.flatnonzero(np.asarray(gaps) > tol)
    return int(ix[0]) if len(ix) else None


def _first_comp_change(a, b):
    """The first scan whose composition differs between two runs."""
    ix = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    return ix[0] if ix else None


class _Uncounted:
    """Keep the launches made inside out of every kernel's counts: a
    replay's witnesses and its kernel-against-plain comparisons are not
    the path's."""

    TALLIES = ("shapes", "batch_sizes")

    def __enter__(self):
        from pgslam_tpu_torch.ops.icp_fused import fused_icp_register
        from pgslam_tpu_torch.ops.knn import knn
        from pgslam_tpu_torch.optim.lm import lm_optimize
        from pgslam_tpu_torch.optim.pcg import pcg_solve
        self.saved = [(w, w.launches, {t: getattr(w, t).copy()
                                       for t in self.TALLIES if hasattr(w, t)})
                      for w in (knn, fused_icp_register, lm_optimize,
                                pcg_solve)]
        return self

    def __exit__(self, *exc):
        for w, launches, tallies in self.saved:
            w.launches = launches
            for t, v in tallies.items():
                setattr(w, t, v)


class _PlainRoutes:
    """Replace K1 (in the ICP matcher and the normals) and K3 (in the
    optimizer) by their plain PyTorch versions on CUDA tensors, for a
    second witness of a replay on the card; restored on exit."""

    def __init__(self, k1: bool, k3: bool):
        from pgslam_tpu_torch.ops import filters, icp, knn
        from pgslam_tpu_torch.optim import lm, pgo
        self.patches = []
        if k1:
            plain = lambda q, qm, r, rm, k=1: knn.knn_plain(q, qm, r, rm, k)
            self.patches += [(icp, "knn", plain), (filters, "knn", plain)]
        if k3:
            self.patches.append((lm, "lm_optimize",
                                 lambda *a, config, ptr_host=None:
                                 pgo.lm_optimize_plain(*a, config=config)))
        self.saved = []

    def __enter__(self):
        for mod, attr, fn in self.patches:
            self.saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, fn)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


class _RecordLM:
    """Keep the arguments of every pose-graph optimize (on the host)
    while active."""

    LM_ARGS = ("poses", "vmask", "edge_from", "edge_to", "edge_T",
               "edge_cov", "emask", "fixed_id", "robust_emask")

    def __init__(self):
        self.problems = []

    def __enter__(self):
        # The classic path calls optimizer.optimize_pose_graph, the
        # resident mirror pgo.optimize_pose_graph: one record an optimize.
        from pgslam_tpu_torch import optimizer
        from pgslam_tpu_torch.optim import pgo
        orig = pgo.optimize_pose_graph
        self.saved = [(optimizer, optimizer.optimize_pose_graph),
                      (pgo, orig)]

        def record(*args, robust_emask=None, config, **kw):
            self.problems.append(([a.detach().cpu() if hasattr(a, "detach")
                                   else a for a in args + (robust_emask,)],
                                  config))
            return orig(*args, robust_emask=robust_emask, config=config,
                        **kw)
        optimizer.optimize_pose_graph = pgo.optimize_pose_graph = record
        return self

    def __exit__(self, *exc):
        for mod, fn in self.saved:
            mod.optimize_pose_graph = fn


def witness_k3(dev, name, problems, out_dir):
    """K3, the plain LM on the card and the plain LM on the CPU at each
    optimize a replay launched: the largest translation gap between their
    poses, their LM iterations and final costs."""
    from pgslam_tpu_torch.optim import lm, pgo
    saved = {}
    for n, (args, config) in enumerate(problems):
        on = lambda d: [a.to(d) if hasattr(a, "to") else a for a in args]
        out = {"k3": lm.lm_optimize(*on(dev), config=config),
               "plain_card": pgo.lm_optimize_plain(*on(dev), config=config),
               "plain_cpu": pgo.lm_optimize_plain(*on("cpu"), config=config)}
        t = {k: v[0][:, :3, 3].cpu().numpy() for k, v in out.items()}
        gap = lambda a, b: float(np.abs(t[a] - t[b]).max())
        line("replay_witness_k3", replay=name, optimize=n,
             poses=int(args[1].sum()), edges=int(args[6].sum()),
             k3_vs_plain_card_m=gap("k3", "plain_card"),
             k3_vs_plain_cpu_m=gap("k3", "plain_cpu"),
             plain_card_vs_cpu_m=gap("plain_card", "plain_cpu"),
             **{f"{k}_iterations": int(v[1]["iterations"])
                for k, v in out.items()},
             **{f"{k}_final_cost": float(v[1]["final_cost"])
                for k, v in out.items()})
        for k, a in zip(_RecordLM.LM_ARGS, args):
            if a is not None:
                saved[f"p{n}_{k}"] = np.asarray(a)
        for k, v in out.items():
            saved[f"p{n}_{k}_poses"] = v[0].cpu().numpy()
    np.savez(os.path.join(out_dir, f"witness_{name}_lm.npz"), **saved)


WITNESS_REPLAYS = ("loop", "grid", "long")
WITNESS_RUNS = (("card", True, True), ("card_plain_k1", False, True),
                ("card_plain_k3", True, False), ("card_plain", False, False),
                ("host", None, None))


def phase_replay_witness(dev, out_dir="chiprun_out"):
    """Each replay of WITNESS_REPLAYS on the card with K1 and K3, with
    either or both replaced by its plain PyTorch version on the card, and
    on the machine's CPU at one thread: per run the first scan more than
    WITNESS_TOL_M from the fixture and from the CPU run, the first scan
    whose local-map composition differs from the CPU run's, the largest
    gap (also at +-1 scan), counts and swaps, and the K1 and K3 launches;
    and :func:`witness_k3` at the optimizes of the run with K1 and K3.
    The per-scan poses and compositions go to
    ``<out_dir>/witness_<replay>.npz``."""
    import torch
    from pgslam_tpu_torch import eval as ev
    from pgslam_tpu_torch import replays
    from pgslam_tpu_torch.ops.knn import knn
    from pgslam_tpu_torch.optim.lm import lm_optimize
    os.makedirs(out_dir, exist_ok=True)
    for name in WITNESS_REPLAYS:
        fix = replays.fixture(name)
        gold = fix["per_scan_poses"]
        truth = np.stack(replays.REPLAYS[name][0]()[2])
        runs = {}
        for label, k1, k3 in WITNESS_RUNS:
            threads = torch.get_num_threads()
            if label == "host":
                torch.set_num_threads(1)
                run = lambda: replays.run_replay(name, device="cpu")
            else:
                run = lambda: replays.run_replay(name, device=dev, sync=_sync)
            k1n, k3n = knn.launches, lm_optimize.launches
            recorder = _RecordLM()
            with _PlainRoutes(k1=not k1, k3=not k3), recorder:
                per_scan, _, stats = run()
            torch.set_num_threads(threads)
            runs[label] = (per_scan, stats["compositions"])
            k1n, k3n = knn.launches - k1n, lm_optimize.launches - k3n
            line("replay_witness", replay=name, run=label,
                 first_scan_off_fixture=_first_above(
                     replays.per_scan_gaps(per_scan, gold), WITNESS_TOL_M),
                 max_gap_m=round(replays.max_pose_gap(per_scan, gold), 5),
                 window1_gap_m=round(replays.max_pose_gap(per_scan, gold,
                                                          window=1), 5),
                 keyframes=stats["n_keyframes"], loops=stats["n_loops"],
                 opt_runs=stats["opt_runs"], swaps=stats["n_swaps"],
                 fixture_counts="/".join(str(int(fix[k])) if k in fix
                                         else "-" for k in (
                                             "n_keyframes", "n_loop_edges",
                                             "opt_runs", "n_swaps")),
                 fixture_trajectory=len(fix["trajectory"]),
                 ate_m=round(ev.ate_rmse(per_scan, truth), 5),
                 fixture_ate_m=round(ev.ate_rmse(gold, truth), 5),
                 k1_launches=k1n, k3_launches=k3n)
            if label == "card":
                witness_k3(dev, name, recorder.problems, out_dir)
        host_poses, host_comps = runs["host"]
        for label, (per_scan, comps) in runs.items():
            if label != "host":
                line("replay_witness_vs_host", replay=name, run=label,
                     first_scan_off_host=_first_above(
                         replays.per_scan_gaps(per_scan, host_poses),
                         WITNESS_TOL_M),
                     first_composition_change=_first_comp_change(
                         comps, host_comps),
                     max_gap_to_host_m=round(replays.max_pose_gap(
                         per_scan, host_poses), 5))
        width = max(len(c) for _, cs in runs.values() for c in cs)
        np.savez(os.path.join(out_dir, f"witness_{name}.npz"), **{
            f"{label}_{part}": arr for label, (poses, comps) in runs.items()
            for part, arr in (("poses", poses), ("comps", np.array(
                [list(c) + [-1] * (width - len(c)) for c in comps])))})


def single_inputs(dev):
    """The single-scan route's K2 launch on the loop: scan 3 (512 points)
    against the localizer's local map, scans 0-2 in scan 2's frame at its
    capacity (3 x 512 points), from the odometry guess, under the loop's
    point-to-point config (:func:`stream_inputs`'s first entry). Returns
    (cfg, reading, reference, T0) at B = 1."""
    cfg, rd, rf, T0 = stream_inputs(dev)
    first = lambda c: c.map(lambda a: a[:1].contiguous())
    return cfg, first(rd), first(rf), T0[:1].contiguous()


def phase_k2_single(dev):
    """K2 at the single route's B = 1 loop shape against its plain
    version, at phase k2's limits with equal iterations."""
    cfg, rd, rf, T0 = single_inputs(dev)
    out = k2_compare(dev, "k2_single", rd, rf, T0, cfg, 10, 2,
                     controls=K2_CONTROLS, error=cfg.error,
                     coarse_div=cfg.coarse_div, anderson_m=0)
    return out[:4] + out[6:8]


class _FusedSingle:
    """The single-scan K2 route on inside the block (``localizer.
    FUSED_SINGLE``, as ``PGSLAM_FUSED_SINGLE=1`` sets it), counting the
    localizer's registrations through K2 and through ``icp_core``."""

    def __enter__(self):
        from pgslam_tpu_torch import localizer as L
        self.L, self.k2_scans, self.icp_core_scans = L, 0, 0
        self.saved = (L.FUSED_SINGLE, L.register_one, L.icp_core)
        register_one, icp_core = self.saved[1:]

        def counted_k2(*a, **k):
            self.k2_scans += 1
            return register_one(*a, **k)

        def counted_core(*a, **k):
            self.icp_core_scans += 1
            return icp_core(*a, **k)

        L.FUSED_SINGLE, L.register_one, L.icp_core = (True, counted_k2,
                                                      counted_core)
        return self

    def __exit__(self, *exc):
        self.L.FUSED_SINGLE, self.L.register_one, self.L.icp_core = \
            self.saved


def route_off_ms(dev, name):
    """ms per scan of a replay synchronized per scan on the default route,
    run just before its route-on twin so that both are warm."""
    import torch
    from pgslam_tpu_torch import replays
    _, _, stats = replays.run_replay(name, device=dev,
                                     sync=torch.cuda.synchronize)
    ms = 1e3 * float(np.mean(stats["scan_seconds"]))
    line(f"replay_{name}_route_off", ms_per_scan=round(ms, 3))
    return ms


def phase_replay_fused1(dev, name, keyframes, loops, tol, ms_off):
    """A replay synchronized per scan with the single-scan route on: every
    scan after the first registers in one K2 launch at B = 1 and none
    through ``icp_core``, so K1 launches only for the overlap probes and
    the loop closer (at most one probe a scan and one residual a
    verification); K2 launches once a scan and once a verification; the
    counts equal the fixture's and the gap is within ``tol``. ms per scan
    beside the route-off replay's (``ms_off``, this run's)."""
    import torch
    from pgslam_tpu_torch import replays
    from pgslam_tpu_torch.ops.icp_fused import fused_icp_register
    from pgslam_tpu_torch.ops.knn import knn
    from pgslam_tpu_torch.utils import counters
    outcomes = ("accepted", "rejected", "rejected_duplicate")
    verified = lambda: sum(counters[f"loopcloser/{o}"] for o in outcomes)
    with _FusedSingle() as route:
        k1, k2, v0 = knn.launches, fused_icp_register.launches, verified()
        per_scan, _, stats = replays.run_replay(name, device=dev,
                                                sync=torch.cuda.synchronize)
        k1, k2 = knn.launches - k1, fused_icp_register.launches - k2
        verifications = int(verified() - v0)
    gap = replays.max_pose_gap(per_scan, replays.fixture(name)[
        "per_scan_poses"])
    ms = 1e3 * float(np.mean(stats["scan_seconds"]))
    n = len(per_scan)
    line(f"replay_{name}_fused1", scans=n, keyframes=stats["n_keyframes"],
         loop_edges=stats["n_loops"], max_gap_m=round(gap, 5),
         gap_limit_m=tol, k2_scan_launches=route.k2_scans,
         icp_core_scans=route.icp_core_scans, k2_launches=k2,
         verifications=verifications, k1_launches=k1,
         ms_per_scan=round(ms, 3), ms_per_scan_route_off=round(ms_off, 3))
    if not (np.isfinite(per_scan).all() and gap < tol
            and stats["n_keyframes"] == keyframes
            and stats["n_loops"] == loops
            and route.k2_scans == n - 1 and route.icp_core_scans == 0
            and k2 == route.k2_scans + verifications
            and k1 <= n + verifications):
        raise AssertionError(
            f"replay_{name}_fused1: gap {gap} (limit {tol}), keyframes "
            f"{stats['n_keyframes']}, loops {stats['n_loops']}, K2 scans "
            f"{route.k2_scans} of {n - 1}, icp_core scans "
            f"{route.icp_core_scans}, K2 launches {k2} ({verifications} "
            f"verifications), K1 launches {k1}")
    return ms


def phase_fused1_idle(dev):
    """``profile_replay`` of the loop and the 64k corridor with the single
    route on and off: wall and device ms per scan and the device's idle
    share."""
    from pgslam_tpu_torch.profile_replay import profile
    out = {}
    for name in ("loop", "corridor_64k"):
        for on in (True, False):
            p = profile(name, fused_single=on)
            key = f"{name}_{'on' if on else 'off'}"
            out[key] = {k: p[k] for k in (
                "wall_ms_per_unit", "device_busy_ms_per_unit",
                "device_idle_share")}
            groups = p["device_ms_per_unit_by_kernel_group"]
            line("fused1_profile", replay=name, route="on" if on else "off",
                 wall_ms_per_scan=round(p["wall_ms_per_unit"], 3),
                 device_busy_ms_per_scan=round(
                     p["device_busy_ms_per_unit"], 4),
                 device_idle_share=round(p["device_idle_share"], 4),
                 device_events_per_scan=round(p["device_events_per_unit"],
                                              1),
                 **{f"{g}_ms_per_scan": round(v, 4)
                    for g, v in sorted(groups.items())})
            out[key]["by_group"] = groups
    return out


def phase_native(dev):
    """The native core: it builds (host g++) and loads; the golden loop's
    scans written as KITTI files, streamed back through ``ScanLoader``
    bit for bit and replayed through ``PoseGraphSlam`` (counts and gap as
    the loop replay's); the native Dijkstra against the Python heap from
    every vertex of that replay's final graph, distances and settle
    order."""
    import tempfile

    import torch
    from pgslam_tpu_torch import (PoseGraphSlam, ScanLoader, replays,
                                  save_kitti_bin)
    from pgslam_tpu_torch.graph.shortest_path import dijkstra_python
    from pgslam_tpu_torch.native import (library_path, native_available,
                                         native_dijkstra)
    if not native_available():
        raise AssertionError("the native core did not build or load")
    scans, odom, _ = replays.loop_sequence_golden()
    scans, odom = scans[:NATIVE_SCANS], odom[:NATIVE_SCANS]
    slam = PoseGraphSlam(replays.loop_config(), device=dev)
    T_rs = np.eye(4, dtype=np.float32)
    per_scan, equal = [], 0
    with tempfile.TemporaryDirectory() as d:
        for i, s in enumerate(scans):
            save_kitti_bin(os.path.join(d, f"{i:06d}.bin"), s)
        with ScanLoader(d) as loader:
            n_files = len(loader)
            for i, s in enumerate(loader):
                equal += bool(np.array_equal(s, scans[i]))
                slam.add_data(i, "world", odom[i], T_rs, s)
                torch.cuda.synchronize()
                per_scan.append(slam.localizer.T_world_robot.copy())
    gap = replays.max_pose_gap(np.stack(per_scan), replays.fixture("loop")[
        "per_scan_poses"][:len(per_scan)])
    g = slam.get_graph()
    n, e = g.n_vertices, g.n_edges
    args = (n, g.edge_from[:e], g.edge_to[:e], g.edge_weight[:e])
    agree, t_native, t_python = 0, 0.0, 0.0
    for src in range(n):
        t1 = time.perf_counter()
        nd, ns = native_dijkstra(*args, src)
        t2 = time.perf_counter()
        pd, ps = dijkstra_python(*args, src)
        t3 = time.perf_counter()
        t_native, t_python = t_native + t2 - t1, t_python + t3 - t2
        agree += bool(np.allclose(nd, pd, rtol=1e-6) and ns == ps)
    line("native", library=os.path.basename(library_path()),
         kitti_files=n_files,
         scans_bit_equal=equal, keyframes=n, loop_edges=slam.n_loop_edges(),
         max_gap_m=round(gap, 5), dijkstra_sources_equal=agree,
         dijkstra_native_ms=round(1e3 * t_native / n, 4),
         dijkstra_python_ms=round(1e3 * t_python / n, 4))
    if not (n_files == equal == len(scans) and gap < POSE_TOL_M
            and n == 20 and slam.n_loop_edges() == 1 and agree == n):
        raise AssertionError(f"native: {equal} of {len(scans)} scans equal, "
                             f"gap {gap}, {n} keyframes, "
                             f"{slam.n_loop_edges()} loops, Dijkstra equal "
                             f"from {agree} of {n} sources")


# --------------------------------------------------------------------------
# The resident mirror (optim/resident.py): the default optimize path
# --------------------------------------------------------------------------

class _OptimizeProbe:
    """Per optimize (``Optimizer.process_data``) while active: which path
    ran (the mirror or the classic upload), the mirror's rebuild flag, the
    bytes uploaded and fetched, the K3 and K4 launches, ms to the end of
    the writeback with one synchronize after it, the host ms of its
    prepare (the snapshot before any device work) and the graph's poses
    after it. ``kind`` "count" also counts the synchronizing CUDA calls
    from its start to the writeback (``torch.cuda.set_sync_debug_mode
    ("warn")``; the localizer's resync after the writeback is not the
    optimize's), and "inputs" keeps host copies of the solve's inputs
    (``optimize_pose_graph``'s arguments); neither belongs in a timed
    run."""

    KINDS = ("time", "count", "inputs")

    def __init__(self, kind: str = "time"):
        if kind not in self.KINDS:
            raise ValueError(f"unknown probe kind {kind!r}")
        self.count_syncs = kind == "count"
        self.keep_inputs = kind == "inputs"
        self.records = []

    def __enter__(self):
        import warnings

        import torch
        from pgslam_tpu_torch import optimizer
        from pgslam_tpu_torch.optim import pgo, resident
        from pgslam_tpu_torch.optim.lm import lm_optimize
        from pgslam_tpu_torch.optim.pcg import pcg_solve
        cls, mirror = optimizer.Optimizer, resident.ResidentPGO
        self.saved = [(cls, n, getattr(cls, n)) for n in (
            "process_data", "update_after_optimization",
            "prepare_for_optimization",
            "prepare_for_optimization_resident")] + [
                (mirror, "execute", mirror.execute),
                (optimizer, "optimize_pose_graph",
                 optimizer.optimize_pose_graph),
                (pgo, "optimize_pose_graph", pgo.optimize_pose_graph)]
        orig = {n: f for _, n, f in self.saved}
        probe = self

        def stop_counting(rec):
            if rec.get("_warn") is not None:
                torch.cuda.set_sync_debug_mode(0)
                caught = rec.pop("_warn")
                rec["_cm"].__exit__(None, None, None)
                rec["syncs"] = sum("synchronizing CUDA operation"
                                   in str(w.message) for w in caught)

        def process_data(opt):
            rec = {"path": None, "rebuild": None, "syncs": None,
                   "_warn": None}
            probe._rec = rec
            k3, k4 = lm_optimize.launches, pcg_solve.launches
            if probe.count_syncs:
                rec["_cm"] = warnings.catch_warnings(record=True)
                rec["_warn"] = rec["_cm"].__enter__()
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                orig["process_data"](opt)
                torch.cuda.synchronize()
            finally:
                stop_counting(rec)
            rec["ms"] = 1e3 * (time.perf_counter() - t0)
            rec["k3"] = lm_optimize.launches - k3
            rec["k4"] = pcg_solve.launches - k4
            g = opt.mm.get_graph()
            rec["poses"] = g.optimized_poses[:g.n_vertices].copy()
            rec.pop("_cm", None)
            probe.records.append(rec)

        def update_after_optimization(opt, new_poses):
            stop_counting(probe._rec)
            if probe._rec["path"] == "classic":
                probe._rec["download"] = (new_poses.nbytes
                                          + 4 * len(opt.last_stats))
            return orig["update_after_optimization"](opt, new_poses)

        def prepare_for_optimization(opt):
            t0 = time.perf_counter()
            args, rmask = orig["prepare_for_optimization"](opt)
            probe._rec.update(path="classic", upload=sum(
                t.nelement() * t.element_size() for t in args[:7]
                + ((rmask,) if rmask is not None else ())),
                prepare_ms=1e3 * (time.perf_counter() - t0))
            return args, rmask

        def prepare_for_optimization_resident(opt):
            t0 = time.perf_counter()
            prep = orig["prepare_for_optimization_resident"](opt)
            probe._rec["prepare_ms"] = 1e3 * (time.perf_counter() - t0)
            return prep

        def execute(m, prep):
            out = orig["execute"](m, prep)
            probe._rec.update(path="resident", rebuild=prep.rebuild,
                              upload=m.last_upload_bytes,
                              download=m.last_download_bytes)
            return out

        def solve(*args, robust_emask=None, config, **kw):
            # The classic path calls optimizer.optimize_pose_graph, the
            # mirror pgo.optimize_pose_graph: the same function.
            if probe.keep_inputs:
                probe._rec["inputs"] = [
                    np.array(a.detach().cpu()) if torch.is_tensor(a) else a
                    for a in args + (robust_emask,)]
            return orig["optimize_pose_graph"](
                *args, robust_emask=robust_emask, config=config, **kw)

        for owner, name, fn in (
                (optimizer, "optimize_pose_graph", solve),
                (pgo, "optimize_pose_graph", solve),
                (cls, "process_data", process_data),
                (cls, "update_after_optimization",
                 update_after_optimization),
                (cls, "prepare_for_optimization", prepare_for_optimization),
                (cls, "prepare_for_optimization_resident",
                 prepare_for_optimization_resident),
                (mirror, "execute", execute)):
            setattr(owner, name, fn)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def _resident_summary(records, label):
    """Counts and means over one run's optimizes (one path)."""
    path = {r["path"] for r in records}
    if len(path) != 1:
        raise AssertionError(f"{label}: optimizes on {path}")
    mean = lambda k, rs=records: (None if not rs else
                                  float(np.mean([r[k] for r in rs])))
    deltas = [r for r in records if r["rebuild"] is False]
    return {"path": path.pop(), "optimizes": len(records),
            "rebuilds": sum(r["rebuild"] is True for r in records),
            "deltas": len(deltas), "ms": mean("ms"),
            "prepare_ms": mean("prepare_ms"),
            "upload_bytes": mean("upload"),
            "delta_upload_bytes": mean("upload", deltas),
            "download_bytes": mean("download"),
            "k3": sum(r["k3"] for r in records),
            "k4": sum(r["k4"] for r in records)}


def _resident_gap(a, b):
    """Largest translation (m) and rotation-entry gap between the poses
    after each optimize of two runs of one sequence."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} against {len(b)} optimizes")
    t = max(float(np.abs(x["poses"][:, :3, 3] - y["poses"][:, :3, 3]).max())
            for x, y in zip(a, b))
    r = max(float(np.abs(x["poses"][:, :3, :3]
                         - y["poses"][:, :3, :3]).max())
            for x, y in zip(a, b))
    return t, r


def _resident_compare(label, run, syncs_ok, trans_tol, rot_tol):
    """``run(mode, kind)`` -> :class:`_OptimizeProbe` records of one
    sequence, ``mode`` "auto" (the mirror) or "off" (the classic
    upload). First each path once keeping the solve's inputs (these runs
    also warm up: a kernel's first launch loads it, the first pinned
    buffers are allocated), then the classic path and the mirror timed,
    then the mirror and the classic path counting synchronizations.
    Held: every optimize on its path, equal K3 and K4 launches, the
    solve's inputs bit-equal both ways at every optimize (the mirror's
    contract: a rebuild's bits), the poses after every optimize
    bit-equal where the classic path repeats its own bits (K3), else
    within ``trans_tol`` (m) and ``rot_tol`` (rotation entries) of it
    (the K4 loop's index_add_ sums with atomics), every resident
    optimize's synchronizations ``syncs_ok``. Printed: the repeat gaps of
    each path, optimizes, rebuilds and deltas, bytes up and down, host
    prepare ms, ms per optimize and synchronizations, both ways."""
    res_i, cls_i = run("auto", "inputs"), run("off", "inputs")
    cls, res = run("off", "time"), run("auto", "time")
    res_n, cls_n = run("auto", "count"), run("off", "count")
    sr, sc = _resident_summary(res, label), _resident_summary(cls, label)
    inputs_equal = len(res_i) == len(cls_i) and all(
        len(a["inputs"]) == len(b["inputs"]) and all(
            (x is None and y is None) or np.array_equal(x, y)
            for x, y in zip(a["inputs"], b["inputs"]))
        for a, b in zip(res_i, cls_i))
    repeat = [_resident_gap(cls, cls_n), _resident_gap(res, res_n)]
    repeats = all(t == r == 0.0 for t, r in repeat)
    cross = [_resident_gap(res, cls), _resident_gap(res_i, cls_i)]
    gap_t, gap_r = (max(g[0] for g in cross), max(g[1] for g in cross))
    bits = gap_t == gap_r == 0.0 and all(
        np.array_equal(x["poses"], y["poses"]) for x, y in zip(res, cls))
    syncs_res = [r["syncs"] for r in res_n]
    syncs_cls = [r["syncs"] for r in cls_n]
    line(label, optimizes=sr["optimizes"], rebuilds=sr["rebuilds"],
         deltas=sr["deltas"], k3_launches=f"{sr['k3']}/{sc['k3']}",
         k4_launches=f"{sr['k4']}/{sc['k4']}",
         solve_inputs_bit_equal=inputs_equal, poses_bit_equal=bits,
         gap_m=gap_t, rot_gap=gap_r,
         classic_repeat_gap_m=repeat[0][0],
         classic_repeat_rot_gap=repeat[0][1],
         resident_repeat_gap_m=repeat[1][0],
         upload_bytes_per_optimize=round(sr["upload_bytes"]),
         delta_upload_bytes_per_optimize=(
             None if sr["delta_upload_bytes"] is None
             else round(sr["delta_upload_bytes"])),
         classic_upload_bytes_per_optimize=round(sc["upload_bytes"]),
         download_bytes_per_optimize=round(sr["download_bytes"]),
         classic_download_bytes_per_optimize=round(sc["download_bytes"]),
         ms_per_optimize=round(sr["ms"], 3),
         classic_ms_per_optimize=round(sc["ms"], 3),
         prepare_ms_per_optimize=round(sr["prepare_ms"], 3),
         classic_prepare_ms_per_optimize=round(sc["prepare_ms"], 3),
         syncs_per_optimize=",".join(map(str, sorted(set(syncs_res)))),
         classic_syncs_per_optimize=",".join(
             map(str, sorted(set(syncs_cls)))),
         ms_each=",".join(f"{r['ms']:.3f}" for r in res),
         classic_ms_each=",".join(f"{r['ms']:.3f}" for r in cls))
    ok = (sr["path"] == "resident" and sc["path"] == "classic"
          and _resident_summary(res_n, label)["path"] == "resident"
          and _resident_summary(cls_i, label)["path"] == "classic"
          and sr["optimizes"] == sc["optimizes"] > 0
          and (sr["k3"], sr["k4"]) == (sc["k3"], sc["k4"])
          and all(np.isfinite(r["poses"]).all() for r in res)
          and inputs_equal
          and (bits if repeats else (gap_t <= trans_tol
                                     and gap_r <= rot_tol))
          and all(syncs_ok(n) for n in syncs_res))
    if not ok:
        raise AssertionError(f"{label}: resident {sr}, classic {sc}, solve "
                             f"inputs equal {inputs_equal}, gap {gap_t} m / "
                             f"{gap_r} (repeats {repeat}), syncs "
                             f"{syncs_res}")
    return {"resident": sr, "classic": sc, "gap_m": gap_t, "bits": bits,
            "syncs": syncs_res, "classic_syncs": syncs_cls}


def phase_resident_loop(dev):
    """The golden loop through ``PoseGraphSlam`` with the mirror and with
    the classic path (:func:`_resident_compare`): the same K3 launches,
    the poses after every optimize bit-equal (or within the classic
    path's repeat gap), one synchronization (the fetch) per resident
    optimize; the replay's per-scan poses equal both ways."""
    import dataclasses

    from pgslam_tpu_torch import replays
    cfg = replays.loop_config()
    scans = {}

    def run(mode, kind):
        c = dataclasses.replace(cfg, optimizer=dataclasses.replace(
            cfg.optimizer, resident=mode))
        with _OptimizeProbe(kind) as probe:
            scans[(mode, kind)] = replays.run_replay(
                "loop", device=dev, sync=_sync, config=c)[0]
        return probe.records

    out = _resident_compare("resident_loop", run, lambda n: n == 1,
                            K3_POSE_TOL_M, K3_ROT_TOL)
    per_scan = scans[("auto", "time")]
    same = bool(np.array_equal(per_scan, scans[("off", "time")]))
    gap = replays.max_pose_gap(per_scan,
                               replays.fixture("loop")["per_scan_poses"])
    line("resident_loop_replay", per_scan_bit_equal_to_classic=same,
         max_gap_to_fixture_m=round(gap, 5))
    if not (gap < POSE_TOL_M and (same or not out["bits"])):
        raise AssertionError(f"resident_loop: replay gap {gap}, classic "
                             f"bits {same}")
    return out


def _growth_graph(total: int, seed: int):
    """A ring like pgo_1k's (``pgo_problems``) of ``total`` poses: the
    true poses, the perturbed initial ones and the odometry measurements
    (true relative poses)."""
    import torch
    from pgslam_tpu_torch import se3
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(total) / total
    radius = 10.0 * max(1.0, total / 1024)
    R = se3.exp_so3(torch.as_tensor(np.stack(
        [np.zeros(total), np.zeros(total), ang], -1), dtype=torch.float32))
    t = torch.as_tensor(np.stack([radius * np.cos(ang), radius * np.sin(ang),
                                  np.zeros(total)], -1), dtype=torch.float32)
    truth = se3.make(R, t).numpy()
    init = truth.copy()
    init[1:] = init[1:] @ se3.exp(torch.as_tensor(
        rng.normal(size=(total - 1, 6)) * 0.05,
        dtype=torch.float32)).numpy()
    return truth, init


def resident_growth_run(dev):
    """``run(mode, kind)`` of :func:`phase_resident_growth`'s sequence: a
    ring like pgo_1k's (RESIDENT_GROWTH_START keyframes, then
    RESIDENT_GROWTH_APPEND more with odometry edges before each later
    optimize, RESIDENT_GROWTH_LOOPS queued loop constraints per optimize,
    one host pose write before optimize RESIDENT_DIRTY_AT) over
    RESIDENT_GROWTH_CALLS optimizes with ``OptimizerConfig(resident=
    mode)``, under an :class:`_OptimizeProbe` of ``kind``; returns its
    records. ``scripts/resident_profile.py`` profiles it."""
    from pgslam_tpu_torch.cloud import make_cloud
    from pgslam_tpu_torch.graph.pose_graph import MapManager
    from pgslam_tpu_torch.optimizer import Optimizer, OptimizerConfig
    total = RESIDENT_GROWTH_START + (RESIDENT_GROWTH_CALLS - 1) \
        * RESIDENT_GROWTH_APPEND
    truth, init = _growth_graph(total, seed=3)
    cov = np.eye(6, dtype=np.float32) * 0.01
    cloud = make_cloud(np.zeros((1, 3), np.float32), device=dev)

    class _NoLoopCloser:
        def add_new_vertex(self, v):
            pass

    def rel(a, b):
        return (np.linalg.inv(truth[a].astype(np.float64))
                @ truth[b]).astype(np.float32)

    def run(mode, kind):
        rng = np.random.default_rng(4)
        mm = MapManager()
        mm.set_loop_closer(_NoLoopCloser())
        opt = Optimizer(mm, OptimizerConfig(resident=mode), device=dev)
        opt.queue_mode = True
        mm.add_first_keyframe(cloud, init[0])
        n = 1
        with _OptimizeProbe(kind) as probe:
            for call in range(RESIDENT_GROWTH_CALLS):
                target = RESIDENT_GROWTH_START + call * RESIDENT_GROWTH_APPEND
                while n < target:
                    mm.add_new_keyframe(n - 1, init[n], rel(n - 1, n), cov,
                                        cloud)
                    n += 1
                if call == RESIDENT_DIRTY_AT:
                    g = mm.get_graph()
                    T = g.optimized_poses[n // 2].copy()
                    T[0, 3] += 0.01
                    mm.update_keyframe_transform(n // 2, T, mm.now())
                pairs = set()
                while len(pairs) < RESIDENT_GROWTH_LOOPS:
                    a, b = sorted(int(x) for x in rng.integers(0, n, 2))
                    if b - a > 1 and not mm.get_graph().has_edge(a, b):
                        pairs.add((a, b))
                for a, b in sorted(pairs):
                    opt.add_new_data(a, b, rel(a, b), cov)
                opt.process_pending()
        return probe.records

    return run


def phase_resident_growth(dev):
    """:func:`resident_growth_run`'s sequence (K3: V + E stays within
    K3_MAX_SIZE) through the mirror and the classic path
    (:func:`_resident_compare`). Bucket crossings rebuild; the other
    calls upload deltas, against the classic path's whole graph."""
    run = resident_growth_run(dev)
    out = _resident_compare("resident_growth", run, lambda n: n == 1,
                            K3_POSE_TOL_M, K3_ROT_TOL)
    if out["resident"]["rebuilds"] < 2 or out["resident"]["deltas"] < 1:
        raise AssertionError(f"resident_growth: {out['resident']}: no "
                             "bucket crossing rebuilt, or no delta call")
    return out


def _graph_from_problem(arrays):
    """A MapManager whose graph holds a pose-graph problem's poses and
    its edges but one: the last loop edge whose vertex pair no other edge
    joins, returned as the constraint to optimize with (its insert after
    the optimize passes the graph's duplicate-edge guard). The first
    V - 1 edges are odometry."""
    from pgslam_tpu_torch.graph.pose_graph import (LOOP_CONSTRAINT,
                                                   ODOM_CONSTRAINT,
                                                   MapManager, PoseGraph)
    poses, _, ef, et, eT, ec, _ = arrays
    V, E = len(poses), len(ef)
    pairs = {}
    for f, t in zip(ef, et):
        key = (min(f, t), max(f, t))
        pairs[key] = pairs.get(key, 0) + 1
    pending = max(e for e in range(V - 1, E)
                  if pairs[(min(ef[e], et[e]), max(ef[e], et[e]))] == 1)
    keep = np.arange(E) != pending
    g = PoseGraph(initial_vertex_capacity=V, initial_edge_capacity=E)
    g.n_vertices, g.n_edges = V, E - 1
    g.poses[:V] = g.optimized_poses[:V] = poses
    g.clouds = [None] * V
    g.edge_from[:E - 1], g.edge_to[:E - 1] = ef[keep], et[keep]
    g.edge_T[:E - 1], g.edge_cov[:E - 1] = eT[keep], ec[keep]
    g.edge_type[:E - 1] = np.where(np.arange(E)[keep] < V - 1,
                                   ODOM_CONSTRAINT, LOOP_CONSTRAINT)
    mm = MapManager()
    mm.graph, mm.fixed_vertex = g, 0
    return mm, (int(ef[pending]), int(et[pending]), eT[pending], ec[pending])


def phase_resident_16k(dev):
    """pgo_16k (16384 poses, 20479 edges, one loop edge the pending
    constraint) through the K4 loop, one optimize each way under the
    default PGOConfig (50 LM iterations): the mirror with
    writeback_pack="auto" (quat7 at this size) against the classic path
    (:func:`_resident_compare`): the solve's inputs bit-equal, the poses
    within the K4 loop's limits against itself (PGO_LIMITS, K3_ROT_TOL)
    plus quat7's round-off (QUAT7_TRANS_TOL, QUAT7_ROT_TOL); then the
    mirror with exact12, for its download bytes. The K4 loop keeps one
    synchronization per LM iteration."""
    from pgslam_tpu_torch.optim import pgo
    from pgslam_tpu_torch.optimizer import Optimizer, OptimizerConfig
    from pgslam_tpu_torch.pgo_problems import PROBLEMS, _numpy_problem
    arrays, _ = _numpy_problem(*PROBLEMS["pgo_16k"], seed=1, noise=0.05)
    V, E = len(arrays[0]), len(arrays[2])
    if pgo.route(pgo.PGOConfig(), V, 1 << (E - 1).bit_length(),
                 dev) != "pcg":
        raise AssertionError("resident_16k: pgo_16k does not take the K4 "
                             "loop")
    packs = []

    def run(mode, kind, pack="auto"):
        mm, (f, t, T, c) = _graph_from_problem(arrays)
        opt = Optimizer(mm, OptimizerConfig(resident=mode,
                                            writeback_pack=pack),
                        device=dev)
        with _OptimizeProbe(kind) as probe:
            opt.add_new_data(f, t, T, c)
        if opt._mirror is not None:
            packs.append(opt._mirror._st["pack"])
        return probe.records

    out = _resident_compare(
        "resident_16k", run, lambda n: n >= 1,
        PGO_LIMITS[("pgo_16k", "default")][0] + QUAT7_TRANS_TOL,
        K3_ROT_TOL + QUAT7_ROT_TOL)
    exact = run("auto", "time", "exact12")[0]
    quat = out["resident"]
    line("resident_16k_packs", auto_pack=packs[0],
         quat7_download_bytes=round(quat["download_bytes"]),
         exact12_download_bytes=exact["download"],
         exact12_ms_per_optimize=round(exact["ms"], 3),
         resident_syncs=",".join(map(str, out["syncs"])),
         classic_syncs=",".join(map(str, out["classic_syncs"])))
    if not (packs[:2] == ["quat7", "quat7"] and packs[-1] == "exact12"
            and exact["download"] > quat["download_bytes"] > 0
            and exact["k4"] > 0):
        raise AssertionError(f"resident_16k: packs {packs}, downloads "
                             f"{exact['download']} / "
                             f"{quat['download_bytes']}")
    return out


def phase_resident(dev):
    """The three resident phases."""
    return {"loop": phase_resident_loop(dev),
            "growth": phase_resident_growth(dev),
            "16k": phase_resident_16k(dev)}


# The mesh path (parallel/multichip.py, parallel/sharded_icp.py,
# MultiAgentSlam(mesh=)): every mesh position on this card unless the
# machine has more. mesh_match's reference cut into tp shards.
MESH_TP = (2, 4, 8)
# mesh_register: the card's sharded registration against the same call
# on the CPU (plain K1): T within MESH_T_TOL (norm of the twist between
# them), iterations and flags equal; the card's minimizer may round
# differently from the CPU's.
MESH_T_TOL = 1e-5
# The JAX package's dry run on 8 virtual devices, MULTICHIP_r05.json:
# final-pose error at most 0.12 cm.
MESH_DRYRUN_JAX_CM = 0.12
# tests/test_multi_agent.py:80-112: the fleet on a (dp = 4, tp = 2) mesh
# within this of the single-device fleet's final poses (and
# FLEET_ERR_GATE_M of the truth), with equal vertex counts.
MESH_FLEET_GAP_M = 0.05
MESH_FLEET_TEST_STEPS = 8
# The tp = 1 route (one K2 launch per dp chunk) on the same corridor.
MESH_TP1_STEPS = 4


@contextlib.contextmanager
def uncounted():
    """Kernel launches made inside are left out of every wrapper's counts
    and tallies: a reference run beside a path (a single-device fleet,
    icp_core) is not that path's run."""
    from pgslam_tpu_torch.ops.icp_fused import fused_icp_register
    from pgslam_tpu_torch.ops.knn import knn
    from pgslam_tpu_torch.optim.lm import lm_optimize
    from pgslam_tpu_torch.optim.pcg import pcg_solve
    launches = [(w, w.launches)
                for w in (knn, fused_icp_register, lm_optimize, pcg_solve)]
    tallies = [(c, collections.Counter(c)) for c in (
        knn.shapes, fused_icp_register.batch_sizes, pcg_solve.shapes)]
    steps = {d: t.clone() for d, t in pcg_solve.cg_steps.items()}
    try:
        yield
    finally:
        for w, n in launches:
            w.launches = n
        for c, saved in tallies:
            c.clear()
            c.update(saved)
        for d, t in pcg_solve.cg_steps.items():
            t.copy_(steps[d]) if d in steps else t.zero_()


def mesh_names(mesh) -> str:
    """A mesh's device grid as ``dp x tp:dev,dev;dev,dev``."""
    dp, tp = mesh.devices.shape
    return f"{dp}x{tp}:" + ";".join(",".join(str(d) for d in row)
                                    for row in mesh.devices)


def mesh_match_inputs(scans):
    """phase mesh_match's inputs: the loop's 512 x 1536 and the
    verification's 2048 x 8192 (phase k1's points), every 97th query
    masked, a sixteenth of the references masked from a third on, and
    forced ties: the first eighth of the references repeated as the last
    eighth (equal distances far apart in id, in other shards) and every
    8th query placed on one of those references."""
    from pgslam_tpu_torch.replays import loop_sequence_golden
    loop, _, truth = loop_sequence_golden()
    world = [(c @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
             for c, T in zip(loop[:4], truth[:4])]
    out = []
    for name, q, r in (("512x1536", world[3][:512],
                        np.concatenate(world[:3])[:1536]),
                       ("2048x8192", scans[1][:2048], scans[0][:8192])):
        q, r = q.copy(), r.copy()
        n, m = len(q), len(r)
        r[m - m // 8:] = r[:m // 8]
        q[::8] = r[(np.arange(0, n, 8) * 7) % (m // 8)]
        qm = np.ones(n, bool)
        qm[::97] = False
        rm = np.ones(m, bool)
        rm[m // 3:m // 3 + m // 16] = False
        out.append((name, q, qm, r, rm))
    return out


def phase_mesh_match(dev, scans):
    """The sharded registration's match (K1 on each of tp reference
    shards, candidates merged in shard order) against K1 over the whole
    reference: ids, d2 and the candidate points bit for bit, at tp = 2,
    4, 8 and k = 1, 8; K1 over the whole against the plain version on
    the card as phase k1 holds it. Times of the merged match and the
    whole K1 call. Returns the largest d2 gap to the plain version."""
    import torch
    from pgslam_tpu_torch.ops.knn import knn, knn_plain
    from pgslam_tpu_torch.parallel.multichip import shard_match
    worst = 0.0
    for name, q, qm, r, rm in mesh_match_inputs(scans):
        qt, qmt, rt, rmt = (torch.as_tensor(a, device=dev)
                            for a in (q, qm, r, rm))
        for k in (1, 8):
            whole = knn(qt, qmt, rt, rmt, k=k)
            err = k1_check(f"mesh_match {name} k={k}", whole,
                           knn_plain(qt, qmt, rt, rmt, k=k))
            worst = max(worst, err)
            whole_ms, _ = timed(lambda: knn(qt, qmt, rt, rmt, k=k), 10)
            for tp in MESH_TP:
                m = len(r) // tp
                shards = [(rt[j * m:(j + 1) * m], rmt[j * m:(j + 1) * m],
                           None) for j in range(tp)]
                got, pts, _ = shard_match(qt, qmt, shards, k, dev)
                equal = (torch.equal(got.ids, whole.ids)
                         and torch.equal(got.dists2, whole.dists2)
                         and torch.equal(pts, rt[whole.ids.long()]))
                ms, _ = timed(lambda: shard_match(qt, qmt, shards, k, dev),
                              10)
                line("mesh_match", shape=name, k=k, tp=tp,
                     shard=f"{len(q)}x{m}", mesh=f"{tp}x{dev}",
                     bits_equal_whole_k1=equal, ids_equal_plain=True,
                     d2_err_plain=err, merged_ms=round(ms, 4),
                     whole_k1_ms=round(whole_ms, 4))
                if not equal:
                    raise AssertionError(f"mesh_match {name} k={k} tp={tp}: "
                                         "the merged match is not K1's over "
                                         "the whole reference")
    return worst


def mesh_register_inputs(device, B=4, N=128, Mref=512, seed=42):
    """tests/test_parallel.py:120-166's scene: wavy surfaces with 8-NN
    normals (computed on the CPU, so both devices get the same arrays),
    noisy reading subsets moved by small twists. Returns (reading cloud,
    reference cloud, T0) on ``device``."""
    import torch
    from pgslam_tpu_torch import se3
    from pgslam_tpu_torch.cloud import make_cloud, stack_clouds
    from pgslam_tpu_torch.ops.filters import compute_normals
    rng = np.random.default_rng(seed)
    twists = rng.normal(size=(B, 6)).astype(np.float32) * 0.03
    refs, readings = [], []
    for b in range(B):
        pts = rng.uniform(-3, 3, size=(Mref, 3)).astype(np.float32)
        pts[:, 2] = 0.3 * np.sin(pts[:, 0]) + 0.2 * np.cos(1.3 * pts[:, 1])
        nrm = compute_normals(make_cloud(pts, device="cpu"), knn_k=8
                              ).descriptors["normals"].numpy()
        refs.append(make_cloud(pts, descriptors={"normals": nrm},
                               device=device))
        T = se3.exp(torch.as_tensor(twists[b]))
        noisy = pts[:N] + rng.normal(0, 0.02, (N, 3)).astype(np.float32)
        readings.append(make_cloud(
            se3.apply(se3.inverse(T), torch.as_tensor(noisy)).numpy(),
            device=device))
    T0 = torch.eye(4, device=device).repeat(B, 1, 1)
    return stack_clouds(readings), stack_clouds(refs), T0


def mesh_register_config():
    from pgslam_tpu_torch.ops import outlier as O
    from pgslam_tpu_torch.ops.icp import ICPConfig
    return ICPConfig(error="point_to_plane", max_iterations=20,
                     outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)))


def phase_mesh_register(dev):
    """``make_sharded_register`` at tests/test_parallel.py:120-166's
    shapes (B = 4, 128 vs 512, point-to-plane) on a dp = 4 x tp = 2 mesh
    of card positions, against the same call on CPU positions (plain K1):
    T within MESH_T_TOL, iterations and flags equal. One agent a dp
    group, so each agent also equals the port's icp_core on the card bit
    for bit."""
    import torch
    from pgslam_tpu_torch import se3
    from pgslam_tpu_torch.ops.icp import icp_core
    from pgslam_tpu_torch.parallel.multichip import make_mesh
    from pgslam_tpu_torch.parallel.sharded_icp import make_sharded_register
    cfg = mesh_register_config()
    mesh = make_mesh(8, tp=2, devices=[dev] * 8)
    rd, rf, T0 = mesh_register_inputs(dev)
    reg = make_sharded_register(mesh, cfg)
    ms, card = timed(lambda: reg(rd, rf, T0), 3)
    cpu = make_sharded_register(make_mesh(8, tp=2, devices=["cpu"] * 8),
                                cfg)(*mesh_register_inputs("cpu"))
    gap = max(float(se3.log(se3.inverse(card.T[b].cpu()) @ cpu.T[b]).norm())
              for b in range(card.T.shape[0]))
    flags = all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
                for f in ("iterations", "converged", "max_iter_reached",
                          "diverged"))
    core_equal = True
    for b in range(card.T.shape[0]):
        with uncounted():
            one = icp_core(rd.map(lambda a: a[b]), rf.map(lambda a: a[b]),
                           T0[b], cfg)
        core_equal &= all(torch.equal(getattr(card, f)[b], v)
                          for f, v in vars(one).items())
    line("mesh_register", mesh=mesh_names(mesh), agents=4,
         shape="128 vs 512, point_to_plane",
         iterations=",".join(map(str, card.iterations.tolist())),
         T_gap_to_cpu=gap, flags_equal_cpu=flags,
         b1_bits_equal_icp_core=core_equal, ms=round(ms, 3))
    if not (gap < MESH_T_TOL and flags and core_equal):
        raise AssertionError(f"mesh_register: T {gap} from the CPU run "
                             f"(limit {MESH_T_TOL}), flags equal {flags}, "
                             f"icp_core bits {core_equal}")


def phase_mesh_step(dev):
    """``sharded_icp_step`` at tests/test_parallel.py:67-117's inputs
    under both merges, bit-equal to each other; then
    ``dryrun_multichip(8)`` on 8 card positions (dp = 4 x tp = 2, 8
    agents, 10 scans), its final errors below its 0.05 m, printed beside
    the JAX package's recorded run."""
    import torch
    from pgslam_tpu_torch.ops import outlier as O
    from pgslam_tpu_torch.ops.icp import ICPConfig
    from pgslam_tpu_torch.parallel.multichip import (DRYRUN_TOL_M,
                                                     dryrun_multichip,
                                                     make_mesh,
                                                     sharded_icp_step)
    rng = np.random.default_rng(42)
    ref = rng.uniform(-3, 3, size=(8, 256, 3)).astype(np.float32)
    args = tuple(torch.as_tensor(a, device=dev) for a in (
        ref[:, :64] + 0.05, np.ones((8, 64), bool), ref,
        np.ones((8, 256), bool), np.tile(np.eye(4, dtype=np.float32),
                                         (8, 1, 1))))
    mesh = make_mesh(8, tp=2, devices=[dev] * 8)
    cfg = ICPConfig(outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)))
    outs = {}
    for merge in ("all_gather", "ring"):
        step = sharded_icp_step(mesh, cfg, merge)
        ms, outs[merge] = timed(lambda: step(*args), 3)
        outs[merge + "_ms"] = ms
    equal = all(torch.equal(a, b) for a, b in zip(outs["all_gather"],
                                                  outs["ring"]))
    t0 = time.perf_counter()
    errs = dryrun_multichip(8, devices=[dev] * 8)
    torch.cuda.synchronize()
    line("mesh_step", mesh=mesh_names(mesh), merges_bits_equal=equal,
         all_gather_ms=round(outs["all_gather_ms"], 3),
         ring_ms=round(outs["ring_ms"], 3),
         overlap_min=round(float(outs["all_gather"][1].min()), 5),
         dryrun_agents=len(errs),
         dryrun_final_err_max_cm=round(100 * max(errs), 5),
         jax_dryrun_final_err_max_cm=MESH_DRYRUN_JAX_CM,
         dryrun_wall_s=round(time.perf_counter() - t0, 3))
    if not (equal and max(errs) < DRYRUN_TOL_M):
        raise AssertionError(f"mesh_step: merges equal {equal}, dry run "
                             f"errors {errs}")


def phase_mesh_fleet(dev, seq, fleet_ms, fleet_poses, fleet_nv):
    """The fleet at full width on a mesh: BASELINE config 5 (16 agents,
    FLEET_STEPS steps as phase fleet drives them) on ``make_mesh(16,
    tp=2)`` of card positions (dp = 8 x tp = 2), each agent's final error
    within FLEET_ERR_GATE_M, ms per step beside the single-device fleet's,
    the largest gap to its final poses and both vertex counts printed
    (the single-device fleet registers through K2, the mesh through the
    sharded loop, and 40 steps of queued closures cross knife edges).
    Then tests/test_multi_agent.py:80-112's case (B = 4, 8 steps of the
    512-point corridor, dp = 4 x tp = 2) against the single-device fleet
    on the card, gated as that test is, and the tp = 1 route (one K2
    launch per dp chunk) bit-equal to the unchunked K2 batch. The
    single-device fleets beside them run uncounted. Returns ms per
    step."""
    from pgslam_tpu_torch import fleet_problems as FP
    from pgslam_tpu_torch.datasets import corridor_sequence
    from pgslam_tpu_torch.ops.icp_fused import fused_icp_register
    from pgslam_tpu_torch.parallel.multi_agent import MultiAgentSlam
    from pgslam_tpu_torch.parallel.multichip import make_mesh
    mesh = make_mesh(16, tp=2, devices=[dev] * 16)
    fleet, step_ms, worst_any, errs = drive_fleet(dev, seq, FLEET_STEPS,
                                                  mesh=mesh)
    closer = fleet.loop_closer
    ms = float(np.sum(step_ms)) / FLEET_STEPS
    gap = float(np.linalg.norm(fleet.poses()[:, :3, 3]
                               - fleet_poses[:, :3, 3], axis=1).max())
    line("mesh_fleet", mesh=mesh_names(mesh), agents=fleet.n_agents,
         steps=FLEET_STEPS, config="config5_multi_agent",
         ms_per_step=round(ms, 3), single_device_ms_per_step=round(fleet_ms,
                                                                   3),
         median_step_ms=round(float(np.median(step_ms)), 3),
         keyframes=fleet.get_graph().n_vertices,
         single_device_keyframes=fleet_nv,
         max_gap_to_single_device_m=round(gap, 5),
         closures_accepted=closer.accepted, closures_rejected=closer.rejected,
         final_err_max_m=round(max(errs), 5),
         err_max_any_step_m=round(worst_any, 5))
    if not max(errs) <= FLEET_ERR_GATE_M:
        raise AssertionError(f"mesh_fleet: final error {max(errs)} m (gate "
                             f"{FLEET_ERR_GATE_M})")

    scans, odom, truth = corridor_sequence(
        np.random.default_rng(7), n_scans=12, scan_points=512, step=0.4,
        noise=0.003, odom_noise=0.005, length=30.0)
    B = 4

    def drive(fleet, steps, count=True):
        """Agent b on scan i + b; each step's poses. A reference fleet's
        launches (count=False) are not the mesh path's."""
        poses = []
        for i in range(steps):
            with contextlib.nullcontext() if count else uncounted():
                fleet.add_data_batch(i, "world", np.stack(
                    [odom[i + b] for b in range(B)]),
                    np.eye(4, dtype=np.float32),
                    [scans[i + b] for b in range(B)])
            poses.append(fleet.poses().copy())
        return np.stack(poses)

    small = make_mesh(8, tp=2, devices=[dev] * 8)
    on_mesh = MultiAgentSlam(FP.fleet_config(), n_agents=B, mesh=small)
    plain = MultiAgentSlam(FP.fleet_config(), n_agents=B, device=dev)
    drive(on_mesh, MESH_FLEET_TEST_STEPS)
    drive(plain, MESH_FLEET_TEST_STEPS, count=False)
    last = MESH_FLEET_TEST_STEPS - 1
    dev_gap = [float(np.linalg.norm(on_mesh.poses()[b][:3, 3]
                                    - plain.poses()[b][:3, 3]))
               for b in range(B)]
    truth_err = [float(np.linalg.norm(on_mesh.poses()[b][:3, 3]
                                      - truth[last + b][:3, 3]))
                 for b in range(B)]
    nv = (on_mesh.get_graph().n_vertices, plain.get_graph().n_vertices)
    line("mesh_fleet_test_case", mesh=mesh_names(small), agents=B,
         steps=MESH_FLEET_TEST_STEPS, max_gap_to_single_device_m=max(dev_gap),
         final_err_max_m=max(truth_err), keyframes=nv[0],
         single_device_keyframes=nv[1])
    if not (max(dev_gap) < MESH_FLEET_GAP_M
            and max(truth_err) < FLEET_ERR_GATE_M and nv[0] == nv[1]):
        raise AssertionError(f"mesh_fleet_test_case: gaps {dev_gap}, "
                             f"errors {truth_err}, vertices {nv}")

    # tp = 1: shard_batch, then one K2 launch per dp chunk of one agent;
    # every step's poses bit-equal to the unchunked K2 batch's (K2's bits
    # do not depend on its layout, which follows the batch size).
    dp_mesh = make_mesh(B, tp=1, devices=[dev] * B)
    before = fused_icp_register.launches
    chunked = drive(MultiAgentSlam(FP.fleet_config(), n_agents=B,
                                   mesh=dp_mesh), MESH_TP1_STEPS)
    chunk_launches = fused_icp_register.launches - before
    whole = drive(MultiAgentSlam(FP.fleet_config(), n_agents=B, device=dev),
                  MESH_TP1_STEPS, count=False)
    equal = np.array_equal(chunked, whole)
    line("mesh_fleet_tp1", mesh=mesh_names(dp_mesh), agents=B,
         steps=MESH_TP1_STEPS, k2_launches=chunk_launches,
         bits_equal_whole_batch=equal)
    # An agent's first scan seeds its map and registers nothing.
    if not (equal and chunk_launches >= B * (MESH_TP1_STEPS - 1)):
        raise AssertionError(f"mesh_fleet_tp1: poses equal {equal}, K2 "
                             f"launches {chunk_launches}")
    return ms


def phase_mesh_loop(dev):
    """The fleet of one on the golden loop at dp = 1 x tp = 8 with
    synchronous closures (tests/test_golden_replay.py:117-121), held to
    golden_replay.npz (POSE_TOL_M, +-1 scan); the gap to the
    single-device fleet of one on the icp_core route is printed (one
    agent a dp group: the same registration arithmetic)."""
    from pgslam_tpu_torch import replays
    from pgslam_tpu_torch.parallel.multichip import make_mesh
    gold = replays.fixture("loop")
    mesh = make_mesh(8, tp=8, devices=[dev] * 8)
    per_scan, loops, kf, wall = fleet_of_one(dev, "auto", mesh=mesh)
    with uncounted():
        core = fleet_of_one(dev, "off")[0]
    gap = replays.max_pose_gap(per_scan, gold["per_scan_poses"], window=1)
    line("mesh_loop", mesh=mesh_names(mesh), scans=len(per_scan),
         keyframes=kf, loop_edges=loops, gap_to_fixture_m=round(gap, 5),
         gap_to_icp_core_fleet_m=float(np.abs(per_scan - core).max()),
         ms_per_scan=round(1e3 * wall / len(per_scan), 3))
    if not (np.isfinite(per_scan).all() and gap < POSE_TOL_M):
        raise AssertionError(f"mesh_loop: {gap} m from the fixture (limit "
                             f"{POSE_TOL_M})")


def phase_mesh_devices(dev):
    """With two cards or more: the register on a tp mesh whose groups
    span two cards, and the tp = 1 route (shard_batch, then one K2 launch
    per dp chunk on its card), each bit-equal to the one-card run. On one
    card the line says so."""
    import torch
    from pgslam_tpu_torch.ops.icp import ICPConfig
    from pgslam_tpu_torch.ops import outlier as O
    from pgslam_tpu_torch.parallel.batched import (batched_register,
                                                   concat_results,
                                                   shard_batch)
    from pgslam_tpu_torch.parallel.multichip import make_mesh
    from pgslam_tpu_torch.parallel.sharded_icp import make_sharded_register
    n = torch.cuda.device_count()
    if n < 2:
        print(f"[mesh_devices] devices: {n}, mesh positions share {dev}",
              flush=True)
        return
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    cfg = mesh_register_config()
    args = mesh_register_inputs(dev)
    one = make_sharded_register(make_mesh(8, tp=2, devices=[dev] * 8),
                                cfg)(*args)
    two_mesh = make_mesh(8, tp=2, devices=cards * 4)
    two = make_sharded_register(two_mesh, cfg)(*args)
    equal = all(torch.equal(getattr(one, f), getattr(two, f))
                for f in vars(one))
    # tp = 1 with K2 (point-to-point: the fleet's registration).
    k2_cfg = ICPConfig(max_iterations=20,
                       outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)))
    whole = batched_register(*args, k2_cfg, fused="on")
    dp_mesh = make_mesh(4, tp=1, devices=cards * 2)
    chunks = shard_batch(dp_mesh)(args)
    split = concat_results([batched_register(*c, k2_cfg, fused="on")
                            for c in chunks], dev)
    tp1_equal = all(torch.equal(getattr(whole, f), getattr(split, f))
                    for f in vars(whole) if getattr(whole, f) is not None)
    line("mesh_devices", devices=n, mesh=mesh_names(two_mesh),
         bits_equal_one_card=equal, tp1_mesh=mesh_names(dp_mesh),
         tp1_chunk_devices=",".join(str(c[0].points.device)
                                    for c in chunks),
         tp1_bits_equal_whole_batch=tp1_equal)
    if not (equal and tp1_equal):
        raise AssertionError(f"mesh_devices: two cards give other bits "
                             f"(tp = 2 {equal}, tp = 1 {tp1_equal})")


class _FallbackWatch(logging.Handler):
    """Every time the optimizer's resident path failed and its batch went
    the classic way (the reference's fail-soft, which on the card must
    not hide a broken mirror)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.failures = []

    def emit(self, record):
        if "resident optimize failed" in record.getMessage():
            self.failures.append(record.getMessage())

    def check(self, where: str) -> None:
        if self.failures:
            raise AssertionError(f"{where}: the resident optimize fell back "
                                 f"to the classic path: {self.failures}")


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
    argv = sys.argv[1:]
    tree = os.path.dirname(os.path.abspath(__file__))
    if "--k4-tree" in argv:
        tree = os.path.abspath(argv[argv.index("--k4-tree") + 1])
    sys.path.insert(0, tree)
    try:
        import pgslam_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    if not os.path.abspath(pgslam_tpu_torch.__file__).startswith(tree):
        print(f"chip_smoke: imported {pgslam_tpu_torch.__file__}, not the "
              f"port under {tree}", file=sys.stderr)
        return 2
    from pgslam_tpu_torch.ops.icp_fused import fused_icp_register
    from pgslam_tpu_torch.ops.knn import knn
    from pgslam_tpu_torch.optim.lm import lm_optimize
    from pgslam_tpu_torch.optim.pcg import pcg_solve
    from pgslam_tpu_torch.fleet_problems import config5_sequence
    from pgslam_tpu_torch.replays import corridor_64k_sequence

    dev = torch.device("cuda", 0)
    fallbacks = _FallbackWatch()
    logging.getLogger("pgslam_tpu_torch.optimizer").addHandler(fallbacks)
    phase_device_and_build()
    if "--mesh-devices" in argv:
        phase_mesh_devices(dev)
        return 0
    if "--resident" in argv:
        phase_resident(dev)
        fallbacks.check("resident")
        return 0
    if "--k4-tree" in argv:
        phase_k4_tree(dev, argv[argv.index("--k4-tree") + 1])
        return 0
    if "--crossover" in sys.argv[1:]:
        phase_crossover(dev)
        return 0
    if "--k3-clusters" in sys.argv[1:]:
        phase_k3_clusters(dev)
        return 0
    if "--k4-layouts" in sys.argv[1:]:
        phase_k4_layouts(dev)
        return 0
    if "--replay-witness" in sys.argv[1:]:
        phase_replay_witness(dev)
        return 0
    seq = corridor_64k_sequence()
    if "--k2-layouts" in sys.argv[1:]:
        phase_k2_layouts(dev, seq)
        return 0
    if "--k1-layouts" in sys.argv[1:]:
        phase_k1_layouts(dev, seq[0])
        return 0
    scans = seq[0]
    k1_err, k1_times = phase_k1(dev, scans)
    (k2_err, k2_ms, k2_pms, k2_bnd, k2_lay, k2_dms), k2_aa_err = phase_k2(
        dev, seq)
    k2s = phase_k2_stream(dev)
    k2one = phase_k2_single(dev)
    hcfg, refs, packets, offsets = headline_setup(dev)
    (k2h_err, k2h_ms, k2h_pms, k2h_bnd, k2h_lay, k2h_dms,
     k2h_b16) = phase_k2_headline(dev, hcfg, refs, packets, offsets)
    k3 = phase_k3(dev)
    k4 = phase_k4(dev)

    wrappers = (knn, fused_icp_register, lm_optimize, pcg_solve)

    def reset():
        for w in wrappers:
            w.launches = 0
        fused_icp_register.batch_sizes.clear()
        knn.shapes.clear()
        pcg_solve.shapes.clear()
        for total in pcg_solve.cg_steps.values():
            total.zero_()

    def counts():
        return [w.launches for w in wrappers]

    k1_shapes = {}
    k1_checked = {t["shape"] for t in k1_times.values()}

    k4_shapes = {}
    k4_checked = {(k4[(n, "initial")]["V"], k4[(n, "initial")]["E"])
                  for n in K4_CASES}

    def top_shapes(path):
        k1_shapes[path] = knn.shapes.most_common(K1_TOP_SHAPES)
        missed = [s for s, _ in k1_shapes[path] if s not in k1_checked]
        if missed:
            raise AssertionError(f"the {path} path launched K1 at {missed}, "
                                 "which phase k1 neither checks nor times")
        top = pcg_solve.shapes.most_common(K1_TOP_SHAPES)
        steps = sum(int(t) for t in pcg_solve.cg_steps.values())
        k4_shapes[path] = (top, steps / pcg_solve.launches
                           if pcg_solve.launches else None)
        missed = [s for s, _ in top if s not in k4_checked]
        if missed:
            raise AssertionError(f"the {path} path launched K4 at {missed}, "
                                 "which phase k4 neither checks nor times")

    reset()
    _, corridor_ms = phase_replay(dev, "corridor_64k", keyframes=4, loops=0)
    if knn.launches == 0:
        raise AssertionError("corridor_64k replay never launched K1")
    phase_replay(dev, "loop", keyframes=20, loops=1)
    per_scan = counts()
    top_shapes("per_scan")
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
    top_shapes("pgo")

    reset()
    batch_ms = phase_batched(dev, hcfg, refs, packets, offsets)
    batched = counts()
    top_shapes("batched")
    if batched[1] == 0 or fused_icp_register.batch_sizes[128] == 0:
        raise AssertionError("the batched path never launched K2 at B=128")
    del refs

    seq5 = config5_sequence()
    reset()
    fleet_ms, fleet_poses, fleet_nv = phase_fleet(dev, seq5)
    fleet = counts()
    top_shapes("fleet")
    fleet_batches = dict(fused_icp_register.batch_sizes)
    if min(fleet[:3]) == 0 or fleet_batches.get(16, 0) == 0:
        raise AssertionError(f"a kernel of the fleet path never ran (K1-K4 "
                             f"{fleet}, K2 batch sizes {fleet_batches})")
    fleet_b16 = phase_fleet_split(dev, seq5)
    phase_fleet_golden(dev)

    classic_loops, corridor_lag0 = classic_baselines(dev)
    reset()
    lag2_ms = phase_loop_lag2(dev)
    phase_loop_deferred0(dev, classic_loops)
    stream_ms = phase_loop_stream4(dev)
    corridor_lag_ms = phase_corridor_lag2(dev, seq[2], corridor_lag0,
                                          corridor_ms)
    mt_ms = phase_mt_loop(dev)
    deferred = counts()
    top_shapes("deferred")
    deferred_batches = dict(fused_icp_register.batch_sizes)
    if min(deferred[:3]) == 0 or deferred_batches.get(STREAM_BATCH, 0) == 0:
        raise AssertionError(f"a kernel of the deferred path never ran "
                             f"(K1-K4 {deferred}, K2 batch sizes "
                             f"{deferred_batches})")
    reset()
    config_ms = {"replay_long": phase_replay_long(dev),
                 "replay_yaml_clover": phase_replay_yaml(dev),
                 "replay_p2plane": phase_replay_p2plane(dev),
                 "replay_grid": phase_replay_grid(dev)}
    phase_resume(dev)
    config = counts()
    top_shapes("config")
    if min(config[:3]) == 0:
        raise AssertionError(f"a kernel of the config and persistence path "
                             f"never ran (K1-K4 {config})")
    fused1_ms = {f"{n}_off": route_off_ms(dev, n)
                 for n in ("loop", "corridor_64k")}
    reset()
    fused1_ms["loop_on"] = phase_replay_fused1(
        dev, "loop", 20, 1, FUSED1_LOOP_TOL_M, fused1_ms["loop_off"])
    fused1_ms["corridor_64k_on"] = phase_replay_fused1(
        dev, "corridor_64k", 4, 0, POSE_TOL_M, fused1_ms["corridor_64k_off"])
    fused1 = counts()
    top_shapes("fused_single")
    fused1_batches = dict(fused_icp_register.batch_sizes)
    if min(fused1[:3]) == 0 or set(fused1_batches) != {1}:
        raise AssertionError(f"a kernel of the single-scan route never ran, "
                             f"or K2 ran at another batch (K1-K4 {fused1}, "
                             f"K2 batch sizes {fused1_batches})")
    fused1_idle = phase_fused1_idle(dev)
    phase_native(dev)
    reset()
    resident_out = phase_resident(dev)
    resident_path = counts()
    top_shapes("resident")
    if resident_path[2] == 0 or resident_path[3] == 0:
        raise AssertionError(f"a kernel of the resident path never ran "
                             f"(K1-K4 {resident_path})")
    mesh_match_err = phase_mesh_match(dev, scans)
    reset()
    phase_mesh_register(dev)
    phase_mesh_step(dev)
    mesh_fleet_ms = phase_mesh_fleet(dev, seq5, fleet_ms, fleet_poses,
                                     fleet_nv)
    phase_mesh_loop(dev)
    phase_mesh_devices(dev)
    mesh_path = counts()
    top_shapes("mesh")
    if min(mesh_path[:3]) == 0:
        raise AssertionError(f"a kernel of the mesh path never ran (K1-K4 "
                             f"{mesh_path})")
    fallbacks.check("every path")
    line("launches", per_scan=",".join(map(str, per_scan)),
         pgo=",".join(map(str, pgo_path)), batched=",".join(map(str, batched)),
         fleet=",".join(map(str, fleet)),
         deferred=",".join(map(str, deferred)),
         config=",".join(map(str, config)),
         fused_single=",".join(map(str, fused1)),
         resident=",".join(map(str, resident_path)),
         mesh=",".join(map(str, mesh_path)),
         fleet_k2_batch_sizes=",".join(f"{b}x{n}" for b, n
                                       in sorted(fleet_batches.items())),
         deferred_k2_batch_sizes=",".join(
             f"{b}x{n}" for b, n in sorted(deferred_batches.items())),
         order="k1,k2,k3,k4",
         **{f"{p}_k1_shapes": ",".join(f"{q}x{r}x{k}:{c}"
                                       for (q, r, k), c in top) or "none"
            for p, top in k1_shapes.items()},
         **{f"{p}_k4_shapes": ",".join(f"{v}x{e}:{c}"
                                       for (v, e), c in top) or "none"
            for p, (top, _) in k4_shapes.items()},
         **{f"{p}_k4_mean_cg_steps": (None if mean is None
                                      else round(mean, 3))
            for p, (_, mean) in k4_shapes.items()})

    paths = {"per_scan": per_scan, "pgo": pgo_path, "batched": batched,
             "fleet": fleet, "deferred": deferred, "config": config,
             "fused_single": fused1, "resident": resident_path,
             "mesh": mesh_path}

    k1_main = k1_times["2048x8192_k1"]
    k4_16k, k4_1k = k4[("pgo_16k", "initial")], k4[("pgo_1k", "initial")]
    k3_err, k3_ms, k3_pms, k3_bnd, k3_layout = k3["500_poses_500_edges"]
    k3_1k = k3["pgo_1k_default"]
    rows = [
        ("K1 knn", "knn.cu", "pgslam_tpu/ops/knn_pallas.py:173",
         max(k1_err, mesh_match_err), k1_main["ms"], k1_main["plain_ms"],
         k1_main["bound"],
         {"shape": "2048 x 8192, k = 1", "layout": k1_main["layout"],
          "device_ms": k1_main["device_ms"],
          "cdist_topk_ms": k1_main["cdist_topk_ms"],
          "s1_ms": k1_main["s1_ms"], "s1_device_ms": k1_main["s1_device_ms"],
          "by_shape": {n: {f: (v[0] if f == "bound" else v)
                           for f, v in t.items()}
                       for n, t in k1_times.items()},
          "top_shapes_by_path": {p: [f"{q}x{r}x{k}:{c}"
                                     for (q, r, k), c in top]
                                 for p, top in k1_shapes.items()},
          "config_ms_per_scan": config_ms,
          "mesh_fleet_ms_per_step": mesh_fleet_ms}),
        ("K2 icp_fused", "icp_fused.cu", "pgslam_tpu/ops/icp_pallas.py:667",
         max(k2h_err, k2_err, k2_aa_err, k2s[0], k2one[0]), k2h_ms, k2h_pms,
         k2h_bnd,
         {"shape": "128 x 1024 vs 8192, batched_icp_config",
          "layout": layout_name(k2h_lay), "device_ms": k2h_dms,
          "verification_b1_layout": layout_name(k2_lay),
          "verification_b1_device_ms": k2_dms,
          "anderson": "in-kernel, m 2-4 checked",
          "anderson_max_abs_err": k2_aa_err,
          "verification_b1_ms": k2_ms, "verification_b1_plain_ms": k2_pms,
          "verification_b1_bound_ms": k2_bnd[0],
          "batched_ms_per_batch": batch_ms, "fleet_ms_per_step": fleet_ms,
          "stream_b4_shape": "4 x 512 vs 1536, the loop's point-to-point",
          "stream_b4_layout": layout_name(k2s[4]),
          "stream_b4_max_abs_err": k2s[0], "stream_b4_ms": k2s[1],
          "stream_b4_plain_ms": k2s[2], "stream_b4_bound_ms": k2s[3][0],
          "stream_b4_device_ms": k2s[5],
          "b16_bound_ms": k2h_b16[0],
          "fleet_b16_bound_ms_per_launch": fleet_b16[0],
          "fleet_b16_launches_split_run": fleet_b16[2],
          "single_b1_shape": "1 x 512 vs 1536, the loop's point-to-point: "
                             "a scan under PGSLAM_FUSED_SINGLE=1",
          "single_b1_layout": layout_name(k2one[4]),
          "single_b1_max_abs_err": k2one[0], "single_b1_ms": k2one[1],
          "single_b1_plain_ms": k2one[2], "single_b1_bound_ms": k2one[3][0],
          "single_b1_device_ms": k2one[5],
          "fused_single_ms_per_scan": fused1_ms,
          "fused_single_profile": {k: {f: v for f, v in p.items()
                                       if f != "by_group"}
                                   for k, p in fused1_idle.items()},
          "deferred_ms_per_scan": {
              "loop_lag2": lag2_ms, "loop_stream4": stream_ms,
              "loop_mt_free_running": mt_ms,
              "corridor_64k_lag0": corridor_lag_ms[0],
              "corridor_64k_lag2": corridor_lag_ms[1]}}),
        ("K3 lm", "lm.cu", "pgslam_tpu/optim/lm_pallas.py:1142",
         k3_err, k3_ms, k3_pms, k3_bnd,
         {"shape": "500 poses + 500 edges, default PGOConfig",
          "clusters": k3_layout.clusters,
          "pgo_1k_default_ms": k3_1k[1], "pgo_1k_default_plain_ms": k3_1k[2],
          "pgo_1k_default_bound_ms": k3_1k[3][0],
          "pgo_1k_default_clusters": k3_1k[4].clusters,
          "resident_ms_per_optimize": {
              k: {"resident": v["resident"]["ms"],
                  "classic": v["classic"]["ms"],
                  "upload_bytes": v["resident"]["upload_bytes"],
                  "classic_upload_bytes": v["classic"]["upload_bytes"],
                  "syncs": sorted(set(v["syncs"])),
                  "classic_syncs": sorted(set(v["classic_syncs"]))}
              for k, v in resident_out.items()}}),
        ("K4 pcg", "pcg.cu", "pgslam_tpu/optim/pcg_pallas.py:174",
         max(c["err"] for c in k4.values()), k4_16k["ms"],
         k4_16k["plain_ms"], k4_16k["bound"],
         {"shape": "pgo_16k, the initial-pose system, default PGOConfig",
          "layout": k4_layout_name(k4_16k["layout"]),
          "device_ms": k4_16k["device_ms"],
          "by_case": {f"{n}_{s}": {
              "layout": k4_layout_name(c["layout"]), "cg_steps": c["steps"],
              "ms": c["ms"], "device_ms": c["device_ms"],
              "device_ms_per_step": c.get("device_ms_per_step"),
              "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0]}
              for (n, s), c in k4.items()},
          "pgo_1k_device_ms": k4_1k["device_ms"],
          "top_shapes_by_path": {p: [f"{v}x{e}:{c}" for (v, e), c in top]
                                 for p, (top, _) in k4_shapes.items()},
          "mean_cg_steps_by_path": {p: m for p, (_, m)
                                    in k4_shapes.items()}}),
    ]
    # library_ms: no single PyTorch call computes any of these functions
    # (a masked k-NN, a whole ICP registration, a whole LM optimize, a
    # truncated PCG solve); K1's row carries cdist + topk, two calls, as
    # cdist_topk_ms.
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
