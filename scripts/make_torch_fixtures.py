"""Record the JAX package's runs that the PyTorch port is held to where
JAX is not installed (``chip_smoke.py``):

* ``tests/fixtures/golden_replay_lag2.npz``: the golden loop at
  ``sync_lag=2`` with deferred loop-closure verification (the deployable
  live-loop profile);
* ``tests/fixtures/golden_replay_stream4.npz``: the loop at
  ``micro_batch=4``;
* ``tests/fixtures/golden_replay_yaml.npz``: ``examples/slam_config.yaml``
  (``PoseGraphSlam.from_yaml``) over the first 120 scans of the long
  replay's clover at 2048 points a scan;
* ``tests/fixtures/golden_replay_p2plane.npz``: the same scans under
  ``from_config_paths`` with ``examples/icp_point_to_plane.yaml`` and the
  input filters of ``slam_config.yaml`` (its random draws are JAX's own;
  the port is held to the truth, in an envelope around this run's error);
* ``tests/fixtures/golden_replay_grid.npz``: the golden loop on the grid
  matcher (``GridMatcher``: auto cell size, 8 ids a bucket);
* ``tests/fixtures/golden_replay_long_eval.npz``: ATE and RPE of
  ``golden_replay_long.npz``'s per-scan poses to the clover's truth,
  computed by ``pgslam_tpu.eval``, and that run's per-scan local-map
  compositions and registration overlaps;
* ``tests/fixtures/golden_replay_grid_eval.npz``: the grid replay's
  per-scan local-map compositions, registration overlaps and ICP
  iterations, and keyframe counts (its per-scan poses must be
  ``golden_replay_grid.npz``'s);
* ``tests/fixtures/golden_fleet_mesh.npz``: ``MultiAgentSlam`` on the
  (dp = 4, tp = 2) mesh of 8 virtual CPU devices, as
  ``tests/test_multi_agent.py::test_multi_agent_on_tp_mesh`` runs it (4
  agents, 8 steps of the 512-point corridor, seed 7): each step's agent
  poses and vertex count.

Each replay fixture holds the per-scan poses (the last one the flushed
pose), the keyframe trajectory, and the keyframe, loop-edge, swap and
optimizer-run counts. Run on the CPU backend, as the test tier runs JAX:

    python scripts/make_torch_fixtures.py [lag2] [stream4] [yaml] [p2plane] [grid] [long_eval] [grid_eval] [mesh_fleet]

The existing fixtures are not touched. Commit the result.
"""

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

# The mesh fleet needs 8 devices; the other runs use the first.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from golden_replay import (FIXTURE_LONG, _replay, golden_config,  # noqa: E402
                           golden_sequence, long_sequence)

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
SLAM_YAML = os.path.join(ROOT, "examples", "slam_config.yaml")
P2PLANE_YAML = os.path.join(ROOT, "examples", "icp_point_to_plane.yaml")
YAML_CLOVER_SCANS = 120


def lag2_run():
    """sync_lag=2 goes through _replay's own argument, which also makes it
    replace the last pose by the flushed one."""
    cfg = golden_config()
    cfg = dataclasses.replace(cfg, loop_closer=dataclasses.replace(
        cfg.loop_closer, deferred_verification=True))
    return _replay(golden_sequence(), cfg, sync_lag=2)


def stream4_run():
    cfg = golden_config()
    return _replay(golden_sequence(), dataclasses.replace(
        cfg, localizer=dataclasses.replace(cfg.localizer, micro_batch=4)))


def yaml_clover_sequence():
    """The first YAML_CLOVER_SCANS scans of the long replay's clover at
    2048 points a scan (slam_config.yaml's sensorCloudCapacity)."""
    from pgslam_tpu.datasets import clover_sequence
    seq = clover_sequence(np.random.default_rng(5), n_scans=300,
                          scan_points=2048, petals=3, radius=8.0,
                          noise=0.002, odom_drift=0.002)
    return tuple(part[:YAML_CLOVER_SCANS] for part in seq)


def yaml_run():
    from pgslam_tpu.slam import PoseGraphSlam
    return _replay(yaml_clover_sequence(),
                   PoseGraphSlam.from_yaml(SLAM_YAML).config)


def p2plane_run():
    import tempfile

    import yaml
    from pgslam_tpu.slam import PoseGraphSlam
    with open(SLAM_YAML) as fh:
        chain = yaml.safe_load(fh)["localizer"]["inputFilters"]
    with tempfile.TemporaryDirectory() as tmp:
        filters = os.path.join(tmp, "input_filters.yaml")
        with open(filters, "w") as fh:
            yaml.safe_dump(chain, fh)
        cfg = PoseGraphSlam.from_config_paths(P2PLANE_YAML, filters,
                                              P2PLANE_YAML).config
    return _replay(yaml_clover_sequence(), cfg)


def grid_config():
    cfg = golden_config()
    icp = dataclasses.replace(cfg.localizer.icp, matcher="grid",
                              grid_cell_size=0.0, grid_bucket_cap=8)
    return dataclasses.replace(
        cfg, localizer=dataclasses.replace(cfg.localizer, icp=icp),
        loop_closer=dataclasses.replace(cfg.loop_closer, icp=icp))


def grid_run():
    return _replay(golden_sequence(), grid_config())


RUNS = {"lag2": (lag2_run, "golden_replay_lag2.npz"),
        "stream4": (stream4_run, "golden_replay_stream4.npz"),
        "yaml": (yaml_run, "golden_replay_yaml.npz"),
        "p2plane": (p2plane_run, "golden_replay_p2plane.npz"),
        "grid": (grid_run, "golden_replay_grid.npz")}


def decisions(seq, config, fixture):
    """The JAX package's single-threaded replay of ``seq`` (``_replay``'s
    loop) with each scan's local-map composition, the overlap and ICP
    iterations of its registration (NaN and -1 for the first scan, which
    has none) and the keyframe count after it; its per-scan poses must
    be ``fixture``'s."""
    from pgslam_tpu.slam import PoseGraphSlam
    scans, odom, _ = seq
    slam = PoseGraphSlam(config)
    T_rs = np.eye(4, dtype=np.float32)
    per_scan, comps, overlaps, keyframes, iterations = [], [], [], [], []
    for i, (scan, T_odom) in enumerate(zip(scans, odom)):
        slam.add_data(i, "world", T_odom, T_rs, scan)
        per_scan.append(slam.localizer.T_world_robot.copy())
        comps.append(slam.localizer.local_map.get_composition().as_list())
        last = slam.localizer.last_result
        overlaps.append(np.nan if last is None else float(last.overlap))
        iterations.append(-1 if last is None else int(last.iterations))
        keyframes.append(slam.get_graph().n_vertices)
    if not np.array_equal(np.stack(per_scan),
                          np.load(fixture)["per_scan_poses"]):
        raise RuntimeError(f"the replay no longer gives {fixture}")
    width = max(len(c) for c in comps)
    return (np.array([c + [-1] * (width - len(c)) for c in comps], np.int32),
            np.array(overlaps, np.float32), np.array(keyframes, np.int32),
            np.array(iterations, np.int32))


def record_long_eval() -> str:
    """ATE (after the rigid alignment) and RPE (delta 1) of the long
    fixture's per-scan poses to the sequence's truth, and the run's
    per-scan decisions (:func:`decisions`)."""
    from pgslam_tpu.eval import ate_rmse, rpe
    per_scan = np.load(FIXTURE_LONG)["per_scan_poses"]
    truth = np.stack(long_sequence()[2])
    rpe_t, rpe_r = rpe(per_scan, truth)
    compositions, overlaps, _, _ = decisions(
        long_sequence(), golden_config(), FIXTURE_LONG)
    path = os.path.join(FIXTURES, "golden_replay_long_eval.npz")
    np.savez_compressed(path, ate_rmse=ate_rmse(per_scan, truth),
                        rpe_trans=rpe_t, rpe_rot=rpe_r,
                        compositions=compositions, overlaps=overlaps)
    print(f"wrote {path}: ate {ate_rmse(per_scan, truth)}, rpe {rpe_t} m "
          f"{rpe_r} rad")
    return path


def record_grid_eval() -> str:
    """The grid replay's per-scan decisions (:func:`decisions`)."""
    compositions, overlaps, keyframes, iterations = decisions(
        golden_sequence(), grid_config(),
        os.path.join(FIXTURES, RUNS["grid"][1]))
    path = os.path.join(FIXTURES, "golden_replay_grid_eval.npz")
    np.savez_compressed(path, compositions=compositions, overlaps=overlaps,
                        keyframes=keyframes, iterations=iterations)
    print(f"wrote {path}: {len(overlaps)} scans, {keyframes[-1]} keyframes")
    return path


def record_mesh_fleet() -> str:
    """tests/test_multi_agent.py:80-112's fleet on the (dp = 4, tp = 2)
    mesh: each step's poses [steps, B, 4, 4] and vertex count."""
    from pgslam_tpu.datasets import corridor_sequence
    from pgslam_tpu.parallel.multi_agent import MultiAgentSlam
    from pgslam_tpu.parallel.multichip import make_mesh
    from test_slam_e2e import small_config
    scans, odom, _ = corridor_sequence(
        np.random.default_rng(7), n_scans=12, scan_points=512, step=0.4,
        noise=0.003, odom_noise=0.005, length=30.0)
    B, steps = 4, 8
    fleet = MultiAgentSlam(small_config(), n_agents=B,
                           mesh=make_mesh(8, tp=2))
    T_rs = np.eye(4, dtype=np.float32)
    poses, n_vertices = [], []
    for i in range(steps):
        fleet.add_data_batch(i, "world", np.stack([odom[i + b]
                                                   for b in range(B)]),
                             T_rs, [scans[i + b] for b in range(B)])
        poses.append(fleet.poses().copy())
        n_vertices.append(fleet.get_graph().n_vertices)
    path = os.path.join(FIXTURES, "golden_fleet_mesh.npz")
    np.savez_compressed(path, per_step_poses=np.stack(poses),
                        n_vertices=np.array(n_vertices, np.int32))
    print(f"wrote {path}: {steps} steps, {n_vertices[-1]} vertices")
    return path


def record(name: str) -> str:
    if name == "long_eval":
        return record_long_eval()
    if name == "grid_eval":
        return record_grid_eval()
    if name == "mesh_fleet":
        return record_mesh_fleet()
    run, file = RUNS[name]
    per_scan, trajectory, stats = run()
    path = os.path.join(FIXTURES, file)
    np.savez_compressed(path, per_scan_poses=per_scan, trajectory=trajectory,
                        n_loop_edges=np.int32(stats["n_loops"]),
                        n_keyframes=np.int32(stats["n_keyframes"]),
                        n_swaps=np.int32(stats["n_swaps"]),
                        opt_runs=np.int32(stats["opt_runs"]))
    print(f"wrote {path}: {per_scan.shape[0]} scans, {stats}")
    return path


def main():
    if jax.default_backend() != "cpu":
        raise SystemExit(f"JAX is not on the CPU: {jax.devices()}")
    for name in sys.argv[1:] or [*RUNS, "long_eval", "grid_eval",
                                 "mesh_fleet"]:
        record(name)


if __name__ == "__main__":
    main()
