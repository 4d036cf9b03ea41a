"""The slice end to end: the port's PoseGraphSlam replays the sequences
whose JAX single-threaded trajectories are committed in tests/fixtures/,
and the port and chip_smoke.py stand without JAX."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pgslam_tpu_torch import replays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_TOL_M = 0.10   # the envelope pgslam_tpu allows its own non-ST paths


def _check_replay(name, keyframes, loops, device="cpu"):
    per_scan, trajectory, stats = replays.run_replay(name, device=device)
    gold = replays.fixture(name)
    gap = replays.max_pose_gap(per_scan, gold["per_scan_poses"])
    assert np.isfinite(per_scan).all()
    assert gap < POSE_TOL_M, f"{name}: max per-scan gap {gap} m"
    assert stats["n_keyframes"] == keyframes == len(trajectory)
    assert stats["n_loops"] == loops
    return gap


def test_loop_replay_matches_golden_fixture():
    gold = replays.fixture("loop")
    assert int(gold["n_loop_edges"]) == 1
    _check_replay("loop", keyframes=20, loops=1)


@pytest.mark.slow
def test_corridor_64k_replay_matches_golden_fixture():
    _check_replay("corridor_64k", keyframes=4, loops=0)


def test_replay_sequences_equal_the_fixture_generators():
    import golden_replay
    for a, b in zip(replays.loop_sequence_golden(),
                    golden_replay.golden_sequence()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


_BLOCK_JAX = (
    "import sys\n"
    "for m in ('jax', 'jax.numpy', 'flax', 'pgslam_tpu'):\n"
    "    sys.modules[m] = None\n"
    "sys.path.insert(0, {repo!r})\n"
    "import pgslam_tpu_torch, chip_smoke\n"
    "import pgslam_tpu_torch.slam, pgslam_tpu_torch.replays\n"
    "import pgslam_tpu_torch.convert, pgslam_tpu_torch.optim.lm\n"
    "import pgslam_tpu_torch.ops.icp_fused, pgslam_tpu_torch.optim.pcg\n"
    "import pgslam_tpu_torch.pgo_problems, pgslam_tpu_torch.profile_replay\n"
    "import pgslam_tpu_torch.parallel.batched\n"
    "import pgslam_tpu_torch.parallel.multi_agent\n"
    "import pgslam_tpu_torch.fleet_problems\n"
    "from pgslam_tpu_torch import MultiAgentSlam, batched_register\n"
    "print('imported')\n")


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c",
                          _BLOCK_JAX.format(repo=REPO)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_refuses_without_cuda(tmp_path):
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the port beside it, it fails too
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_unported_paths_raise():
    import dataclasses
    cfg = replays.loop_config()
    for loc in ({"sync_lag": 2}, {"micro_batch": 4},
                {"force_deferred": True}):
        bad = dataclasses.replace(cfg, localizer=dataclasses.replace(
            cfg.localizer, **loc))
        with pytest.raises(NotImplementedError):
            replays.PoseGraphSlam(bad, device="cpu")
    bad = dataclasses.replace(cfg, loop_closer=dataclasses.replace(
        cfg.loop_closer, deferred_verification=True))
    with pytest.raises(NotImplementedError):
        replays.PoseGraphSlam(bad, device="cpu")


def _entry_points():
    from pgslam_tpu_torch.graph.pose_graph import MapManager
    from pgslam_tpu_torch.localizer import Localizer
    from pgslam_tpu_torch.loopcloser import LoopCloser
    from pgslam_tpu_torch.optimizer import Optimizer
    from pgslam_tpu_torch.parallel.multi_agent import MultiAgentSlam
    return {
        "PoseGraphSlam": lambda **kw: replays.PoseGraphSlam(
            replays.loop_config(), **kw).device,
        "Optimizer": lambda **kw: Optimizer(MapManager(), **kw).device,
        "LoopCloser": lambda **kw: LoopCloser(
            MapManager(), None, replays.loop_config().loop_closer,
            **kw).device,
        "Localizer": lambda **kw: Localizer(MapManager(), **kw).device,
        "MultiAgentSlam": lambda **kw: MultiAgentSlam(
            replays.loop_config(), n_agents=2, **kw).device,
    }


@pytest.mark.parametrize("name", ["PoseGraphSlam", "Optimizer", "LoopCloser",
                                  "Localizer", "MultiAgentSlam"])
def test_entry_points_default_to_the_gpu(name):
    make = _entry_points()[name]
    assert make(device="cpu").type == "cpu"
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_run_replay_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("with CUDA the default replay runs on the card; "
                    "tests/test_torch_gpu.py drives it there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replays.run_replay("loop")
