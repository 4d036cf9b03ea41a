"""The voxel-hash grid matcher (``matcher="grid"``): the port against
pgslam_tpu on the same numpy inputs. The index (table and overflow
count) and the matches (squared distances and ids) are held bit for bit;
a grid ICP registration within 1e-5; the golden loop on the grid matcher
against the JAX package's run (golden_replay_grid.npz)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgslam_tpu.cloud import make_cloud as jmake
from pgslam_tpu.ops import gridknn as JG
from pgslam_tpu.ops import icp as JI
from pgslam_tpu.ops import outlier as JO
from pgslam_tpu_torch import replays
from pgslam_tpu_torch.cloud import make_cloud as tmake
from pgslam_tpu_torch.convert import config_from_dict, config_to_dict
from pgslam_tpu_torch.ops import gridknn as TG
from pgslam_tpu_torch.ops import icp as TI
from torch_threads import one_torch_thread  # noqa: F401

POSE_TOL_M = 0.10   # the replays' parity limit (tests/test_golden_replay.py)
ICP_TOL = 1e-5


def _cloud_pair(seed=0, n=3000, nq=1000):
    """References on planes with duplicated stretches (full buckets), some
    masked; queries near them, some masked."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    r[:, 2] = np.round(r[:, 2])
    r[-300:] = r[:300]
    rm = np.ones(n, bool)
    rm[100:200] = False
    q = (r[rng.integers(0, n, nq)]
         + rng.normal(0, 0.1, (nq, 3))).astype(np.float32)
    qm = np.ones(nq, bool)
    qm[::7] = False
    return q, qm, r, rm


def _indexes(r, rm, cell_size, cap):
    ji = JG.build_grid_index(jnp.asarray(r), jnp.asarray(rm),
                             cell_size=cell_size, bucket_cap=cap)
    ti = TG.build_grid_index(torch.from_numpy(r), torch.from_numpy(rm),
                             cell_size=cell_size, bucket_cap=cap)
    return ji, ti


@pytest.mark.parametrize("cell_size,cap", [(0.0, 8), (0.3, 4), (1.0, 4),
                                           (0.5, 16)])
def test_index_equals_jax(cell_size, cap):
    _, _, r, rm = _cloud_pair()
    ji, ti = _indexes(r, rm, cell_size, cap)
    np.testing.assert_array_equal(ti.table.numpy(), np.asarray(ji.table))
    assert int(ti.overflow_count) == int(ji.overflow_count)
    assert float(ti.cell_size) == float(ji.cell_size)
    if cap == 4:
        assert int(ti.overflow_count) > 0


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("cell_size,cap", [(0.0, 8), (0.3, 4), (1.0, 4)])
def test_grid_knn_equals_jax(cell_size, cap, k):
    q, qm, r, rm = _cloud_pair(seed=k)
    ji, ti = _indexes(r, rm, cell_size, cap)
    jm = JG.grid_knn(jnp.asarray(q), jnp.asarray(qm), ji, k=k)
    tm = TG.grid_knn(torch.from_numpy(q), torch.from_numpy(qm), ti, k=k)
    np.testing.assert_array_equal(tm.ids.numpy(), np.asarray(jm.ids))
    np.testing.assert_array_equal(tm.dists2.numpy(), np.asarray(jm.dists2))
    fin = np.isfinite(tm.dists2.numpy())
    assert 0.2 < fin.mean() < 1.0


def test_auto_cell_size_equals_jax():
    for seed in range(3):
        _, _, r, rm = _cloud_pair(seed=seed)
        assert TG.auto_cell_size(torch.from_numpy(r), torch.from_numpy(rm)) \
            == JG.auto_cell_size(jnp.asarray(r), jnp.asarray(rm))
    one = np.zeros((1, 3), np.float32)
    assert TG.auto_cell_size(one, np.ones(1, bool)) == 1.0


def test_grid_icp_registration_matches_jax():
    """One registration through the engine (set_map builds the index) on
    the grid matcher: T, overlap and residual within 1e-5 of the JAX
    package's icp_core, the same iteration count."""
    rng = np.random.default_rng(4)
    ref = rng.uniform(-6, 6, (1500, 3)).astype(np.float32)
    ref[::2, 2] = np.round(ref[::2, 2] / 3) * 3
    reading = (ref[:900] + np.float32([0.08, -0.05, 0.02])).astype(
        np.float32)
    jcfg = JI.ICPConfig(matcher="grid", grid_cell_size=0.6,
                        outlier=(JO.TrimmedDist(0.85), JO.MaxDist(0.5)),
                        trans_eps=1e-3, rot_eps=1e-3)
    tcfg = config_from_dict(TI.ICPConfig, config_to_dict(jcfg))
    je = JI.ICPEngine(jcfg)
    je.set_map(jmake(ref))
    te = TI.ICPEngine(tcfg)
    te.set_map(tmake(ref))
    np.testing.assert_array_equal(te.index.table.numpy(),
                                  np.asarray(je._index.table))
    jr = je(jmake(reading), jnp.eye(4))
    tr = te(tmake(reading), torch.eye(4))
    np.testing.assert_allclose(tr.T.numpy(), np.asarray(jr.T), rtol=0,
                               atol=ICP_TOL)
    assert int(tr.iterations) == int(jr.iterations)
    assert bool(tr.converged) == bool(jr.converged)
    assert abs(float(tr.overlap) - float(jr.overlap)) <= ICP_TOL
    assert abs(float(tr.residual) - float(jr.residual)) <= ICP_TOL * max(
        1.0, abs(float(jr.residual)))


@pytest.fixture(scope="module")
def grid_replay():
    """The golden loop on the grid matcher, on the CPU."""
    return replays.run_replay("grid", device="cpu")


def test_grid_replay_matches_jax_fixture(grid_replay):
    """The golden loop with both ICP pipelines on the grid matcher against
    the JAX package's run: equal keyframe, loop-edge, swap and optimizer
    counts, every scan within 0.10 m."""
    gold = replays.fixture("grid")
    per_scan, trajectory, stats = grid_replay
    assert np.isfinite(per_scan).all()
    assert replays.max_pose_gap(per_scan, gold["per_scan_poses"]) \
        < POSE_TOL_M
    assert stats["n_keyframes"] == int(gold["n_keyframes"]) \
        == len(trajectory)
    assert stats["n_loops"] == int(gold["n_loop_edges"]) >= 1
    assert stats["n_swaps"] == int(gold["n_swaps"])
    assert stats["opt_runs"] == int(gold["opt_runs"])


def test_grid_replay_makes_the_jax_decisions(grid_replay):
    """Scan by scan, the CPU run's local-map composition, keyframe count,
    and registration overlap and ICP iterations are the JAX run's
    (golden_replay_grid_eval.npz, scripts/make_torch_fixtures.py
    grid_eval), as chip_smoke.py's replay_grid reads them on the card."""
    import os
    ev = np.load(os.path.join(replays.FIXTURES,
                              "golden_replay_grid_eval.npz"))
    _, _, stats = grid_replay
    assert [tuple(c) for c in stats["compositions"]] == \
        [tuple(c[c >= 0]) for c in ev["compositions"]]
    np.testing.assert_array_equal(stats["keyframes"], ev["keyframes"])
    ov = np.array([np.nan if o is None else o for o in stats["overlaps"]],
                  np.float32)
    np.testing.assert_array_equal(ov, ev["overlaps"])
    its = [-1 if i is None else i for i in stats["iterations"]]
    np.testing.assert_array_equal(its, ev["iterations"])


def test_grid_config_is_the_jax_one():
    import golden_replay
    jcfg = golden_replay.golden_config()
    icp = dataclasses.replace(jcfg.localizer.icp, matcher="grid",
                              grid_cell_size=0.0, grid_bucket_cap=8)
    jcfg = dataclasses.replace(
        jcfg, localizer=dataclasses.replace(jcfg.localizer, icp=icp),
        loop_closer=dataclasses.replace(jcfg.loop_closer, icp=icp))
    assert config_to_dict(replays.grid_config()) == config_to_dict(jcfg)
