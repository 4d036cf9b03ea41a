"""The reference's switch ``PGSLAM_FUSED_BATCHED`` on the port ("1" forces
K2, "0" forces ``icp_core``, unset keeps "auto": K2 on the card only),
read where the JAX package reads it: batched registration, both
verification routes of the loop closer and the fleet. On the CPU, K2's
route runs its plain version; each route is held to the JAX package's on
the same inputs (its kernel in interpret mode on the CPU).

Also the loop closer's CPU route: an eligible config's synchronous
verification runs ``icp_core`` on the CPU, as the JAX ``LoopCloser``
does, and gives the JAX verification's packed result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_replay import golden_config, golden_sequence
from pgslam_tpu.cloud import make_cloud as jmake
from pgslam_tpu.cloud import stack_clouds as jstack
from pgslam_tpu.loopcloser import _verify_one as j_verify_one
from pgslam_tpu.parallel.batched import batched_register as j_batched
from pgslam_tpu_torch import replays
from pgslam_tpu_torch.cloud import make_cloud, stack_clouds
from pgslam_tpu_torch.loopcloser import verify, verify_batch
from pgslam_tpu_torch.ops import icp_fused
from pgslam_tpu_torch.parallel import batched as B
from pgslam_tpu_torch.parallel.multi_agent import MultiAgentSlam
from torch_threads import one_torch_thread  # noqa: F401

ENVS = [None, "1", "0"]
T_TOL_M = 1e-4


def _set(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("PGSLAM_FUSED_BATCHED", raising=False)
    else:
        monkeypatch.setenv("PGSLAM_FUSED_BATCHED", env)


@pytest.fixture
def k2_runs(monkeypatch):
    """Counts the runs of K2's plain version (the CPU's K2 route)."""
    runs = []
    orig = icp_fused.fused_icp_register_plain

    def counting(*a, **k):
        runs.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(icp_fused, "fused_icp_register_plain", counting)
    return runs


def _pair(i=40, j=39):
    """Scan ``i`` of the golden loop against scan ``j``, with the odometry
    increment as the start."""
    scans, odom, _ = golden_sequence()
    T0 = (np.linalg.inv(odom[j].astype(np.float64))
          @ odom[i].astype(np.float64)).astype(np.float32)
    return scans[i], scans[j], T0


@pytest.mark.parametrize("env", [None, "1", "0", "yes"])
@pytest.mark.parametrize("fused", ["auto", "on", "off"])
def test_fused_mode(monkeypatch, env, fused):
    _set(monkeypatch, env)
    want = fused if fused != "auto" else {"1": "on", "0": "off"}.get(
        env, "auto")
    assert B.fused_mode(fused) == want


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("env", ENVS)
def test_use_fused_reads_the_switch(monkeypatch, env, device):
    _set(monkeypatch, env)
    cfg = replays.loop_config().localizer.icp
    ref = make_cloud(np.zeros((4, 3), np.float32))
    want = env == "1" or (env is None and device == "cuda")
    assert B.use_fused(cfg, ref, torch.device(device)) == want
    # a caller's explicit route wins over the switch
    assert B.use_fused(cfg, ref, torch.device(device), "on")
    assert not B.use_fused(cfg, ref, torch.device(device), "off")


@pytest.mark.parametrize("env", ENVS)
def test_batched_register_follows_the_switch(monkeypatch, k2_runs, env):
    _set(monkeypatch, env)
    jcfg = golden_config().localizer.icp
    tcfg = replays.loop_config().localizer.icp
    pairs = [_pair(40, 39), _pair(20, 19)]
    T0s = np.stack([p[2] for p in pairs])
    tr = B.batched_register(
        stack_clouds([make_cloud(p[0]) for p in pairs]),
        stack_clouds([make_cloud(p[1]) for p in pairs]),
        torch.from_numpy(T0s), tcfg)
    assert bool(k2_runs) == (env == "1")
    jr = j_batched(jstack([jmake(p[0]) for p in pairs]),
                   jstack([jmake(p[1]) for p in pairs]),
                   jnp.asarray(T0s), jcfg)
    np.testing.assert_allclose(tr.T.numpy(), np.asarray(jr.T), atol=T_TOL_M)
    np.testing.assert_array_equal(tr.iterations.numpy(),
                                  np.asarray(jr.iterations))


def _jax_verify(reading, ref, T0, use_fused):
    cfg = golden_config().loop_closer.icp
    packed, _ = j_verify_one(jmake(reading), jmake(ref), jnp.asarray(T0),
                             cfg, cfg.reading_filters, cfg.reference_filters,
                             use_fused)
    return np.asarray(packed)


def _check_packed(port, jax_vec):
    port = port.numpy()
    np.testing.assert_allclose(port[:16], jax_vec[:16], atol=T_TOL_M)
    np.testing.assert_array_equal(port[52:55], jax_vec[52:55])
    np.testing.assert_allclose(port[55:57], jax_vec[55:57], rtol=1e-4)


@pytest.mark.parametrize("env", ENVS)
def test_verify_follows_the_switch(monkeypatch, k2_runs, env):
    """The synchronous verification: K2 under "1", else ``icp_core`` on
    the CPU, against the JAX verification on the same route."""
    _set(monkeypatch, env)
    reading, ref, T0 = _pair()
    packed = verify(make_cloud(reading), make_cloud(ref),
                    torch.from_numpy(T0), replays.loop_config().loop_closer.icp)
    assert bool(k2_runs) == (env == "1")
    _check_packed(packed, _jax_verify(reading, ref, T0, env == "1"))


def test_cpu_verification_runs_icp_core_as_jax_does(monkeypatch, k2_runs):
    """An eligible config's verification on the CPU, switch unset: no K2,
    and the JAX LoopCloser's verification on the same pair (its CPU
    route is ``icp_core``), result and fresh residual."""
    monkeypatch.delenv("PGSLAM_FUSED_BATCHED", raising=False)
    cfg = replays.loop_config().loop_closer.icp
    assert icp_fused.fused_eligible(cfg)
    for i, j in ((40, 39), (66, 2), (12, 10)):
        reading, ref, T0 = _pair(i, j)
        packed = verify(make_cloud(reading), make_cloud(ref),
                        torch.from_numpy(T0), cfg)
        jvec = _jax_verify(reading, ref, T0, False)
        _check_packed(packed, jvec)
        np.testing.assert_allclose(packed.numpy()[58], jvec[58], rtol=1e-4)
    assert not k2_runs


@pytest.mark.parametrize("env", ENVS)
def test_verify_batch_follows_the_switch(monkeypatch, k2_runs, env):
    _set(monkeypatch, env)
    pairs = [_pair(40, 39), _pair(66, 2)]
    packed = verify_batch(
        stack_clouds([make_cloud(p[0]) for p in pairs]),
        stack_clouds([make_cloud(p[1]) for p in pairs]),
        torch.from_numpy(np.stack([p[2] for p in pairs])),
        replays.loop_config().loop_closer.icp)
    assert bool(k2_runs) == (env == "1")
    assert packed.shape == (len(pairs), 59)
    for b, p in enumerate(pairs):
        jvec = _jax_verify(*p, env == "1")
        _check_packed(packed[b], jvec)
        np.testing.assert_allclose(packed.numpy()[b, 58], jvec[58],
                                   rtol=1e-4)


@pytest.mark.parametrize("env,fused", [(None, "auto"), ("1", "auto"),
                                       ("0", "auto"), ("1", "off"),
                                       ("0", "on")])
def test_fleet_follows_the_switch(monkeypatch, k2_runs, env, fused):
    """The fleet's registration batch: the switch decides where the fleet
    was left at "auto"; its own route wins otherwise."""
    _set(monkeypatch, env)
    scans, odom, _ = replays.loop_sequence_golden()
    fleet = MultiAgentSlam(replays.loop_config(), n_agents=1, device="cpu",
                           fused=fused)
    T_rs = np.eye(4, dtype=np.float32)
    for i in range(3):
        fleet.add_data_batch(i, "world", odom[i][None], T_rs, [scans[i]])
    assert bool(k2_runs) == (fused == "on" or (fused == "auto"
                                               and env == "1"))
