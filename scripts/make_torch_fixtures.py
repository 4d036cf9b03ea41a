"""Record the JAX package's runs of the golden loop on its deferred and
streaming paths, which the PyTorch port is held to where JAX is not
installed (``chip_smoke.py``'s deferred path):

* ``tests/fixtures/golden_replay_lag2.npz``: ``sync_lag=2`` with deferred
  loop-closure verification (the deployable live-loop profile);
* ``tests/fixtures/golden_replay_stream4.npz``: ``micro_batch=4``.

Each holds the per-scan poses (the last one the flushed pose), the
keyframe trajectory, and the keyframe, loop-edge, swap and optimizer-run
counts. Run on the CPU backend, as the test tier runs JAX:

    python scripts/make_torch_fixtures.py [lag2] [stream4]

The existing fixtures are not touched. Commit the result.
"""

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from golden_replay import _replay, golden_config, golden_sequence  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures")


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


RUNS = {"lag2": (lag2_run, "golden_replay_lag2.npz"),
        "stream4": (stream4_run, "golden_replay_stream4.npz")}


def record(name: str) -> str:
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
    for name in sys.argv[1:] or list(RUNS):
        record(name)


if __name__ == "__main__":
    main()
