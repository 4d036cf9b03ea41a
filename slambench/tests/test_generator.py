"""The frozen traffic generator reproduces its seed-0 sessions, and its
copy of the corridor generators draws what the program's own do."""

import hashlib
import json
import os

import numpy as np
import pytest

from slambench.core import traffic
from slambench.tests.helpers import BENCH_DIR

DIGESTS = {
    # (mix, agents, scans kept): sha256 of the scans and odometry
    "shared": (16, None,
               "dc4901860f0916f98f2d459f9ec65f41f94f56cb2edb40d8aae0ede394539546"),
    "corridor": (1, 4,
                 "4c131cf4c5ae084d65ca622134b6620664dd029fc4d3645d588ef2e107755122"),
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_seed0_digest(name):
    agents, n, digest = DIGESTS[name]
    with open(os.path.join(BENCH_DIR, "mixes", name + ".json")) as fh:
        mix = json.load(fh)
    if n is not None:
        mix["sequence"]["n_scans"] = mix["steps"] = n
    s = traffic.make_session(mix, agents, 0)
    h = hashlib.sha256()
    for a in s.scans:
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(s.odom.tobytes())
    assert h.hexdigest() == digest


def test_copy_draws_as_the_program():
    from pgslam_tpu_torch import datasets
    kw = dict(n_scans=6, scan_points=512, step=0.25, noise=0.003,
              odom_noise=0.005, length=60.0)
    a = datasets.corridor_sequence(np.random.default_rng(7), **kw)
    b = traffic.corridor_sequence(np.random.default_rng(7), **kw)
    for xs, ys in zip(a, b):
        for x, y in zip(xs, ys):
            assert np.array_equal(x, y)


def test_layout_of_agents():
    with open(os.path.join(BENCH_DIR, "mixes", "apart.json")) as fh:
        mix = json.load(fh)
    s = traffic.make_session(mix, 16, 3)
    assert s.index[5].tolist() == [5 + b % 3 for b in range(16)]
    base = [b % 3 for b in range(16)]
    d = s.odom[0, :, 1, 3] - s.odom[0, base, 1, 3]
    assert np.allclose(d, 100.0 * (np.arange(16) - np.array(base)))
    assert np.array_equal(s.odom[0, 3, :3, :3], s.odom[0, 0, :3, :3])
