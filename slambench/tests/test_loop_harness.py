"""One robot's loop closures in the harness: the existing mixes render as
before, the clover route revisits, the reference's K2 point-to-plane
follows the program's plain K2, a check route may name each ICP section,
and the single driver records closures where the check judges them and
nowhere else."""

import copy
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from slambench import run as R
from slambench.core import checks, faults, slamconfig, traffic
from slambench.core.reference import geometry as G
from slambench.core.reference import icp as RI
from slambench.tests.helpers import BENCH_DIR, ROOT, card_routes

# sha256 of the scans, step index, odometry and range of a whole session
# of each mix, as the generator drew them before the clover route.
DIGESTS = {
    ("corridor", 0):
        "6fd64182f24a7d979576b74660750f6e248aafd6c6c920f6ccbbd89294d276b2",
    ("corridor", 2147483653):
        "75d214893cfe653a6e50b1efe92ea6e245cb0f5626230b51b9c4fe8602083613",
    ("shared", 0):
        "4b53c3184ef32f5101595d8b9f62502718bcf38cf465d15727f7a54925e08af6",
    ("shared", 2147483653):
        "00c04c9bbd05929d8e67a8e6f16968fb7820d1de4be3c11c6c42ca33bc30b6f5",
    ("apart", 0):
        "a98b553d575c567066acd1118092f809a3c7131f08ca8f4ac4d4bde4688932ec",
    ("apart", 2147483653):
        "02cd6e15ada06284f8386e2329be3854b7ecb78e1b7c20b5ea2110e4d0d3373d",
}
AGENTS = {"corridor": 1, "shared": 16, "apart": 16}
# A loop one ring long at the velodyne configuration's filters and
# ICP, shrunk to run on the CPU in seconds: the robot comes back past
# its first keyframe after ~37 m.
TINY_WORLD = {"petals": 1, "radius": 6.0, "n_points": 20000,
              "structure_points": 300, "width": 3.0, "height": 2.5}
TINY_SEQUENCE = {"n_scans": 40, "scan_points": 1024, "max_range": 6.0,
                 "z": 1.2}
TINY_SLAM = {"sensor_cloud_capacity": 1024,
             "localizer": {"keyframe_cloud_capacity": 1024},
             "loop_closer": {"topo_dist_threshold": 10.0,
                             "geom_dist_threshold": 4.0}}
LOOP_CHECK = {"route": {"front": "classic", "verify": "k2"},
              "registrations": 4, "sessions": 1,
              "limits": {"reg_gap_m": 0.01, "closure_gap_m": 0.001,
                         "pgo_gap_sigma": 1000.0}}


def _load(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as fh:
        return json.load(fh)


def _merge(d, over):
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            _merge(d[k], v)
        else:
            d[k] = v
    return d


def _digest(session) -> str:
    h = hashlib.sha256()
    for a in session.scans:
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(session.index.tobytes())
    h.update(session.odom.tobytes())
    h.update(repr(session.max_range).encode())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(DIGESTS))
def test_existing_mixes_render_as_before(name, seed):
    mix = _load("mixes", name + ".json")
    s = traffic.make_session(mix, AGENTS[name], seed)
    assert _digest(s) == DIGESTS[(name, seed)]


def _tiny_clover():
    mix = _load("mixes", "clover64.json")
    mix["world"].update(n_points=3000, structure_points=4)
    mix["sequence"].update(scan_points=64)
    return mix


def test_clover_revisits_far_along_the_path():
    """clover64's route (its points shrunk): some pose comes within the
    velodyne loop closer's geometric distance of a pose at least its
    topological distance earlier along the path, at every petal's
    return; the same seed renders the same session."""
    mix = _tiny_clover()
    lc = _load("configs", "velodyne64.json")["slam"]["loop_closer"]
    _, _, truth = traffic.render(mix, 2147483653)
    pos = np.stack([T[:3, 3] for T in truth]).astype(np.float64)
    path = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(pos, axis=0), axis=1))])
    near = np.linalg.norm(pos[:, None] - pos[None], axis=-1) \
        <= lc["geom_dist_threshold"]
    far = (path[:, None] - path[None]) >= lc["topo_dist_threshold"]
    revisits = np.nonzero((near & far).any(1))[0]
    per = mix["sequence"]["n_scans"] // mix["world"]["petals"]
    for petal in range(1, mix["world"]["petals"]):
        assert np.any(np.abs(revisits - petal * per) <= 2), petal
    assert len(truth) == mix["steps"]
    a = traffic.make_session(mix, 1, 77)
    b = traffic.make_session(mix, 1, 77)
    c = traffic.make_session(mix, 1, 78)
    assert _digest(a) == _digest(b) != _digest(c)


def test_clover_copy_draws_as_the_program():
    from pgslam_tpu_torch import datasets
    kw = dict(n_scans=9, scan_points=128, petals=3, radius=8.0)
    a = datasets.clover_sequence(np.random.default_rng(4), **kw)
    b = traffic.clover_sequence(np.random.default_rng(4), **kw)
    for xs, ys in zip(a, b):
        for x, y in zip(xs, ys):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("coarse_div", [8, 0])
def test_k2_reference_point_to_plane_matches_the_program_plain_k2(
        coarse_div):
    """The reference's K2 route at velodyne64's verification section
    (point-to-plane, k = 8 normals, with and without the coarse stage)
    against ``fused_icp_register_plain``: one step of each stage agrees
    to rounding on every pair (the reference sums its batched moments in
    another order); whole registrations agree in iterations, overlap,
    transform and covariance on most pairs. A last-bit difference can
    move a trimmed match set, and the registration to a neighbouring
    solution."""
    import dataclasses
    cfg = _load("configs", "velodyne64.json")
    sec = dict(slamconfig.icp_section(cfg, "verify"), route="k2",
               coarse_div=coarse_div)
    prog_cfg = dataclasses.replace(slamconfig.build(cfg).loop_closer.icp,
                                   coarse_div=coarse_div)
    scans, odom, _ = traffic.corridor_sequence(
        np.random.default_rng(9), n_scans=4, scan_points=2048, step=0.5,
        odom_noise=0.02)
    pairs = ((0, 1), (1, 2), (2, 3), (0, 2))
    one = dict(max_iterations=1, smooth_length=1, coarse_iterations=1)
    for a, b in pairs:
        row, ref = _k2_p2plane_pair(
            dict(sec, **one), dataclasses.replace(prog_cfg, **one),
            scans, odom, a, b)
        assert torch.allclose(row[:16].reshape(4, 4), ref.T, rtol=0,
                              atol=1e-6)
        assert int(row[16]) == ref.iterations == 1
    agree = 0
    for a, b in pairs:
        row, ref = _k2_p2plane_pair(sec, prog_cfg, scans, odom, a, b)
        cov = row[20:56].reshape(6, 6)
        agree += bool(
            torch.allclose(row[:16].reshape(4, 4), ref.T, rtol=0, atol=1e-5)
            and int(row[16]) == ref.iterations
            and float(row[18]) == pytest.approx(ref.overlap, abs=1e-6)
            and torch.allclose(cov, ref.cov, rtol=1e-3,
                               atol=1e-4 * float(ref.cov.abs().max())))
    assert agree >= 3


def _k2_p2plane_pair(sec, prog_cfg, scans, odom, a, b):
    """The program's plain K2 (its output row) and the reference's K2
    route (its result) on one pair of scans."""
    from pgslam_tpu_torch.cloud import make_cloud
    from pgslam_tpu_torch.ops import filters as F
    from pgslam_tpu_torch.ops.icp import reference_chain
    from pgslam_tpu_torch.ops.icp_fused import fused_icp_register_plain
    T0 = (np.linalg.inv(odom[a]) @ odom[b]).astype(np.float32)
    reading = F.apply_chain(prog_cfg.reading_filters,
                            make_cloud(scans[b], device="cpu"))
    ref_cloud = make_cloud(scans[a], device="cpu")
    ref_map = F.apply_chain(reference_chain(prog_cfg, ref_cloud), ref_cloud)
    lift = lambda c: c.map(lambda x: x[None])
    row = fused_icp_register_plain(lift(reading), lift(ref_map),
                                   torch.as_tensor(T0)[None], prog_cfg)[0]
    ref = RI.register(
        RI.prepare_reading(G.cloud_from_points(scans[b], "cpu"), sec),
        RI.prepare_reference(G.cloud_from_points(scans[a], "cpu"), sec),
        torch.as_tensor(T0), sec)
    return row, ref


def test_anderson_stays_outside_the_k2_reference():
    cfg = _load("configs", "velodyne64.json")
    sec = dict(slamconfig.icp_section(cfg, "verify"), route="k2",
               anderson_m=3)
    c = G.cloud_from_points(np.zeros((8, 3), np.float32), "cpu")
    with pytest.raises(ValueError, match="Anderson"):
        RI.register(c, c, torch.eye(4), sec)


def test_routes_of_a_check():
    assert checks.routes({}) == {"front": "classic", "verify": "classic"}
    assert checks.routes({"route": "k2"}) == {"front": "k2", "verify": "k2"}
    both = {"front": "classic", "verify": "k2"}
    assert checks.routes({"route": both}) == both
    for bad in ({"front": "k2"}, {"front": "k2", "verify": "fused"}, "x"):
        with pytest.raises(ValueError):
            checks.routes({"route": bad})


def _loop_config():
    cfg = _merge(_load("configs", "velodyne64.json"), {"slam": TINY_SLAM})
    cfg["check"] = copy.deepcopy(LOOP_CHECK)
    return cfg


def _drive(cfg, mix, seed, fault=None):
    """A whole session of the single driver on the CPU, the loop
    closer's verification on K2's plain version: (session, record)."""
    session = traffic.make_session(mix, 1, seed)
    Driver = R.load_part(ROOT, "drivers", "single").Driver
    undo = faults.plant("single", fault) if fault else None
    try:
        with card_routes():
            d = Driver(cfg, slamconfig.build(cfg), session,
                       [torch.device("cpu")])
            rec = d.open()
            for i in range(session.steps):
                d.step(i)
            d.close()
    finally:
        if undo is not None:
            undo()
    return session, rec


@pytest.fixture(scope="module")
def loop_mix():
    mix = _load("mixes", "clover64.json")
    mix["world"].update(TINY_WORLD)
    mix["sequence"].update(TINY_SEQUENCE)
    mix["steps"] = TINY_SEQUENCE["n_scans"]
    return mix


@pytest.fixture(scope="module")
def loop_run(loop_mix):
    cfg = _loop_config()
    return cfg, _drive(cfg, loop_mix, 4)


def test_single_driver_records_closures(loop_run):
    """A shrunken loop with the check's route object: the driver records
    the loop closer's verifications, the program closes the loop, and
    the check reads its closure against the reference's K2
    point-to-plane within a small limit."""
    cfg, (session, rec) = loop_run
    assert len(rec.verifications) >= 1
    assert any(v.program is not None for v in rec.verifications)
    vals = checks.readings(cfg, session, [rec], 5, "cpu")
    assert vals["closures_accepted"] >= 1
    assert vals["closures_compared"] >= 1
    assert vals["closure_gap_m"] <= LOOP_CHECK["limits"]["closure_gap_m"]
    assert checks.verdict(vals, LOOP_CHECK["limits"]), vals


def test_altered_closure_is_caught(loop_mix):
    cfg = _loop_config()
    session, rec = _drive(cfg, loop_mix, 4, fault="closure_altered")
    vals = checks.readings(cfg, session, [rec], 5, "cpu")
    assert vals["closures_accepted"] >= 1
    assert vals["closure_gap_m"] >= faults.ALTER_M * 0.99
    assert not checks.verdict(vals, LOOP_CHECK["limits"])


@pytest.mark.parametrize("route", ["classic", "k2"])
def test_string_and_object_routes_read_alike(loop_run, route):
    """The route as a string and as an object naming it for both
    sections give the same readings."""
    cfg, (session, rec) = loop_run
    out = []
    for r in (route, {"front": route, "verify": route}):
        c = copy.deepcopy(cfg)
        c["check"]["route"] = r
        out.append(checks.readings(c, session, [rec], 5, "cpu"))
    assert out[0] == out[1]


def test_velodyne64_records_no_verification():
    """Without a closure limit (velodyne64's check) the single driver
    leaves the loop closer as it is and records no verification."""
    from pgslam_tpu_torch.loopcloser import LoopCloser
    cfg = _merge(_load("configs", "velodyne64.json"), {"slam": TINY_SLAM})
    assert set(cfg["check"]["limits"]) == {"reg_gap_m"}
    mix = _load("mixes", "clover64.json")
    mix["world"].update(TINY_WORLD)
    mix["sequence"].update(TINY_SEQUENCE, n_scans=6)
    mix["steps"] = 6
    session = traffic.make_session(mix, 1, 4)
    Driver = R.load_part(ROOT, "drivers", "single").Driver
    d = Driver(cfg, slamconfig.build(cfg), session, [torch.device("cpu")])
    rec = d.open()
    lc = d.slam.loop_closer
    assert "process_vertex" not in vars(lc)
    assert lc.process_vertex.__func__ is LoopCloser.process_vertex
    for i in range(session.steps):
        d.step(i)
    d.close()
    assert len(rec.vertex_src) > 1
    assert rec.verifications == []
