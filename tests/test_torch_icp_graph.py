"""The ICP loop (``ops/icp_graph.py``) run to every stage's cap, as the
CUDA graphs replay it, here segment by segment without graphs on the
CPU, against ``icp_core``'s eager run, which leaves each stage once it
has converged, bit for bit; and the outlier thresholds, which no longer
read anything on the host, against their indexed form. The graphs
themselves replay on the card only (``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

from pgslam_tpu_torch import se3
from pgslam_tpu_torch.cloud import make_cloud
from pgslam_tpu_torch.ops import icp_graph
from pgslam_tpu_torch.ops import outlier as O
from pgslam_tpu_torch.ops.icp import ICPConfig, ICPEngine, icp_core
from torch_threads import one_torch_thread  # noqa: F401

P2PL, P2P = "point_to_plane", "point_to_point"

# (error, coarse_div, stop, anderson_m, dtype, matcher): "early" converges
# before the cap, "never" runs every stage to its cap unconverged, "short"
# has a cap below the smoothing window.
CASES = [
    (P2PL, 0, "early", 0, torch.float32, "brute"),
    (P2PL, 4, "early", 0, torch.float32, "brute"),
    (P2PL, 4, "never", 0, torch.float32, "brute"),
    (P2PL, 0, "never", 0, torch.float64, "brute"),
    (P2PL, 0, "short", 0, torch.float32, "brute"),
    (P2PL, 4, "early", 3, torch.float32, "brute"),
    (P2PL, 0, "early", 3, torch.float64, "brute"),
    (P2PL, 4, "early", 0, torch.float64, "brute"),
    (P2PL, 0, "early", 0, torch.float32, "grid"),
    (P2P, 0, "early", 0, torch.float32, "brute"),
    (P2P, 4, "early", 3, torch.float32, "brute"),
    (P2P, 4, "never", 0, torch.float64, "brute"),
    (P2P, 0, "early", 0, torch.float64, "brute"),
]


def _scene(dtype):
    """A curved surface of 768 points and a noisy 192-point reading of
    it, moved by a small twist."""
    rng = np.random.default_rng(3)
    u = rng.uniform(-3, 3, (768, 2))
    ref = np.stack([u[:, 0], u[:, 1],
                    0.4 * np.sin(1.3 * u[:, 0]) + 0.3 * np.cos(0.9 * u[:, 1])
                    + 0.1 * u[:, 0] * u[:, 1]], 1).astype(np.float32)
    rd = (ref[:192] + rng.normal(0, 0.002, (192, 3))).astype(np.float32)
    T0 = se3.exp(torch.tensor([0.06, -0.04, 0.03, 0.02, -0.015, 0.03],
                              dtype=dtype))
    return ref, rd, T0


@pytest.mark.parametrize("error,coarse,stop,m,dtype,matcher", CASES)
def test_device_decided_loop_equals_host_loop(error, coarse, stop, m,
                                              dtype, matcher):
    """The one ICP loop run two ways: every stage to its cap with the
    stop decided on the device (what the graphs replay, here eagerly),
    against ``icp_core``'s run, where the host leaves each stage once it
    has converged; every field bit for bit."""
    eps = 0.0 if stop == "never" else 1e-4
    cfg = ICPConfig(error=error, matcher=matcher, coarse_div=coarse,
                    coarse_iterations=6, anderson_m=m,
                    max_iterations=3 if stop == "short" else
                    (8 if stop == "never" else 30),
                    trans_eps=eps, rot_eps=eps,
                    outlier=(O.TrimmedDist(0.9), O.MaxDist(1.0)))
    ref, rd, T0 = _scene(dtype)
    engine = ICPEngine(cfg)
    engine.set_map(make_cloud(ref, device="cpu", dtype=dtype))
    reading = engine.prepare_reading(make_cloud(rd, device="cpu",
                                                dtype=dtype))
    assert not icp_graph.graph_route(reading, engine.reference, T0, cfg)
    want = icp_core(reading, engine.reference, T0, cfg, engine.index)
    reg = icp_graph.Registration(reading, engine.reference, cfg)
    reg.load(reading, engine.reference, T0)
    reg.run(engine.index, reg.eager)
    got = reg.result()
    for name, v in vars(want).items():
        assert torch.equal(getattr(got, name), v), name
    assert got.T.dtype == dtype
    if stop == "early":
        # Frozen iterations ran after convergence and changed nothing.
        assert bool(want.converged) and int(want.iterations) < 30
    else:
        assert not bool(want.converged)
        assert int(want.iterations) == cfg.max_iterations


# -- the outlier thresholds -----------------------------------------------

def _indexed_kth(ratio, n_valid, dtype):
    return torch.ceil(torch.tensor(ratio, dtype=dtype) * n_valid.to(dtype))


def _indexed_trimmed(d2, valid, ratio):
    s = O._sorted_valid(d2, valid)
    kth = _indexed_kth(ratio, valid.sum(), d2.dtype).to(torch.int64) - 1
    return s[torch.clamp(kth, 0, s.shape[0] - 1)]


def _indexed_median(d2, valid):
    s = O._sorted_valid(d2, valid)
    n_valid = torch.clamp(valid.sum(), min=1).to(d2.dtype)
    return s[torch.clamp((0.5 * n_valid).to(torch.int64), 0,
                         s.shape[0] - 1)]


def _indexed_var_trimmed(d2, valid, cfg):
    s = O._sorted_valid(d2, valid)
    n_valid = torch.clamp(valid.sum(), min=1).to(d2.dtype)
    ks = torch.arange(1, s.shape[0] + 1, dtype=d2.dtype)
    r = ks / n_valid
    e = torch.cumsum(torch.where(torch.isfinite(s), s, 0.0), 0) / ks
    psi = e / torch.clamp(r, min=1e-9) ** cfg.lam
    psi = torch.where((r >= cfg.min_ratio) & (r <= cfg.max_ratio), psi,
                      float("inf"))
    return s[torch.argmin(psi)]


def _distances(case, dtype):
    """``[400, 1]`` squared distances and their validity: none valid,
    all valid, or the first 300 (``ratio * 300`` a whole number at
    ratio 0.5)."""
    g = torch.Generator().manual_seed(7)
    d2 = torch.rand((400, 1), generator=g, dtype=torch.float64).to(dtype)
    mask = torch.ones(400, dtype=torch.bool)
    if case == "none_valid":
        d2[:] = float("inf")
    elif case == "exact":
        mask[300:] = False
    valid = torch.isfinite(d2) & mask[:, None]
    return d2, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["none_valid", "all_valid", "exact"])
@pytest.mark.parametrize("ratio", [0.5, 0.85, 0.9])
def test_sync_free_thresholds_equal_their_indexed_form(case, ratio, dtype):
    d2, valid = _distances(case, dtype)
    n = valid.sum()
    assert int(n) == {"none_valid": 0, "all_valid": 400, "exact": 300}[case]
    assert torch.equal(O.kth_keep(ratio, n, dtype),
                       _indexed_kth(ratio, n, dtype))
    assert torch.equal(O.trimmed_threshold(d2, valid, ratio),
                       _indexed_trimmed(d2, valid, ratio))
    assert torch.equal(O.median_threshold(d2, valid),
                       _indexed_median(d2, valid))
    var = O.VarTrimmedDist(min_ratio=ratio / 2, max_ratio=ratio)
    got = O.var_trimmed_threshold(d2, valid, var)
    want = _indexed_var_trimmed(d2, valid, var)
    assert torch.equal(got, want) or (got.isinf() and want.isinf())
    if case == "exact" and ratio == 0.5:
        assert float(O.kth_keep(ratio, n, dtype)) == 150.0
