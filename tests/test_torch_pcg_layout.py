"""K4's host-side layout (``pgslam_tpu_torch.optim.pcg``): the split of a
pose graph's vertex tiles over CTAs and clusters, the incidence slots the
kernel keeps, and the plain mirror of its order of operations (the
tile-ordered dot product and the slot-ordered matvec). The kernel itself
runs only on the card (tests/test_torch_gpu.py); here the tables are
walked in PyTorch and held to the graph they describe, and the mirror to
the port's matrix-free product and plain PCG."""

import numpy as np
import pytest
import torch

from pgslam_tpu_torch.optim import lm, pcg, pgo
from pgslam_tpu_torch.pgo_problems import bucketed_problem, pose_graph_problem

# The H100's per-CTA shared memory (227 KB) less some static use, its SMs
# and its largest cluster.
BUDGET = 232448 - 1024
SMS = 132
MAX_CLUSTER = 16
CG = dict(cg_iterations=64, cg_tol=1e-4)


def _graph(name):
    """Graph arguments on the CPU: Optimizer's padding (masked edges at
    vertex 0), pgo_1k and pgo_16k, a 40-pose ring with a self-loop edge,
    and a 150-pose graph (not whole tiles) whose 80 loop edges all leave
    one hub vertex."""
    if name == "padded":
        args, _ = bucketed_problem(768, 128, device="cpu")
    elif name in ("pgo_1k", "pgo_16k"):
        V = 1024 if name == "pgo_1k" else 16384
        args, _ = pose_graph_problem(V, V + 1 if V == 1024 else 4096,
                                     device="cpu")
    elif name == "hub":
        args, _ = pose_graph_problem(150, 80, device="cpu")
        args = list(args)
        ef, et = args[2].clone(), args[3]
        ef[149:] = torch.where(et[149:] == 7, 8, 7).to(ef.dtype)
        args[2] = ef
        args = tuple(args)
    else:
        args, _ = pose_graph_problem(40, 33, device="cpu")
        args = list(args)
        args[3] = args[3].clone()
        args[3][-1] = args[2][-1]
        args = tuple(args)
    return args


def _csr(args):
    V = args[0].shape[0]
    ef = torch.clamp(args[2].long(), 0, V - 1)
    et = torch.clamp(args[3].long(), 0, V - 1)
    return ef, et, lm.edge_csr(ef, et, V, args[6])


def _system(args):
    prob = pgo.LMProblem(*args)
    blocks, b, D = prob.system(args[0])
    P_inv, damp = pgo.block_jacobi(D, torch.tensor(1e-6), args[1])
    return blocks, P_inv, damp, b, prob.prior_info, prob.fixed


GRAPHS = ["padded", "pgo_1k", "pgo_16k", "ring", "hub"]


@pytest.mark.parametrize("name", GRAPHS)
def test_vertex_ranges_cover_every_vertex_once(name):
    args = _graph(name)
    V = args[0].shape[0]
    _, _, (ptr, _) = _csr(args)
    lay = pcg.k4_layout(ptr.numpy(), SMS, BUDGET, MAX_CLUSTER)
    vs = np.asarray(lay.vstart)
    assert len(vs) == lay.ctas + 1 and vs[0] == 0 and vs[-1] == V
    assert (np.diff(vs) >= 0).all() and (vs[:-1] % pcg.TILE == 0).all()
    assert lay.ctas % lay.cluster == 0 and lay.in_smem
    assert lay.NV % pcg.TILE == 0 and lay.NV >= np.diff(vs).max()
    p = ptr.numpy()
    assert lay.NS % 4 == 0 and lay.NS >= np.diff(p[vs]).max()
    assert lay.slots == p[-1]
    assert lay.smem_bytes == 4 * pcg.cta_words(lay.NV, lay.NS) <= BUDGET
    ntiles = -(-V // pcg.TILE)
    if ntiles <= MAX_CLUSTER:
        # One CTA per tile, all in one cluster, at its barrier.
        assert (lay.ctas, lay.cluster, lay.barrier) == (ntiles, ntiles,
                                                        "cluster")
    else:
        # One CTA per SM, at most one per tile, each its own cluster.
        assert (lay.ctas, lay.cluster, lay.barrier) == (
            min(SMS, ntiles), 1, "grid")


@pytest.mark.parametrize("name", ["padded", "ring", "hub"])
@pytest.mark.parametrize("ctas", [None, 1, 2])
def test_every_unmasked_edge_has_one_slot_at_each_end(name, ctas):
    args = _graph(name)
    V, emask = args[0].shape[0], args[6]
    ef, et, (ptr, ent) = _csr(args)
    lay = pcg.k4_layout(ptr.numpy(), SMS, BUDGET, MAX_CLUSTER, ctas=ctas)
    meta = pcg.slot_tables(lay, ptr, ent, ef, et).long()
    G, S = lay.ctas, lay.slots
    vstart = meta[:G + 1]
    far, own = meta[G + 1:G + 1 + S], meta[G + 1 + S:]
    assert tuple(vstart.tolist()) == lay.vstart and own.shape[0] == S
    mask = (1 << pcg.LOC_SHIFT) - 1
    seen = []
    for v in range(V):
        g = int(torch.searchsorted(vstart, v, right=True)) - 1
        for q in range(int(ptr[v]), int(ptr[v + 1])):
            code = int(ent[q])
            e, side = code >> 1, code & 1
            assert (v, side) == ((int(ef[e]), 0) if side == 0
                                 else (int(et[e]), 1))
            assert int(own[q]) == ((v - int(vstart[g])) << 1 | side)
            other = int(et[e] if side == 0 else ef[e])
            fc, fl = int(far[q]) >> pcg.LOC_SHIFT, int(far[q]) & mask
            assert int(vstart[fc]) + fl == other
            assert int(vstart[fc]) <= other < int(vstart[fc + 1])
            seen.append(code)
    want = sorted(2 * e + s for e in range(len(ef)) if bool(emask[e])
                  for s in (0, 1))
    assert sorted(seen) == want
    if name == "padded":
        assert len(want) < 2 * len(ef)


@pytest.mark.parametrize("kw", [
    dict(ctas=4), dict(ctas=4, cluster=2), dict(ctas=12, cluster=1),
    dict(cluster=8), dict(cluster=1), dict(in_smem=False),
    dict(barrier="cluster"), dict(ctas=6, cluster=3, barrier="grid",
                                  in_smem=False)])
def test_forced_values_are_honoured(kw):
    args = _graph("pgo_1k")
    _, _, (ptr, _) = _csr(args)
    lay = pcg.k4_layout(ptr.numpy(), SMS, BUDGET, MAX_CLUSTER, **kw)
    for key, want in kw.items():
        assert getattr(lay, key) == want
    assert lay.ctas % lay.cluster == 0
    assert lay.smem_bytes == (4 * pcg.cta_words(lay.NV, lay.NS)
                              if lay.in_smem else 0)


@pytest.mark.parametrize("kw", [
    dict(ctas=0), dict(ctas=33), dict(ctas=6, cluster=4), dict(cluster=0),
    dict(cluster=17), dict(cluster=9, max_cluster=8), dict(barrier="tree"),
    dict(ctas=1, in_smem=True)])
def test_impossible_values_raise(kw):
    args = _graph("pgo_1k")                 # 32 vertex tiles
    _, _, (ptr, _) = _csr(args)
    max_cluster = kw.pop("max_cluster", MAX_CLUSTER)
    with pytest.raises(ValueError):
        pcg.k4_layout(ptr.numpy(), SMS, BUDGET, max_cluster, **kw)


def test_global_placement_past_the_budget():
    args = _graph("pgo_16k")
    _, _, (ptr, _) = _csr(args)
    p = ptr.numpy()
    lay = pcg.k4_layout(p, 16, BUDGET, MAX_CLUSTER)
    assert not lay.in_smem and lay.smem_bytes == 0
    assert lay.ctas <= 16 and lay.ctas % lay.cluster == 0
    assert 4 * pcg.cta_words(lay.NV, lay.NS) > BUDGET
    with pytest.raises(ValueError):
        pcg.k4_layout(p, 16, BUDGET, MAX_CLUSTER, in_smem=True)
    small = pcg.k4_layout(p, SMS, 8192, MAX_CLUSTER)
    assert not small.in_smem and small.ctas <= SMS


@pytest.mark.parametrize("V", [1000, 40000])   # 40 groups of 32 tiles
def test_tile_dot_bits_do_not_depend_on_ctas(V):
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.normal(size=(V, 6)), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(V, 6)), dtype=torch.float32)
    ptr = np.arange(V + 1) * 3                 # V not whole tiles
    dots = [pcg.tile_dot(a, b, pcg.k4_layout(ptr, SMS, BUDGET, MAX_CLUSTER,
                                             ctas=g).vstart)
            for g in (1, 2, 5, 16, 32)]
    assert all(torch.equal(dots[0], d) for d in dots[1:])
    ref = (a.double() * b.double()).sum()
    assert abs(float(dots[0]) - float(ref)) <= 1e-5 * float(
        (a.double() * b.double()).abs().sum())


@pytest.mark.parametrize("name", ["padded", "ring", "hub"])
def test_slot_matvec_matches_system_matvec(name):
    args = _graph(name)
    ef, et, csr = _csr(args)
    blocks, _, damp, _, prior, fixed = _system(args)
    rng = np.random.default_rng(5)
    p = torch.as_tensor(rng.normal(size=(args[0].shape[0], 6)),
                        dtype=torch.float32)
    got = pcg.slot_matvec(blocks, damp, prior, fixed, ef, et, csr, p)
    want = pgo.system_matvec(blocks, damp, prior, fixed, ef, et, p)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("name", ["padded", "ring", "hub"])
def test_tiled_solve_matches_plain(name):
    """The mirror against pcg_solve_plain within the card test's
    1e-3 max|x| (fp32 CG with another order of sums)."""
    args = _graph(name)
    V = args[0].shape[0]
    ef, et, csr = _csr(args)
    blocks, P_inv, damp, b, prior, fixed = _system(args)
    sysargs = (blocks, P_inv, damp, b, prior, fixed, ef, et)
    xp, sp = pgo.pcg_solve_plain(*sysargs, **CG, return_iterations=True)
    for ctas in (1, 2):
        lay = pcg.k4_layout(csr[0].numpy(), SMS, BUDGET, MAX_CLUSTER,
                            ctas=ctas)
        xt, st = pcg.pcg_solve_tiled(*sysargs, csr, lay.vstart, **CG)
        assert float(xp.abs().max()) > 1e-3      # a real solve
        assert float((xt - xp).abs().max()) <= 1e-3 * float(xp.abs().max())
        assert st == sp and st > 1
        if ctas == 1:
            first = xt
        else:
            assert torch.equal(first, xt)
    assert V % pcg.TILE or name == "padded"
