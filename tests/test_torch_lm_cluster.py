"""K3's host-side layout (``pgslam_tpu_torch.optim.lm``): the split of a
pose graph over a thread-block cluster and the two-ended incidence the
kernel reads. The kernel itself runs only on the card
(tests/test_torch_gpu.py); here the tables are walked in PyTorch and held
to the graph they describe and to the port's matrix-free product."""

import numpy as np
import pytest
import torch

from pgslam_tpu_torch.optim import lm, pgo
from pgslam_tpu_torch.pgo_problems import bucketed_problem, pose_graph_problem

# The H100's per-CTA shared memory (227 KB) less some static use.
BUDGET = 232448 - 512


def _graph(name):
    if name == "padded":      # Optimizer's padding: masked edges at vertex 0
        args, _ = bucketed_problem(768, 128, device="cpu")
    elif name == "pgo_1k":
        args, _ = pose_graph_problem(1024, 1025, device="cpu")
    else:                     # a small ring with a self-loop edge
        args, _ = pose_graph_problem(40, 33, device="cpu")
        args = list(args)
        args[3] = args[3].clone()
        args[3][-1] = args[2][-1]
        args = tuple(args)
    return args


def _tables(args, budget=BUDGET, c_smem=16, c_global=16):
    V = args[0].shape[0]
    ptr, ent = lm.edge_csr(args[2], args[3], V, args[6])
    layout = lm.cluster_layout(ptr.numpy(), budget, c_smem, c_global)
    meta = lm.slot_tables(layout, ptr, ent, args[2], args[3], V)
    return layout, meta


def _unpack(layout, meta):
    C, NV, NS = layout.clusters, layout.NV, layout.NS
    m = meta.long()
    vstart = m[:C + 1]
    codes = m[lm.META_CODE:lm.META_CODE + C * NS].reshape(C, NS)
    other = m[lm.META_CODE + C * NS:lm.META_CODE + 2 * C * NS].reshape(C, NS)
    vptr = m[lm.META_CODE + 2 * C * NS:].reshape(C, NV + 4)
    return vstart, codes, other, vptr


def _slots(layout, meta):
    """Per slot in use: (CTA, slot, vertex it belongs to, code, vertex of
    the other end)."""
    vstart, codes, other, vptr = _unpack(layout, meta)
    mask = (1 << lm.LOC_SHIFT) - 1
    rows = []
    for r in range(layout.clusters):
        nv = int(vstart[r + 1] - vstart[r])
        for i in range(nv):
            for s in range(int(vptr[r, i]), int(vptr[r, i + 1])):
                o = int(other[r, s])
                far = int(vstart[o >> lm.LOC_SHIFT]) + (o & mask)
                rows.append((r, s, int(vstart[r]) + i, int(codes[r, s]), far))
    return rows


@pytest.mark.parametrize("name", ["ring", "padded", "pgo_1k"])
def test_every_unmasked_edge_once_at_each_end(name):
    args = _graph(name)
    V, ef, et, emask = args[0].shape[0], args[2], args[3], args[6]
    layout, meta = _tables(args)
    vstart, codes, _, vptr = _unpack(layout, meta)
    # The vertex ranges cover 0..V-1 once, in order.
    assert int(vstart[0]) == 0 and int(vstart[-1]) == V
    assert bool((vstart[1:] >= vstart[:-1]).all())
    assert int((vstart[1:] - vstart[:-1]).max()) <= layout.NV
    rows = _slots(layout, meta)
    seen = sorted(code for _, _, _, code, _ in rows)
    valid = torch.nonzero(emask).flatten().tolist()
    assert seen == sorted([2 * e for e in valid] + [2 * e + 1 for e in valid])
    for r, s, v, code, far in rows:
        e, side = code >> 1, code & 1
        ends = (int(ef[e]), int(et[e]))
        assert v == ends[side] and far == ends[1 - side], (r, s, code)
    # Past each CTA's slots the codes are -1, so padded edges appear
    # nowhere.
    for r in range(layout.clusters):
        ns = int(vptr[r, int(vstart[r + 1] - vstart[r])])
        assert ns <= layout.NS
        assert bool((codes[r, ns:] == -1).all())
        assert bool((codes[r, :ns] >= 0).all())
    if name == "padded":
        assert not bool(emask.all())
        assert layout.slots == 2 * int(emask.sum())


@pytest.mark.parametrize("name,budget", [("ring", BUDGET),
                                         ("padded", BUDGET),
                                         ("pgo_1k", BUDGET),
                                         ("padded", 60000)])
def test_smallest_cluster_that_holds_the_working_set(name, budget):
    """The smallest cluster that holds the working set and gives a CTA
    at most SLOTS_PER_CTA slots on average (the second bound decides at
    the H100's budget, the first at 60 KB per CTA)."""
    args = _graph(name)
    layout, _ = _tables(args, budget)
    assert layout.in_smem
    V = args[0].shape[0]
    ptr, _ = lm.edge_csr(args[2], args[3], V, args[6])
    vstart = np.asarray(layout.vstart)
    per_cta = lm.cta_bytes(lm._ceil4(np.diff(vstart)),
                           lm._ceil4(np.diff(ptr.numpy()[vstart])))
    assert layout.smem_bytes == per_cta.max() <= budget
    fewest = max(1, -(-layout.slots // lm.SLOTS_PER_CTA))
    assert layout.clusters >= fewest
    assert (layout.clusters > fewest) == (budget < BUDGET)
    if layout.clusters > fewest:
        smaller = lm.cluster_layout(ptr.numpy(), budget,
                                    layout.clusters - 1, 16)
        assert not smaller.in_smem
    # One word less of budget than the split needs: the next size up.
    tight = lm.cluster_layout(ptr.numpy(), layout.smem_bytes - 4, 16, 16)
    assert (tight.clusters > layout.clusters) or not tight.in_smem


def test_padded_vertices_do_not_inflate_the_slot_stride():
    """Optimizer's padding puts vertices without edges at the end: each
    CTA's arrays take its own counts, so the 3072-pose graph padded to
    4096 + 4096 fits a cluster of at most 16 CTAs of 227 KB."""
    args, _ = bucketed_problem(3072, 512, device="cpu")
    assert args[0].shape[0] == args[2].shape[0] == 4096
    layout, _ = _tables(args)
    assert layout.in_smem and layout.clusters <= 16


def test_layout_falls_back_to_global_scratch():
    args = _graph("pgo_1k")
    V = args[0].shape[0]
    ptr, _ = lm.edge_csr(args[2], args[3], V, args[6])
    layout = lm.cluster_layout(ptr.numpy(), BUDGET, 4, 16)
    assert not layout.in_smem and layout.clusters == 16
    assert layout.smem_bytes == 0
    with pytest.raises(RuntimeError):
        lm.cluster_layout(ptr.numpy(), BUDGET, 4, 0)


@pytest.mark.parametrize("name", ["ring", "padded", "pgo_1k"])
def test_slot_products_match_system_matvec(name):
    """Each vertex's own-end diagonal blocks times its p plus each slot's
    oriented off-diagonal block times the other end's p, as the kernel's
    CG step sums them, is the port's matrix-free product."""
    args = _graph(name)
    V = args[0].shape[0]
    layout, meta = _tables(args)
    prob = pgo.LMProblem(*args)
    (Hff, Htt, Hft), _, _ = prob.system(args[0])
    Hff, Htt, Hft = (h.double() for h in (Hff, Htt, Hft))
    p = torch.as_tensor(np.random.default_rng(0).normal(size=(V, 6)))
    y = torch.zeros((V, 6), dtype=torch.float64)
    for _, _, v, code, far in _slots(layout, meta):
        e, side = code >> 1, code & 1
        diag = Htt[e] if side else Hff[e]
        off = Hft[e].T if side else Hft[e]
        y[v] += diag @ p[v] + off @ p[far]
    want = pgo.system_matvec((Hff, Htt, Hft), torch.zeros_like(p), 0.0, 0,
                             prob.ef, prob.et, p)
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-9)
