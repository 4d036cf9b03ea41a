"""The block-Jacobi PCG solve of one LM step in one kernel launch (K4).

``pcg_solve`` is the wrapper: CUDA tensors launch the hand-written
kernel in ``csrc/pcg.cu``; CPU tensors take ``pgo.pcg_solve_plain``, its
plain version.

Kernel note. Replaces ``pgslam_tpu/optim/pcg_pallas.py::
pcg_solve_pallas``, the route for graphs too large for the whole-LM
kernel K3. A CG step is latency-bound on the H100: at ``pgo_16k``
(V = 16384, E = 20479) it reads about 17 MB of blocks, 5 us at
3.35 TB/s if every step read them again from device memory, and does
about 8 MFLOP. The first design did read them again, through three grid
barriers per step. This design (:func:`k4_layout`) gives each CTA a
contiguous range of whole vertex tiles (``TILE`` vertices) and, for
each of its vertices, the incidence slots of :func:`lm.edge_csr` (each
unmasked edge once at each end): the slots' diagonal and oriented
off-diagonal blocks and the vertices' preconditioner and CG vectors are
copied into the CTA's shared memory once per launch and stay there for
the whole solve. A CG step is vertex-centric, two barriers: each slot
forms its far end's direction from the owner's z and previous p (in its
own CTA, through distributed shared memory inside a thread-block
cluster, or from a global copy the owner publishes), each vertex sums
its slots in CSR order, then p.Ap; then the updates, r.z and r.r. Each
dot product is summed over fixed vertex tiles (a warp tree in each),
and the tile partials in tile order (:func:`tile_dot` is the plain
mirror), so the scalars, the stop test and every bit of x are the same
at any CTA count, cluster size, barrier and placement. No float
atomics. Graphs whose working set exceeds the card's shared memory run
the same kernel with the per-CTA arrays in global scratch.

The layout, the slot tables and the scratch are built once per optimize
(:func:`k4_plan`, in ``pgo.lm_optimize_loop``), not per launch.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .lm import _split, edge_csr, slot_ends
from .pgo import pcg_solve_plain

TILE = 32                 # vertices of a dot-product tile (one warp)
NT = 512                  # threads of a CTA; csrc/pcg.cu
MAX_CLUSTER = 16
LOC_SHIFT = 20            # a slot's far end: CTA << 20 | local vertex
# Per-CTA working set (csrc/pcg.cu, struct Off), in 4-byte words: per
# vertex P_inv [36], x, r, Ap, damping, z and two p buffers [6 each] and
# its slot pointer; per slot its diagonal and off-diagonal blocks [36
# each], its product [6], its far end and its own vertex and side.
VERTEX_WORDS = 36 + 42 + 1
SLOT_WORDS = 72 + 6 + 2
BARRIERS = ("grid", "cluster")


def _round(n, m):
    return np.maximum(m, (np.asarray(n) + m - 1) // m * m)


def cta_words(NV: int, NS: int) -> int:
    """Words of one CTA's working set with vertex stride NV (a multiple
    of TILE) and slot stride NS (a multiple of 4); csrc/pcg.cu::Off."""
    return SLOT_WORDS * NS + VERTEX_WORDS * NV + 4


@dataclasses.dataclass(frozen=True)
class K4Layout:
    """CTA g owns vertices ``vstart[g]:vstart[g + 1]`` (whole tiles but
    for the last) and their incidence slots; ``cluster`` CTAs form a
    thread-block cluster. ``NV`` and ``NS`` are the vertex and slot
    strides of every CTA's arrays (the largest CTA's counts, rounded);
    ``in_smem`` says whether they live in shared memory (``smem_bytes``
    per CTA) or in global scratch. ``barrier`` is how the CTAs meet for
    each dot product: ``"grid"`` (a cooperative grid sync) or
    ``"cluster"`` (a cluster barrier, then one arrival per cluster on a
    global word)."""
    ctas: int
    cluster: int
    vstart: tuple
    in_smem: bool
    NV: int
    NS: int
    smem_bytes: int
    slots: int
    barrier: str


def _tile_ranges(ptr: np.ndarray, ctas: int):
    """vstart [ctas + 1]: contiguous runs of whole tiles of about equal
    bytes."""
    V = len(ptr) - 1
    ends = np.minimum(np.arange(1, -(-V // TILE) + 1) * TILE, V)
    starts = np.arange(len(ends)) * TILE
    cost = 4 * (VERTEX_WORDS * (ends - starts)
                + SLOT_WORDS * (ptr[ends] - ptr[starts]))
    cut = _split(np.cumsum(cost), ctas)
    return np.minimum(cut * TILE, V)


def _strides(ptr: np.ndarray, vstart: np.ndarray):
    NV = int(_round(np.diff(vstart), TILE).max())
    NS = int(_round(np.diff(ptr[vstart]), 4).max())
    return NV, NS


def k4_layout(ptr, sm_count: int, smem_budget: int, max_cluster: int, *,
              ctas=None, cluster=None, in_smem=None,
              barrier=None) -> K4Layout:
    """How one solve of the graph whose incidence pointer
    (:func:`lm.edge_csr`) is ``ptr`` is spread over the card. A graph of
    at most ``max_cluster`` vertex tiles: one CTA per tile, all in one
    thread-block cluster. A larger one: one CTA per SM (at most one per
    tile), each its own cluster. (``chip_smoke.py --k4-layouts``: more
    CTAs, less work each, were faster at every size; one cluster with
    the cluster barrier beat as many lone CTAs with the grid barrier by
    15-18 % at 2-16 tiles; among several clusters, larger clusters were
    within the runs' spread, and one CTA per SM is always resident.) The
    barrier: the cluster barrier where the CTAs form one cluster, else
    the cooperative grid sync. The working set in shared memory where the
    largest CTA's fits ``smem_budget`` bytes, else in global scratch.
    Forced ``ctas``, ``cluster`` (at most ``max_cluster``, the largest
    that schedules), ``in_smem`` and ``barrier`` are honoured; impossible
    ones raise ``ValueError``. Whether the CTAs are resident at once is
    the card's to say (:func:`k4_plan` asks it)."""
    ptr = np.asarray(ptr, dtype=np.int64)
    ntiles = -(-(len(ptr) - 1) // TILE)
    if barrier is not None and barrier not in BARRIERS:
        raise ValueError(f"K4: unknown barrier {barrier!r}")
    largest = min(max_cluster, MAX_CLUSTER)
    if ctas is None and cluster is None and ntiles <= largest:
        ctas = cluster = ntiles
    cluster = 1 if cluster is None else cluster
    if not 1 <= cluster <= largest:
        raise ValueError(f"K4: cluster {cluster} outside 1..{largest}")
    if ctas is None:
        ctas = min(ntiles, sm_count) // cluster * cluster
    if not 1 <= ctas <= ntiles:
        raise ValueError(f"K4: {ctas} CTAs for {ntiles} vertex tiles")
    if ctas % cluster:
        raise ValueError(f"K4: {ctas} CTAs are not clusters of {cluster}")
    if barrier is None:
        barrier = "cluster" if ctas == cluster else "grid"
    vstart = _tile_ranges(ptr, ctas)
    NV, NS = _strides(ptr, vstart)
    nbytes = 4 * cta_words(NV, NS)
    fits = nbytes <= smem_budget
    if in_smem is None:
        in_smem = fits
    elif in_smem and not fits:
        raise ValueError(f"K4: {nbytes} bytes a CTA exceed the "
                         f"{smem_budget} of shared memory")
    return K4Layout(ctas, cluster, tuple(int(v) for v in vstart),
                    bool(in_smem), NV, NS, nbytes if in_smem else 0,
                    int(ptr[-1]), barrier)


def slot_tables(layout: K4Layout, ptr, entries, edge_from, edge_to):
    """The kernel's int32 meta table: ``vstart`` [ctas + 1], then per
    incidence slot (in CSR order) its far end as ``CTA << LOC_SHIFT |
    local vertex``, then its own vertex as ``local vertex << 1 | side``."""
    vstart, owner, local, vq, _, side, far = slot_ends(
        layout.vstart, ptr, entries, edge_from, edge_to, layout.slots)
    far_loc = (owner[far] << LOC_SHIFT) | local[far]
    own = (local[vq] << 1) | side
    return torch.cat([vstart, far_loc, own]).to(torch.int32)


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple:
    """(dynamic shared memory a CTA may hold, SMs, the largest cluster
    that schedules with that much per CTA) on CUDA device ``index``."""
    from .. import _build
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        _build.check(_build.lib().pgs_pcg_limits(out), "pgs_pcg_limits")
    return tuple(out)


def _scratch_words(layout: K4Layout, V: int) -> dict:
    """Offsets (floats) of the plan's scratch: tile partials [3, tiles],
    the barrier words, the published z and p of every CTA (several
    clusters in shared memory) and the global working sets."""
    bar = int(_round(3 * -(-V // TILE), 4))
    pub = bar + 4
    publish = layout.in_smem and layout.ctas > layout.cluster
    work = pub + (layout.ctas * 18 * layout.NV if publish else 0)
    end = work + (0 if layout.in_smem
                  else layout.ctas * cta_words(layout.NV, layout.NS))
    return dict(bar=bar, pub=pub, work=work, end=end, publish=publish)


@dataclasses.dataclass
class K4Plan:
    """What K4 needs of a graph, built once (:func:`k4_plan`): the CSR
    order, the layout, the slot tables and the scratch. One plan serves
    one stream at a time."""
    V: int
    E: int
    ptr: torch.Tensor
    entries: torch.Tensor
    layout: K4Layout
    meta: torch.Tensor
    scratch: torch.Tensor
    words: dict


def k4_plan(edge_from, edge_to, V: int, emask=None, ptr_host=None,
            **forced) -> K4Plan:
    """K4's plan for the graph on the card, its slots those of the edges
    on in ``emask`` (every edge without one: an edge left out must carry
    zero blocks); ``forced`` goes to :func:`k4_layout`. ``ptr_host``,
    :func:`.lm.edge_csr_ptr_host` of the same graph, spares the read of
    the incidence pointer from the card. Raises
    ``RuntimeError`` if the layout's CTAs would not all be resident on
    the card at once (its barriers would never return)."""
    from .. import _build
    dev = edge_from.device
    E = edge_from.shape[0]
    ptr, entries = edge_csr(edge_from, edge_to, V, emask, ptr_host)
    budget, sms, max_cluster = device_limits(
        dev.index if dev.index is not None else torch.cuda.current_device())
    if ptr_host is None:
        ptr_host = ptr.cpu().numpy()
    layout = k4_layout(ptr_host, sms, budget, max_cluster, **forced)
    resident = ctypes.c_int(0)
    _build.check(_build.lib().pgs_pcg_resident(
        layout.ctas, layout.cluster, layout.smem_bytes,
        BARRIERS.index(layout.barrier), ctypes.addressof(resident)),
        "pgs_pcg_resident")
    if resident.value < layout.ctas:
        raise RuntimeError(
            f"K4: {layout.ctas} CTAs in clusters of {layout.cluster} with "
            f"{layout.smem_bytes} bytes of shared memory each would not "
            f"be resident at once (at most {resident.value})")
    meta = slot_tables(layout, ptr, entries, edge_from, edge_to)
    words = _scratch_words(layout, V)
    # Zeroed once: the cluster barrier's arrival word must start at 0.
    scratch = torch.zeros(words["end"], dtype=torch.float32, device=dev)
    return K4Plan(V, E, ptr, entries, layout, meta, scratch, words)


def _launch(plan: K4Plan, blocks, P_inv, damp_diag, b, prior_info,
            fixed_id, cg_iterations, cg_tol):
    from .. import _build
    dev = b.device
    V, E = plan.V, plan.E
    for t, name, shape in (
            (blocks[0], "H_ff", (E, 6, 6)), (blocks[1], "H_tt", (E, 6, 6)),
            (blocks[2], "H_ft", (E, 6, 6)), (P_inv, "P_inv", (V, 6, 6)),
            (damp_diag, "damp_diag", (V, 6)), (b, "b", (V, 6))):
        _build.require(t, name, torch.float32, shape, dev, "K4")
        if len(shape) == 3 and t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    fixed = int(fixed_id)
    if not 0 <= fixed < V:
        raise ValueError(f"fixed_id {fixed} outside 0..{V - 1}")
    if torch.is_tensor(prior_info):
        prior = prior_info.reshape(1)
        _build.require(prior, "prior_info", torch.float32, (1,), dev, "K4")
    else:
        prior = torch.tensor([prior_info], dtype=torch.float32, device=dev)
    lay, w = plan.layout, plan.words
    out = torch.empty(6 * V + 4, dtype=torch.float32, device=dev)
    total = pcg_solve.cg_steps.get(dev.index)
    if total is None:
        total = torch.zeros(1, dtype=torch.int64, device=dev)
        pcg_solve.cg_steps[dev.index] = total
    # The launch goes to the current device: make it the tensors'.
    with torch.cuda.device(dev):
        err = _build.lib().pgs_pcg(
            blocks[0].data_ptr(), blocks[1].data_ptr(),
            blocks[2].data_ptr(), P_inv.data_ptr(), damp_diag.data_ptr(),
            b.data_ptr(), prior.data_ptr(), plan.ptr.data_ptr(),
            plan.entries.data_ptr(), plan.meta.data_ptr(), V, lay.ctas,
            lay.cluster, lay.NV, lay.NS, lay.smem_bytes, int(lay.in_smem),
            BARRIERS.index(lay.barrier), int(w["publish"]), fixed,
            int(cg_iterations), float(cg_tol), plan.scratch.data_ptr(),
            w["bar"], w["pub"], w["work"], out.data_ptr(), total.data_ptr(),
            _build.stream_of(b))
    _build.check(err, "pgs_pcg")
    _build.count_launch(pcg_solve, "k4", shapes=(V, E))
    pcg_solve.layout = lay
    return out[:6 * V].view(V, 6), out[6 * V:6 * V + 1].view(torch.int32)[0]


def pcg_solve(blocks, P_inv, damp_diag, b, prior_info, fixed_id, edge_from,
              edge_to, *, cg_iterations: int, cg_tol: float,
              plan: K4Plan | None = None, return_iterations: bool = False):
    """K4 wrapper: same contract as ``pgo.pcg_solve_plain``. ``plan`` is
    :func:`k4_plan` of the graph (its layout, tables and scratch), built
    for this call with every edge when not given. The step count it
    returns with ``return_iterations`` is a device tensor on the card."""
    dev = b.device
    if dev.type == "cpu":
        return pcg_solve_plain(blocks, P_inv, damp_diag, b, prior_info,
                               fixed_id, edge_from, edge_to,
                               cg_iterations=cg_iterations, cg_tol=cg_tol,
                               return_iterations=return_iterations)
    if dev.type != "cuda":
        raise ValueError(f"pcg_solve: unsupported device {dev}")
    V, E = b.shape[0], edge_from.shape[0]
    if plan is None:
        plan = k4_plan(edge_from, edge_to, V)
    elif (plan.V, plan.E) != (V, E):
        raise ValueError(f"pcg_solve: plan for V={plan.V}, E={plan.E}, "
                         f"system V={V}, E={E}")
    x, steps = _launch(plan, blocks, P_inv, damp_diag, b, prior_info,
                       fixed_id, cg_iterations, cg_tol)
    return (x, steps) if return_iterations else x


pcg_solve.launches = 0
pcg_solve.shapes = collections.Counter()   # (V, E) of each launch
pcg_solve.layout = None                    # K4Layout of the last launch
# Per CUDA device index, an int64 [1] tensor to which every launch's
# kernel adds its CG steps (read it, or zero it, on the host).
pcg_solve.cg_steps = {}


# ---- The plain mirror of the kernel's order of operations (CPU tests) ----

def _tree(x: torch.Tensor) -> torch.Tensor:
    """The kernel's warp tree over the last axis (32 lanes): lane l adds
    lane l + o for o = 16, 8, 4, 2, 1; lane 0's sum."""
    for o in (16, 8, 4, 2, 1):
        x = torch.cat([x[..., :o] + x[..., o:2 * o], x[..., o:]], -1)
    return x[..., 0]


def _rowsum(m: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right."""
    acc = m[..., 0]
    for k in range(1, m.shape[-1]):
        acc = acc + m[..., k]
    return acc


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """x zero-padded to whole rows of 32 lanes: [rows, 32]."""
    out = torch.zeros(-(-x.shape[0] // 32) * 32, dtype=x.dtype,
                      device=x.device)
    out[:x.shape[0]] = x
    return out.view(-1, 32)


def tile_dot(a: torch.Tensor, b: torch.Tensor, vstart) -> torch.Tensor:
    """``(a * b).sum()`` for [V, 6] vectors in K4's order: each vertex's
    six terms in order; per CTA of ``vstart`` the warp tree over each of
    its tiles of TILE vertices; the warp tree over each group of 32
    tiles; then lane l adds groups l, l + 32, ... in order, and the warp
    tree over the lanes. The result does not depend on ``vstart``."""
    c = _rowsum(a * b)
    parts = [_tree(_lanes(c[int(lo):int(hi)]))
             for lo, hi in zip(vstart[:-1], vstart[1:])]
    part = torch.cat(parts)
    assert part.shape[0] == -(-a.shape[0] // TILE)
    acc = torch.zeros(32, dtype=c.dtype, device=c.device)
    for row in _lanes(_tree(_lanes(part))):
        acc = acc + row
    return _tree(acc)


def slot_matvec(blocks, damp_diag, prior_info, fixed_id, edge_from,
                edge_to, csr, p):
    """``(H + prior + diag(damp_diag)) p`` in K4's order: per incidence
    slot of ``csr`` (:func:`lm.edge_csr`) its diagonal block times its own
    end's p plus its off-diagonal block (H_ft at the from end, H_ft^T at
    the to end) times the far end's, each a left-to-right sum; per vertex
    its slots in CSR order, then the prior, then the damping."""
    H_ff, H_tt, H_ft = blocks
    ptr, entries = csr
    V = p.shape[0]
    S = int(ptr[-1])
    code = entries[:S].long()
    e, side = code >> 1, (code & 1).bool()
    ef, et = edge_from.long()[e], edge_to.long()[e]
    own = torch.where(side, et, ef)
    far = torch.where(side, ef, et)
    diag = torch.where(side[:, None, None], H_tt[e], H_ff[e])
    off = torch.where(side[:, None, None], H_ft[e].transpose(-1, -2),
                      H_ft[e])
    y = _rowsum(diag * p[own][:, None, :]) + _rowsum(off * p[far][:, None,
                                                                   :])
    deg = (ptr[1:] - ptr[:-1]).long()
    out = torch.zeros_like(p)
    for d in range(int(deg.max()) if V else 0):
        has = deg > d
        out[has] = out[has] + y[ptr[:-1].long()[has] + d]
    fixed = int(fixed_id)
    out[fixed] = out[fixed] + prior_info * p[fixed]
    return out + damp_diag * p


def pcg_solve_tiled(blocks, P_inv, damp_diag, b, prior_info, fixed_id,
                    edge_from, edge_to, csr, vstart, *, cg_iterations: int,
                    cg_tol: float):
    """K4's solve in plain PyTorch with its order of operations
    (:func:`slot_matvec`, :func:`tile_dot` over the CTAs ``vstart``).
    Returns (x, steps). The CPU tests hold it to ``pcg_solve_plain``;
    nothing on the card calls it."""
    def dot(u, v):
        return tile_dot(u, v, vstart)

    def precondition(r):
        return _rowsum(P_inv * r[:, None, :])

    fixed = int(fixed_id)
    x = torch.zeros_like(b)
    r = -b
    z = precondition(r)
    p = torch.zeros_like(b)
    rz, rr = dot(r, z), dot(r, r)
    rhs_norm2 = torch.clamp(rr, min=1e-30)
    beta = torch.zeros((), dtype=b.dtype)
    it = 0
    while it < cg_iterations and bool(rr > cg_tol * rhs_norm2):
        p = z + beta * p
        Ap = slot_matvec(blocks, damp_diag, prior_info, fixed, edge_from,
                         edge_to, csr, p)
        alpha = rz / torch.clamp(dot(p, Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precondition(r)
        rz_new, rr = dot(r, z), dot(r, r)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        rz = rz_new
        it += 1
    return x, it
