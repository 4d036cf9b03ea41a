"""The whole Levenberg-Marquardt optimize in one kernel launch (K3).

``lm_optimize`` is the wrapper: CUDA tensors launch the hand-written
kernel in ``csrc/lm.cu``; CPU tensors take ``pgo.lm_optimize_plain``, the
plain PyTorch version with the same contract as
``pgslam_tpu.optim.pgo._optimize_xla``.

Kernel note. Replaces ``pgslam_tpu/optim/lm_pallas.py::
lm_optimize_pallas`` (body ``_lm_kernel``). On the H100 a pose-graph LM
at SLAM sizes (hundreds to a few thousand poses) is bound by latency,
not by FLOPs or bytes: each LM iteration is a chain of dependent phases
(per-edge residuals and 6x6 Jacobian blocks, per-vertex sums, up to
``cg_iterations`` PCG steps of two dot products each, retraction,
cost). The first design ran it in one 512-thread block on one SM, with
every CG step reading array-of-structs global scratch and taking about
eight block barriers: 59 us per CG step at 500 poses + 500 edges. This
design runs one problem per thread-block cluster of C CTAs (up to 16,
:func:`cluster_layout` picks the smallest whose shared memory holds the
working set with at most one incidence slot per thread): CTA r owns a contiguous vertex range with the incidence
slots of its vertices (each unmasked edge once at each end, oriented
for that end), and keeps the CG working set in its shared memory, read
by the other CTAs through distributed shared memory. A CG step is two
cluster barriers; every scalar is the sum of the CTAs' partials in rank
order, the same bits in every CTA, so decisions agree and a run repeats
bit for bit (no float atomics). Graphs too large for the largest
cluster that schedules run the same kernel with those arrays in global
scratch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .pgo import PGOConfig, finish_poses, lm_optimize_plain

ROBUST_CODES = {"none": 0, "huber": 1, "cauchy": 2, "gm": 3}
MAX_CLUSTER = 16
# At most one incidence slot per thread of a CTA (csrc/lm.cu, NT): a CTA
# with more runs each CG step's products and each build serially.
SLOTS_PER_CTA = 256
# Per-CTA working set (csrc/lm.cu, struct Off), in 4-byte words: per
# vertex D, P^-1 [36 each], x, r, z, p[2], Ap [6 each] and its slot
# pointer; per incidence slot the oriented off-diagonal block [36], its
# product [6] and the other end's location; 4 more for the last pointer.
VERTEX_WORDS = 108 + 1
SLOT_WORDS = 42 + 1
# Per-slot fields kept in global scratch: Z^-1 [16], information [36],
# this end's diagonal block [36] and gradient [6].
GLOBAL_SLOT_WORDS = 94
META_CODE = 20            # the meta table's slot codes start here
LOC_SHIFT = 24            # a slot's other end: rank << 24 | local vertex


def edge_csr(edge_from, edge_to, V: int, emask=None, ptr_host=None):
    """Per-vertex incidence lists in a fixed order: for each vertex its
    'from' ends, then its 'to' ends, each in edge order. Entries encode
    ``2 * edge + side``. Returns (ptr [V+1], entries [2E]) as int32.

    Edges off in ``emask`` contribute exact zeros and are left out of the
    lists (their entries follow ``ptr[V]``): ``Optimizer`` pads graphs
    with such edges, all at vertex 0, where one thread would otherwise
    walk them in every sum. ``ptr_host`` (:func:`edge_csr_ptr_host` of
    the same graph) is taken as ``ptr``, copied to the device without a
    synchronization; counting the ends on the card synchronizes."""
    E = edge_from.shape[0]
    dev = edge_from.device
    ends = torch.cat([torch.clamp(edge_from.long(), 0, V - 1),
                      torch.clamp(edge_to.long(), 0, V - 1)])
    if emask is not None:
        ends = torch.where(emask.repeat(2), ends, V)
    side = torch.cat([torch.zeros(E, dtype=torch.long, device=dev),
                      torch.ones(E, dtype=torch.long, device=dev)])
    eidx = torch.arange(E, device=dev).repeat(2)
    order = torch.argsort((ends * 2 + side) * max(E, 1) + eidx)
    entries = (eidx * 2 + side)[order].to(torch.int32)
    if ptr_host is not None:
        from .. import _build
        ptr, = _build.to_device([np.asarray(ptr_host, np.int32)], dev)
        return ptr, entries
    counts = torch.bincount(ends, minlength=V + 1)[:V]
    ptr = torch.zeros(V + 1, dtype=torch.int32, device=dev)
    ptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return ptr, entries


def edge_csr_ptr_host(edge_from, edge_to, V: int, emask=None) -> np.ndarray:
    """:func:`edge_csr`'s ``ptr`` from host arrays (numpy int32 [V+1]):
    ends clamped to the vertices, edges off in ``emask`` sent to V. The
    resident optimizer holds the graph on the host and hands it to K3,
    which then reads no ``ptr`` back from the card."""
    ends = np.concatenate([np.clip(np.asarray(edge_from, np.int64), 0, V - 1),
                           np.clip(np.asarray(edge_to, np.int64), 0, V - 1)])
    if emask is not None:
        ends = np.where(np.tile(np.asarray(emask, bool), 2), ends, V)
    ptr = np.zeros(V + 1, np.int32)
    ptr[1:] = np.cumsum(np.bincount(ends, minlength=V + 1)[:V])
    return ptr


def _ceil4(n):
    """A CTA's vertex or slot count rounded up to its arrays' stride
    (``csrc/lm.cu::ceil4``)."""
    return np.maximum(4, (np.asarray(n) + 3) // 4 * 4)


def cta_bytes(NV, NS):
    """Shared memory of one CTA whose arrays have strides NV (vertices)
    and NS (slots), as ``csrc/lm.cu::Off``."""
    return 4 * (VERTEX_WORDS * NV + SLOT_WORDS * NS + 4)


@dataclasses.dataclass(frozen=True)
class ClusterLayout:
    """How one optimize is spread over a cluster: CTA r owns vertices
    ``vstart[r]:vstart[r + 1]`` and the incidence slots
    ``ptr[vstart[r]]:ptr[vstart[r + 1]]``, each CTA's arrays strided for
    its own counts; ``NV`` and ``NS`` are the largest strides (those of
    the meta table and of the global slices). ``in_smem`` says whether
    the working set lives in shared memory (``smem_bytes`` per CTA, the
    largest CTA's) or in global scratch. ``slots`` counts the incidence
    slots, two per unmasked edge."""
    clusters: int
    in_smem: bool
    vstart: tuple
    NV: int
    NS: int
    smem_bytes: int
    slots: int


def _split(cum: np.ndarray, C: int) -> np.ndarray:
    """Contiguous ranges of about equal cost: vstart [C + 1]."""
    targets = cum[-1] * np.arange(1, C) / C
    inner = np.searchsorted(cum, targets, side="right")
    return np.concatenate([[0], inner, [len(cum)]]).astype(np.int64)


def _sizes(ptr: np.ndarray, vstart: np.ndarray):
    """(largest vertex stride, largest slot stride, largest CTA bytes)."""
    nv, ns = _ceil4(np.diff(vstart)), _ceil4(np.diff(ptr[vstart]))
    return int(nv.max()), int(ns.max()), int(cta_bytes(nv, ns).max())


def cluster_layout(ptr, budget: int, max_smem_cluster: int,
                   max_global_cluster: int) -> ClusterLayout:
    """The smallest cluster (at most ``max_smem_cluster`` CTAs) whose
    shared memory, ``budget`` bytes per CTA, holds the working set of the
    graph whose incidence pointer (:func:`edge_csr`) is ``ptr``, of at
    least one CTA per ``SLOTS_PER_CTA`` incidence slots.
    Vertices are split into contiguous ranges of about equal bytes. Where
    no such cluster exists, ``max_global_cluster`` CTAs with the arrays
    in global scratch; raises if that is 0 (no cluster schedules)."""
    ptr = np.asarray(ptr, dtype=np.int64)
    deg = np.diff(ptr)
    cum = np.cumsum(4 * VERTEX_WORDS + 4 * SLOT_WORDS * deg)
    largest = min(max_smem_cluster, MAX_CLUSTER)
    fewest = min(max(1, -(-int(ptr[-1]) // SLOTS_PER_CTA)), largest)
    for C in range(fewest, largest + 1):
        vstart = _split(cum, C)
        NV, NS, nbytes = _sizes(ptr, vstart)
        if nbytes <= budget:
            return ClusterLayout(C, True, tuple(vstart.tolist()), NV, NS,
                                 nbytes, int(ptr[-1]))
    C = min(max_global_cluster, MAX_CLUSTER)
    if C < 1:
        raise RuntimeError("K3: no thread-block cluster schedules on this "
                           "device")
    vstart = _split(cum, C)
    NV, NS, _ = _sizes(ptr, vstart)
    return ClusterLayout(C, False, tuple(vstart.tolist()), NV, NS, 0,
                         int(ptr[-1]))


def slot_ends(vstart, ptr, entries, edge_from, edge_to, n_slots: int):
    """The incidence slots of a split of the vertices into contiguous
    ranges ``vstart``: per vertex its range (``owner``) and index in it
    (``local``); per slot, in the CSR order of ``(ptr, entries)``
    (:func:`edge_csr`), its vertex, code ``2 * edge + side``, side and
    the vertex at the edge's other end. Shared by K3's and K4's tables.
    Returns (vstart, owner, local, vertex, code, side, far) as int64."""
    from .. import _build
    dev = ptr.device
    V = ptr.shape[0] - 1
    vstart, = _build.to_device([np.asarray(vstart, np.int64)], dev)
    ptr = ptr.long()
    verts = torch.arange(V, device=dev)
    owner = torch.searchsorted(vstart, verts, right=True) - 1
    local = verts - vstart[owner]
    vq = torch.repeat_interleave(verts, ptr[1:] - ptr[:-1],
                                 output_size=n_slots)
    code = entries[:n_slots].long()
    side = code & 1
    far = torch.where(side == 0, edge_to.long()[code >> 1],
                      edge_from.long()[code >> 1]).clamp(0, V - 1)
    return vstart, owner, local, vq, code, side, far


def slot_tables(layout: ClusterLayout, ptr, entries, edge_from, edge_to,
                V: int):
    """The kernel's int32 meta table: ``vstart`` [C + 1] (padded to
    ``META_CODE``), then per CTA and slot the slot's code ``2 * edge +
    side`` (-1 past the CTA's slots), then the location of its edge's
    other end (``rank << LOC_SHIFT | local vertex``), then per CTA its
    vertices' slot pointers [NV + 4], local to the CTA."""
    dev = ptr.device
    C, NV, NS = layout.clusters, layout.NV, layout.NS
    vstart, owner, local, vq, code, _, far = slot_ends(
        layout.vstart, ptr, entries, edge_from, edge_to, layout.slots)
    ptr = ptr.long()
    rq = owner[vq]
    sq = torch.arange(layout.slots, device=dev) - ptr[vstart[rq]]
    codes = torch.full((C * NS,), -1, dtype=torch.long, device=dev)
    other = torch.zeros(C * NS, dtype=torch.long, device=dev)
    codes[rq * NS + sq] = code
    other[rq * NS + sq] = (owner[far] << LOC_SHIFT) | local[far]
    i = torch.arange(NV + 4, device=dev)
    gv = torch.minimum(vstart[:-1, None] + i, vstart[1:, None])
    vptr = ptr[gv] - ptr[vstart[:-1]][:, None]
    head = torch.zeros(META_CODE, dtype=torch.long, device=dev)
    head[:C + 1] = vstart
    return torch.cat([head, codes, other, vptr.reshape(-1)]).to(torch.int32)


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple:
    """(shared memory a CTA may hold, the largest cluster that schedules
    with that much per CTA, the largest that schedules with none) on CUDA
    device ``index``, from the kernel's occupancy queries."""
    from .. import _build
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        _build.check(_build.lib().pgs_lm_limits(out), "pgs_lm_limits")
    return tuple(out)


def _launch(poses, vmask, edge_from, edge_to, edge_T, edge_cov, emask,
            fixed_id, robust_emask, config: PGOConfig, in_smem=None,
            ptr_host=None):
    """Launch K3. ``in_smem=False`` forces the global-scratch placement
    at the cluster size the shared-memory layout would take (a test of
    the two placements). ``ptr_host`` is :func:`edge_csr_ptr_host` of the
    same graph: given, the layout is planned from it and not from a copy
    of the device ``ptr``."""
    from .. import _build
    dev = poses.device
    V, E = poses.shape[0], edge_from.shape[0]
    poses = poses.contiguous()
    ef = edge_from.to(torch.int32).contiguous()
    et = edge_to.to(torch.int32).contiguous()
    eT = edge_T.contiguous()
    ec = edge_cov.contiguous()
    rmask = (torch.ones(E, dtype=torch.bool, device=dev)
             if robust_emask is None else robust_emask.contiguous())
    for t, name, dtype, shape in (
            (poses, "poses", torch.float32, (V, 4, 4)),
            (vmask, "vmask", torch.bool, (V,)),
            (ef, "edge_from", torch.int32, (E,)),
            (et, "edge_to", torch.int32, (E,)),
            (eT, "edge_T", torch.float32, (E, 4, 4)),
            (ec, "edge_cov", torch.float32, (E, 6, 6)),
            (emask, "emask", torch.bool, (E,)),
            (rmask, "robust_emask", torch.bool, (E,))):
        _build.require(t, name, dtype, shape, dev, "K3")
    fixed = int(fixed_id)
    if not 0 <= fixed < V:
        raise ValueError(f"fixed_id {fixed} outside 0..{V - 1}")
    if ptr_host is not None and np.shape(ptr_host) != (V + 1,):
        raise ValueError(f"K3: ptr_host of shape {np.shape(ptr_host)}, "
                         f"expected ({V + 1},)")
    ptr, entries = edge_csr(ef, et, V, emask, ptr_host)
    budget, c_smem, c_global = device_limits(dev.index
                                             if dev.index is not None
                                             else torch.cuda.current_device())
    if ptr_host is None:
        ptr_host = ptr.cpu().numpy()
    layout = cluster_layout(ptr_host, budget, c_smem, c_global)
    if in_smem is False and layout.in_smem:
        layout = dataclasses.replace(layout, in_smem=False, smem_bytes=0)
    meta = slot_tables(layout, ptr, entries, ef, et, V)
    C, NV, NS = layout.clusters, layout.NV, layout.NS
    work = 0 if layout.in_smem else C * int(cta_bytes(NV, NS)) // 4
    scratch = torch.empty(32 * V + C * GLOBAL_SLOT_WORDS * NS + work,
                          dtype=torch.float32, device=dev)
    params = (ctypes.c_float * 8)(
        config.lambda_init, config.lambda_up, config.lambda_down,
        1.0 / config.prior_sigma ** 2, config.min_step_norm,
        config.min_cost_decrease, config.cg_tol, config.robust_delta)
    iparams = (ctypes.c_int * 3)(config.max_iterations, config.cg_iterations,
                                 ROBUST_CODES[config.robust])
    out = torch.empty((V, 4, 4), dtype=torch.float32, device=dev)
    stats = torch.empty(4, dtype=torch.float32, device=dev)
    # The launch goes to the current device: make it the tensors'.
    with torch.cuda.device(dev):
        err = _build.lib().pgs_lm(
            poses.data_ptr(), vmask.data_ptr(), V, ef.data_ptr(),
            et.data_ptr(), eT.data_ptr(), ec.data_ptr(), rmask.data_ptr(),
            fixed, meta.data_ptr(), C, NV, NS, layout.smem_bytes, params,
            iparams, scratch.data_ptr(), out.data_ptr(), stats.data_ptr(),
            _build.stream_of(poses))
    if err == -2:
        raise RuntimeError(f"K3: no cluster of {C} CTAs with "
                           f"{layout.smem_bytes} bytes of shared memory "
                           "each schedules")
    _build.check(err, "pgs_lm")
    _build.count_launch(lm_optimize, "k3")
    lm_optimize.layout = layout
    return finish_poses(out, poses, vmask), {
        "initial_cost": stats[0], "final_cost": stats[1],
        "iterations": stats[2].to(torch.int32), "lambda": stats[3]}


def lm_optimize(poses, vmask, edge_from, edge_to, edge_T, edge_cov, emask,
                fixed_id, robust_emask=None, *,
                config: PGOConfig = PGOConfig(), ptr_host=None):
    """K3 wrapper: same contract as ``pgo.lm_optimize_plain``.
    ``ptr_host`` (:func:`edge_csr_ptr_host` of the graph, optional) spares
    the launch its read of the incidence pointer from the card; the
    plain version has no use for it."""
    dev = poses.device
    if dev.type == "cpu":
        return lm_optimize_plain(poses, vmask, edge_from, edge_to, edge_T,
                                 edge_cov, emask, fixed_id, robust_emask,
                                 config=config)
    if dev.type != "cuda":
        raise ValueError(f"lm_optimize: unsupported device {dev}")
    return _launch(poses, vmask, edge_from, edge_to, edge_T, edge_cov,
                   emask, fixed_id, robust_emask, config, ptr_host=ptr_host)


lm_optimize.launches = 0
# The ClusterLayout of the last launch (cluster size and placement).
lm_optimize.layout = None
