"""Exact masked k-nearest-neighbour search (K1).

``knn`` is the wrapper: a CUDA tensor launches the hand-written kernel in
``csrc/knn.cu``; a CPU tensor takes ``knn_plain``, the plain PyTorch
version of the same function. Both compute the squared distance by the
expanded formula of ``pgslam_tpu.ops.knn.knn_brute_force``,
``|q|^2 - 2 q.r + |r|^2`` clamped at 0, with the cross term as the FMA
chain ``fma(qz, rz, fma(qy, ry, qx * rx))`` and the norms as rounded
products summed left to right. That is how the JAX CPU backend rounds
the same formula, and it makes the kernel's ids bit-equal to the plain
version's. Masked references and masked queries give ``+inf``; ties go
to the lowest reference id (lexicographic order on ``(d2, id)``).

Kernel note. Replaces ``pgslam_tpu/ops/knn_pallas.py::nn_pallas`` (body
``_kernel``). On the H100 the search is bound by fp32 instruction issue,
not bytes: every (query, reference) pair costs ~9 instructions and
nothing is reused across pairs, while a reference is 16 bytes read from
shared memory. One thread per query fills too few blocks at the main
path's shapes (2048 queries: 16 blocks of 128 threads for 132 SMs), so
the kernel also splits the references: the grid is (query tiles) x S,
each CTA scans one contiguous slice of reference ids in increasing order
with a sorted top-k per query in registers, and the S CTAs of a tile, one
thread-block cluster, merge their lists through distributed shared
memory in slice order, keeping the k least by ``(d2, id)``
(:func:`merge_slices` is that merge in plain PyTorch). That order is
total, so the ids are the plain version's for every layout;
:func:`k1_layout` picks S (and the threads a CTA) so that the grid fills
the card. The TPU kernel's three precision modes
("highest", "high", "default") exist only because of the TPU's bf16
matrix unit; all three map to this one fp32 path, which is exact.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import torch

INF = float("inf")
MAX_K = 16
# The kernel's layouts (csrc/knn.cu::pgs_knn): slices of the references
# (the cluster size) and threads a CTA, one query each; a slice the layout
# chooses holds at least MIN_SLICE references.
SLICES = (1, 2, 4, 8, 16)
THREADS = (128, 32)
MIN_SLICE = 64


@dataclasses.dataclass
class Matches:
    """``dists2 [Nq, k]`` ascending squared distances, ``ids [Nq, k]``."""
    dists2: torch.Tensor
    ids: torch.Tensor

    @property
    def k(self) -> int:
        return self.dists2.shape[-1]


def check_k(k: int) -> None:
    """Raise for a k the kernel has no instance of (1..MAX_K)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K}")


def sq_norm(p: torch.Tensor) -> torch.Tensor:
    """``x*x + y*y + z*z`` with each product rounded, summed in order."""
    return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]


def sq_dists(q: torch.Tensor, r: torch.Tensor, q_sq=None, r_sq=None):
    """All-pairs expanded squared distances ``[Nq, Nr]`` (unclamped)."""
    q_sq = sq_norm(q) if q_sq is None else q_sq
    r_sq = sq_norm(r) if r_sq is None else r_sq
    cross = torch.addcmul(
        torch.addcmul(q[:, None, 0] * r[None, :, 0], q[:, None, 1],
                      r[None, :, 1]), q[:, None, 2], r[None, :, 2])
    return (q_sq[:, None] - 2.0 * cross) + r_sq[None, :]


def knn_plain(query, query_mask, reference, reference_mask, k: int = 1,
              tile_query: int = 1024) -> Matches:
    """Plain PyTorch version of K1 (query-tiled to bound memory)."""
    check_k(k)
    nq, nr = query.shape[0], reference.shape[0]
    r_sq = sq_norm(reference)
    out_d, out_i = [], []
    for s in range(0, nq, tile_query):
        q = query[s:s + tile_query]
        qm = query_mask[s:s + tile_query]
        d2 = torch.clamp(sq_dists(q, reference, r_sq=r_sq), min=0.0)
        d2 = torch.where(reference_mask[None, :] & qm[:, None], d2, INF)
        if k == 1:
            i = torch.argmin(d2, dim=1, keepdim=True)   # first minimum
            d = torch.gather(d2, 1, i)
        else:
            d, i = torch.sort(d2, dim=1, stable=True)
            d, i = d[:, :k], i[:, :k]
            if nr < k:
                pad = k - nr
                d = torch.cat([d, d.new_full((d.shape[0], pad), INF)], 1)
                i = torch.cat([i, i.new_zeros((i.shape[0], pad))], 1)
        out_d.append(d)
        out_i.append(i)
    d = torch.cat(out_d) if out_d else query.new_zeros((0, k))
    i = torch.cat(out_i).to(torch.int32) if out_i else \
        torch.zeros((0, k), dtype=torch.int32, device=query.device)
    return Matches(dists2=d, ids=torch.where(torch.isfinite(d), i, 0))


def merge_slices(parts, k: int) -> Matches:
    """The kernel's merge: the k least entries by ``(d2, id)`` of the
    sorted lists ``parts`` (one Matches per contiguous slice of the
    references, in slice order, with the slice's global ids), taken as
    each CTA takes them: the first list, then each next one entry by
    entry, each inserted behind every kept entry of distance <= its own
    (its id exceeds theirs). An entry that does not precede the k-th kept
    changes nothing (the kernel stops the list there). Ids of non-finite
    entries are 0."""
    d, i = parts[0].dists2.clone(), parts[0].ids.clone()
    for p in parts[1:]:
        for s in range(k):
            cd, ci = p.dists2[:, s, None], p.ids[:, s, None]
            after = d > cd                      # the slots cd goes ahead of
            move = torch.zeros_like(after)
            move[:, 1:] = after[:, :-1]         # entry t - 1 moves to t
            put = after & ~move                 # cd lands at t
            d = torch.where(move, d.roll(1, 1), torch.where(put, cd, d))
            i = torch.where(move, i.roll(1, 1), torch.where(put, ci, i))
    return Matches(dists2=d, ids=torch.where(torch.isfinite(d), i, 0))


@dataclasses.dataclass(frozen=True)
class K1Layout:
    """``slices`` CTAs (one cluster) per tile of ``threads`` queries."""
    slices: int
    threads: int

    def ctas(self, nq: int) -> int:
        return -(-nq // self.threads) * self.slices


@functools.lru_cache(maxsize=1024)
def k1_layout(nq: int, nr: int, k: int, sm_count: int, *, slices=None,
              threads=None) -> K1Layout:
    """The layout for ``nq`` queries against ``nr`` references on a card
    of ``sm_count`` SMs: the most threads a CTA, then the fewest slices S
    whose grid gives every SM a CTA with every slice holding at least
    MIN_SLICE references. Where no layout does, the most slices at the
    most threads: each thread then scans nr / S references whatever the
    threads a CTA, and 128 threads stage a slice four times as fast as 32
    (256 x 8192 on an H100, ``chip_smoke.py --k1-layouts``: S = 16 of 128
    threads 0.0119 ms of device time, of 32 threads 0.0149).
    ``slices`` and ``threads`` force their values (layout timings and
    tests; the result does not depend on them, and a forced S may leave
    slices short or empty). Raises on values the kernel does not take."""
    check_k(k)
    for name, v, allowed in (("slices", slices, SLICES),
                             ("threads", threads, THREADS)):
        if v is not None and v not in allowed:
            raise ValueError(f"K1: {name}={v} not in {allowed}")
    ss = [slices] if slices else [s for s in SLICES
                                  if s == 1 or nr >= s * MIN_SLICE]
    ts = [threads] if threads else THREADS
    for t in ts:
        for s in ss:
            if K1Layout(s, t).ctas(nq) >= sm_count:
                return K1Layout(s, t)
    return K1Layout(ss[-1], ts[0])


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SMs of CUDA device ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def knn(query, query_mask, reference, reference_mask, k: int = 1,
        layout: K1Layout = None) -> Matches:
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. ``layout`` overrides :func:`k1_layout`'s choice on
    the card (the result does not depend on it)."""
    check_k(k)
    if query.device.type == "cpu":
        return knn_plain(query, query_mask, reference, reference_mask, k)
    if query.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {query.device}")
    from .. import _build
    dev = query.device
    nq, nr = query.shape[0], reference.shape[0]
    _build.require(query, "query", torch.float32, (nq, 3), dev, "K1")
    _build.require(query_mask, "query_mask", torch.bool, (nq,), dev, "K1")
    _build.require(reference, "reference", torch.float32, (nr, 3), dev, "K1")
    _build.require(reference_mask, "reference_mask", torch.bool, (nr,), dev, "K1")
    if layout is None:
        layout = k1_layout(nq, nr, k, sm_count(dev))
    d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    # The launch goes to the current device: make it the tensors' (a mesh
    # may hold shards on several cards).
    with torch.cuda.device(dev):
        err = _build.lib().pgs_knn(
            query.data_ptr(), query_mask.data_ptr(), nq,
            reference.data_ptr(), reference_mask.data_ptr(), nr, k,
            layout.slices, layout.threads, d.data_ptr(), i.data_ptr(),
            _build.stream_of(query))
    _build.check(err, "pgs_knn")
    _build.count_launch(knn, "k1", shapes=(nq, nr, k))
    knn.layout = layout
    return Matches(dists2=d, ids=i)


knn.launches = 0
knn.shapes = collections.Counter()
knn.layout = None
