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
``_kernel``). On the H100 the search is bound by fp32 instruction issue:
every (query, reference) pair costs ~10 instructions and nothing is
reused across pairs, while the bytes are tiny (16 B per reference, read
from shared memory). The simple design gives each thread one query and
its sorted top-k in registers, and streams ``float4(x, y, z, |r|^2)``
reference tiles through shared memory so each reference is loaded from
device memory once per block. The TPU kernel's three precision modes
("highest", "high", "default") exist only because of the TPU's bf16
matrix unit; all three map to this one fp32 path, which is exact.
"""

from __future__ import annotations

import dataclasses

import torch

INF = float("inf")
MAX_K = 8


@dataclasses.dataclass
class Matches:
    """``dists2 [Nq, k]`` ascending squared distances, ``ids [Nq, k]``."""
    dists2: torch.Tensor
    ids: torch.Tensor

    @property
    def k(self) -> int:
        return self.dists2.shape[-1]


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


def knn(query, query_mask, reference, reference_mask, k: int = 1
        ) -> Matches:
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K}")
    if query.device.type == "cpu":
        return knn_plain(query, query_mask, reference, reference_mask, k)
    if query.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {query.device}")
    from .. import _build
    dev = query.device
    nq, nr = query.shape[0], reference.shape[0]
    _build.require(query, "query", torch.float32, (nq, 3), dev)
    _build.require(query_mask, "query_mask", torch.bool, (nq,), dev)
    _build.require(reference, "reference", torch.float32, (nr, 3), dev)
    _build.require(reference_mask, "reference_mask", torch.bool, (nr,), dev)
    d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    err = _build.lib().pgs_knn(
        query.data_ptr(), query_mask.data_ptr(), nq, reference.data_ptr(),
        reference_mask.data_ptr(), nr, k, d.data_ptr(), i.data_ptr(),
        _build.stream_of(query))
    _build.check(err, "pgs_knn")
    knn.launches += 1
    return Matches(dists2=d, ids=i)


knn.launches = 0
