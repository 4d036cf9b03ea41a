"""Device-resident pose-graph mirror: the default optimize path of
:class:`..optimizer.Optimizer`. Counterpart of
``pgslam_tpu/optim/resident.py``.

The padded pose and edge tensors stay on the device across optimize
calls. Per call only the deltas move:

* appended vertices and edges (between optimizes the graph only grows;
  ``MapManager.hpp:46-127``),
* poses written on the host (``PoseGraph.pose_dirty``; the optimizer's
  own writeback comes from the device and marks nothing),
* the pending loop constraints of this batch.

Each delta is padded to a power-of-two count by repeating its first
entry (:func:`_pad_delta`), all of them go up in one copy, and each is
scattered into the resident tensors (``index_copy_``). The
solve is the same :func:`.pgo.optimize_pose_graph` the classic path
calls, on the resident tensors, so the two give the same bits on equal
inputs; K3 gets the incidence pointer from the host graph
(:func:`.lm.edge_csr_ptr_host`) and reads none back from the card. The
poses and the four stats come back packed in one vector, in one
device-to-host copy: the ``[V, 12]`` top rows of each pose
(``exact12``, bit-exact; the bottom row of a pose is exactly
``[0, 0, 0, 1]``) or translation and quaternion (``quat7``, ~1e-7 of
rotation round-off), ``auto`` taking ``quat7`` from ``QUAT_MIN_V``
padded vertices.

The mirror rebuilds (uploads everything) on its first call, when the
vertex or edge bucket changes, when the graph's ``mutation_epoch``, its
identity token (:func:`_graph_token`) or the pack changes, when more
vertices were appended or written than ``max(512, V // 2)``, and when
:func:`.pgo.route` picks another solve than the mirror was built for
(the card's counterpart of the JAX mirror's layout switch; it can only
change with a bucket).

Not carried, because they are TPU layout machinery (``ROADMAP.md``,
Queue 2, "Things deliberately not carried"): the sorted-RANGES routing
(``_step_ranges``, ``_route_new_edges``, ``_ranges_fits``, the per-tile
fills and chain claims), the ranges/jit hysteresis, ``_decide``'s
``fits_vmem`` / ``layout_plan`` / ``factored_plan`` chain,
``host_loop_count``, and the ``PGSLAM_PGO_FORCE_*`` switches. With them
go the JAX tests of that machinery: the incremental ranges routing
against a full routing, the ranges rescue, the ranges path against the
classic one, the hysteresis dry run and ``host_loop_count``.

The delta scatter and the packing are plain torch (``index_copy_``,
``torch.cat``): in the JAX package they are XLA scatters and
concatenates, not Pallas kernels.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _build, se3
from ..graph.pose_graph import LOOP_CONSTRAINT
from ..optimizer import _bucket, pad_graph
from ..utils import timing
from . import pgo
from .lm import edge_csr_ptr_host

# Graphs of at least this many padded vertices take the [V, 7] pack under
# pack="auto"; below it the exact [V, 12] pack keeps the host's poses
# bit-equal to the device's.
QUAT_MIN_V = 4096
PACKS = ("auto", "exact12", "quat7")

# A graph's identity for the mirror. id() can repeat: two restores in a
# row both give graphs at mutation_epoch 1, and the second may take the
# first one's freed address. A token minted per PoseGraph on first
# contact never repeats; the lock keeps two optimizer threads that touch
# one graph first at the same time from minting two.
_graph_token_counter = itertools.count(1)
_graph_token_lock = threading.Lock()


def _graph_token(graph) -> int:
    tok = getattr(graph, "_resident_mirror_token", None)
    if tok is None:
        with _graph_token_lock:
            tok = getattr(graph, "_resident_mirror_token", None)
            if tok is None:
                tok = next(_graph_token_counter)
                graph._resident_mirror_token = tok
    return tok


# --------------------------------------------------------------------------
# Packing
# --------------------------------------------------------------------------

def _pack_poses(final: torch.Tensor, pack: str) -> torch.Tensor:
    """``[V, 4, 4]`` -> ``[V * 7]`` (translation, quaternion w x y z) or
    ``[V * 12]`` (the top three rows, row-major)."""
    if pack == "quat7":
        q = se3.quaternion_from_matrix(final[:, :3, :3])
        return torch.cat([final[:, :3, 3], q], 1).reshape(-1)
    return final[:, :3, :].reshape(-1)


def _unpack_poses_host(vec: np.ndarray, V: int, pack: str) -> np.ndarray:
    """The inverse of :func:`_pack_poses` on the host: ``[V, 4, 4]``
    float32."""
    out = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    if pack == "quat7":
        arr = vec.reshape(V, 7)
        out[:, :3, 3] = arr[:, :3]
        w, x, y, z = arr[:, 3], arr[:, 4], arr[:, 5], arr[:, 6]
        xx, yy, zz = x * x, y * y, z * z
        xy, xz, yz = x * y, x * z, y * z
        wx, wy, wz = w * x, w * y, w * z
        R = np.empty((V, 3, 3), np.float32)
        R[:, 0, 0] = 1 - 2 * (yy + zz)
        R[:, 0, 1] = 2 * (xy - wz)
        R[:, 0, 2] = 2 * (xz + wy)
        R[:, 1, 0] = 2 * (xy + wz)
        R[:, 1, 1] = 1 - 2 * (xx + zz)
        R[:, 1, 2] = 2 * (yz - wx)
        R[:, 2, 0] = 2 * (xz - wy)
        R[:, 2, 1] = 2 * (yz + wx)
        R[:, 2, 2] = 1 - 2 * (xx + yy)
        out[:, :3, :3] = R
        return out
    out[:, :3, :] = vec.reshape(V, 3, 4)
    return out


STATS = ("initial_cost", "final_cost", "iterations", "lambda")


def _stats_vec(stats: dict, like: torch.Tensor) -> torch.Tensor:
    """The four stats as one ``[4]`` tensor on ``like``'s device. The LM
    loop counts its iterations on the host: that count is written on the
    device by a fill, not copied there (a copy would synchronize)."""
    vals = []
    for k in STATS:
        v = stats[k]
        if v.device != like.device:
            v = torch.full((), float(v), dtype=like.dtype, device=like.device)
        vals.append(v.to(like.dtype))
    return torch.stack(vals)


def _stats_dict(tail: np.ndarray) -> dict:
    return {k: float(v) for k, v in zip(STATS, tail)}


# --------------------------------------------------------------------------
# Deltas
# --------------------------------------------------------------------------

def _bucket_k(n: int, lo: int = 8) -> int:
    return max(lo, 1 << max(0, int(n) - 1).bit_length())


def _pad_delta(idx, vals: List[np.ndarray]):
    """Pad a delta of at least one entry to a power-of-two count (at
    least 8) by repeating its first entry: two writes of the same value
    to one slot give the same result in either order. Returns (idx,
    vals)."""
    idx = np.asarray(idx, np.int64)
    k = len(idx)
    K = _bucket_k(k)
    out_vals = []
    for v in vals:
        v = np.asarray(v)
        pv = np.empty((K,) + v.shape[1:], v.dtype)
        pv[:k] = v
        pv[k:] = v[0]
        out_vals.append(pv)
    out_idx = np.empty(K, np.int64)
    out_idx[:k] = idx
    out_idx[k:] = idx[0]
    return out_idx, out_vals


# --------------------------------------------------------------------------
# The mirror
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Prep:
    """Host snapshot taken under the graph lock (the MT optimizer's); the
    device work runs unlocked on these copies."""
    nv: int                       # vertices at prepare time
    ne_graph: int                 # graph edges at prepare time
    n_pending: int
    fixed: int
    rebuild: bool
    route: str                    # pgo.route of the padded shapes
    pack: str
    V: int
    E: int
    epoch: int
    graph_id: int
    # Poses to (re)upload: appended vertices, then host-written ones.
    pose_idx: np.ndarray
    pose_val: np.ndarray
    # New edges (graph appends since the last sync, then this batch's
    # pending constraints), with their slots in the padded arrays.
    e_idx: np.ndarray
    e_from: np.ndarray
    e_to: np.ndarray
    e_T: np.ndarray
    e_cov: np.ndarray
    e_rm: np.ndarray              # robust-mask value per new edge
    # edge_csr's ptr of the padded graph, for K3 and K4 on the card.
    ptr_host: Optional[np.ndarray] = None
    # The whole padded problem on a rebuild (None on the delta path).
    full: Optional[dict] = None


class ResidentPGO:
    """The optimizer's padded graph tensors, resident on ``device``
    across optimize calls. One per :class:`..optimizer.Optimizer`; not
    thread-safe by itself (the MT optimizer runs one optimize at a
    time)."""

    def __init__(self, pgo_config, shape_bucket: int = 64,
                 pack: str = "auto", device=None):
        if pack not in PACKS:
            raise ValueError(f"unknown writeback pack {pack!r}")
        self.config = pgo_config
        self.shape_bucket = shape_bucket
        self.pack_mode = pack
        self.device = torch.device(device if device is not None else "cuda")
        self._st: Optional[dict] = None
        self.last_upload_bytes = 0
        self.last_download_bytes = 0
        self.last_rebuild_bytes = 0

    # -- public ------------------------------------------------------------

    def invalidate(self) -> None:
        self._st = None

    def prepare(self, graph, fixed: int,
                pending: List[Tuple[int, int, np.ndarray, np.ndarray]],
                ) -> _Prep:
        """The host side of one optimize (under the graph lock in the MT
        optimizer): the rebuild decision and the deltas. Consumes
        ``graph.pose_dirty``."""
        nv, ne = graph.n_vertices, graph.n_edges
        k = len(pending)
        V = _bucket(nv, self.shape_bucket)
        E = _bucket(ne + k, self.shape_bucket)
        pack = self.pack_mode
        if pack == "auto":
            pack = "quat7" if V >= QUAT_MIN_V else "exact12"
        route = pgo.route(self.config, V, E, self.device)
        token = _graph_token(graph)

        st = self._st
        rebuild = (st is None or st["V"] != V or st["E"] != E
                   or st["epoch"] != graph.mutation_epoch
                   or st["graph_id"] != token or st["pack"] != pack
                   or st["route"] != route)
        ne_synced = 0 if rebuild else st["ne"]
        nv_synced = 0 if rebuild else st["nv"]
        dirty = sorted(graph.pose_dirty & set(range(nv_synced)))
        graph.pose_dirty.clear()
        if not rebuild and (nv - nv_synced) + len(dirty) \
                > max(512, V // 2):
            rebuild = True   # bulk host writes: a re-upload beats a scatter

        p_from = np.asarray([p[0] for p in pending], np.int32)
        p_to = np.asarray([p[1] for p in pending], np.int32)
        ptr_host = None
        if self.device.type == "cuda" and route in ("lm", "pcg"):
            ef_h = np.zeros(E, np.int32)
            et_h = np.zeros(E, np.int32)
            ef_h[:ne], et_h[:ne] = graph.edge_from[:ne], graph.edge_to[:ne]
            ef_h[ne:ne + k], et_h[ne:ne + k] = p_from, p_to
            ptr_host = edge_csr_ptr_host(ef_h, et_h, V,
                                         np.arange(E) < ne + k)

        empty = dict(pose_idx=np.zeros(0, np.int64),
                     pose_val=np.zeros((0, 4, 4), np.float32),
                     e_idx=np.zeros(0, np.int64),
                     e_from=np.zeros(0, np.int32),
                     e_to=np.zeros(0, np.int32),
                     e_T=np.zeros((0, 4, 4), np.float32),
                     e_cov=np.zeros((0, 6, 6), np.float32),
                     e_rm=np.zeros(0, bool))
        if rebuild:
            # The full arrays hold every pose and edge: the deltas stay
            # empty so that nothing is applied twice.
            deltas = empty
            full = self._full_arrays(graph, pending, V, E)
        else:
            full = None
            pose_idx = np.asarray(list(range(nv_synced, nv)) + dirty,
                                  np.int64)
            n_new = ne - ne_synced + k
            deltas = dict(
                pose_idx=pose_idx,
                # Fancy indexing copies: later host writes to the graph
                # do not reach the snapshot.
                pose_val=graph.optimized_poses[pose_idx],
                e_idx=np.arange(ne_synced, ne + k, dtype=np.int64),
                e_from=np.concatenate([graph.edge_from[ne_synced:ne],
                                       p_from]).astype(np.int32),
                e_to=np.concatenate([graph.edge_to[ne_synced:ne],
                                     p_to]).astype(np.int32),
                e_T=np.concatenate(
                    [graph.edge_T[ne_synced:ne]]
                    + [np.asarray(p[2], np.float32)[None] for p in pending])
                if n_new else empty["e_T"],
                e_cov=np.concatenate(
                    [graph.edge_cov[ne_synced:ne]]
                    + [np.asarray(p[3], np.float32)[None] for p in pending])
                if n_new else empty["e_cov"],
                e_rm=np.concatenate(
                    [graph.edge_type[ne_synced:ne] == LOOP_CONSTRAINT,
                     np.ones(k, bool)]))
        return _Prep(nv=nv, ne_graph=ne, n_pending=k, fixed=int(fixed),
                     rebuild=rebuild, route=route, pack=pack, V=V, E=E,
                     epoch=graph.mutation_epoch, graph_id=token,
                     ptr_host=ptr_host, full=full, **deltas)

    def execute(self, prep: _Prep):
        """The device side (no lock): apply the deltas, solve, fetch the
        packed writeback in one copy. Returns (poses [nv, 4, 4] float32
        numpy, stats dict)."""
        if prep.rebuild:
            self._do_rebuild(prep)
        st = self._st
        dev = self.device
        # Both deltas go up in one copy, (index, values) each, and are
        # scattered into the resident tensors.
        groups, host = [], []
        for idx, vals, names in (
                (prep.pose_idx, [prep.pose_val], ("poses",)),
                (prep.e_idx, [prep.e_from, prep.e_to, prep.e_T, prep.e_cov,
                              prep.e_rm], ("ef", "et", "eT", "ec", "rm"))):
            if len(idx):
                pidx, pvals = _pad_delta(idx, vals)
                groups.append((len(host), names))
                host += [pidx] + pvals
        up = sum(a.nbytes for a in host)
        dev_arrays = _build.to_device(host, dev) if host else []
        for start, names in groups:
            for k, name in enumerate(names):
                st[name].index_copy_(0, dev_arrays[start],
                                     dev_arrays[start + 1 + k])
        ne = prep.ne_graph + prep.n_pending
        vmask = torch.arange(st["V"], device=dev) < prep.nv
        emask = torch.arange(st["E"], device=dev) < ne
        final, stats = pgo.optimize_pose_graph(
            st["poses"], vmask, st["ef"], st["et"], st["eT"], st["ec"],
            emask, prep.fixed,
            robust_emask=st["rm"] if self.config.robust != "none" else None,
            config=self.config, ptr_host=prep.ptr_host)
        st["poses"] = final
        packed = torch.cat([_pack_poses(final, prep.pack),
                            _stats_vec(stats, final)])
        st["nv"], st["ne"] = prep.nv, ne
        self.last_upload_bytes = self.last_rebuild_bytes if prep.rebuild \
            else up
        with timing.wait("optimizer.fetch"):
            vec = packed.cpu().numpy()
        self.last_download_bytes = vec.nbytes
        poses = _unpack_poses_host(vec[:-len(STATS)], st["V"], prep.pack)
        return poses[:prep.nv], _stats_dict(vec[-len(STATS):])

    def confirm_inserts(self, graph) -> None:
        """After the pending loop edges were inserted into the graph
        (writeback, then insert; ``Optimizer.hpp:135-157``): if the graph
        is not where the mirror thinks (an insert raised, or in the MT
        optimizer a keyframe landed between the locked prepare and the
        locked insert and shifted the pending edges' slots), invalidate,
        and the next optimize rebuilds."""
        st = self._st
        if st is not None and (graph.n_edges != st["ne"]
                               or _graph_token(graph) != st["graph_id"]
                               or graph.mutation_epoch != st["epoch"]):
            self.invalidate()

    # -- full (re)build ------------------------------------------------------

    def _full_arrays(self, graph, pending, V, E) -> dict:
        """The classic path's padded problem (``pad_graph``, the same
        buckets), with the robust mask: the graph's loop edges and every
        pending one."""
        nv, ne = graph.n_vertices, graph.n_edges
        poses, _, ef, et, eT, ec, _ = pad_graph(
            graph.optimized_poses[:nv],
            np.concatenate([graph.edge_from[:ne], [p[0] for p in pending]]),
            np.concatenate([graph.edge_to[:ne], [p[1] for p in pending]]),
            np.concatenate([graph.edge_T[:ne]]
                           + [np.asarray(p[2], np.float32)[None]
                              for p in pending]),
            np.concatenate([graph.edge_cov[:ne]]
                           + [np.asarray(p[3], np.float32)[None]
                              for p in pending]),
            self.shape_bucket)
        assert (len(poses), len(ef)) == (V, E)
        rm = np.zeros(E, bool)
        rm[:ne] = graph.edge_type[:ne] == LOOP_CONSTRAINT
        rm[ne:ne + len(pending)] = True
        return {"poses": poses, "ef": ef, "et": et, "eT": eT, "ec": ec,
                "rm": rm}

    def _do_rebuild(self, prep: _Prep) -> None:
        fa = prep.full
        names = ("poses", "ef", "et", "eT", "ec", "rm")
        st = {"V": prep.V, "E": prep.E, "epoch": prep.epoch,
              "graph_id": prep.graph_id, "pack": prep.pack,
              "route": prep.route, "nv": 0, "ne": 0}
        st.update(zip(names, _build.to_device([fa[n] for n in names],
                                              self.device)))
        self.last_rebuild_bytes = sum(fa[n].nbytes for n in names)
        self._st = st
