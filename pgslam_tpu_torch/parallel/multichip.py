"""The multi-device layer: a ``[dp, tp]`` mesh of devices, agents over dp
and each reference cloud's point axis over tp. Counterpart of
:mod:`pgslam_tpu.parallel.multichip`.

One process drives every device of the mesh, as the JAX package's single
controller does: a :class:`Mesh` is a grid of ``torch.device``s, and the
collectives are copies between them made by that process. Over tp, the
reading (and, on the ring, its running best) travels to the shards and
each shard's candidate set (``[N, k]`` distances and ids, ``[N, k, 3]``
points) comes back to the group's first device; a reference shard never
leaves its device. Several mesh positions may share one device
(``devices=[torch.device("cuda", 0)] * 8``, or ``["cpu"] * 8``).

:func:`sharded_icp_step` is the one-iteration step under both merges,
:func:`multichip_slam_step` the full sharded registration
(:mod:`.sharded_icp`) feeding one pose-graph optimization, and
:func:`dryrun_multichip` drives it over a 10-scan fleet trajectory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .. import se3
from ..ops import minimizer as M
from ..ops import outlier as O
from ..ops.icp import ICPConfig
from ..ops.knn import Matches, knn
from ..optim.pgo import PGOConfig, optimize_pose_graph


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a ``[dp, tp]`` numpy array of ``torch.device``; row g
    is dp group g, its first entry the group's home device."""
    devices: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        dp, tp = self.devices.shape
        return {"dp": dp, "tp": tp}

    @property
    def first(self) -> torch.device:
        """The device that holds the results (the mesh's first)."""
        return self.devices[0, 0]


def make_mesh(n_devices: int, tp: int = 2, slices: int = 1,
              devices=None) -> Mesh:
    """(dp, tp) device mesh for the sharded registration paths.

    ``slices > 1`` models a multi-slice fleet: devices are grouped into
    ``slices`` contiguous blocks of ``n_devices // slices``, and ``tp``
    must divide the per-slice count so that every tp group, which
    exchanges candidates every ICP iteration, sits inside one slice.

    ``devices`` lists the mesh positions in order (``torch.device`` or
    names); ``None`` means ``cuda:0 .. cuda:{device_count - 1}``. Fewer
    devices than ``n_devices`` raise: the mesh is never shrunk or moved
    to the CPU. A device may repeat, which puts several positions on one
    card."""
    tp = min(tp, n_devices)
    if slices < 1 or n_devices % slices:
        raise ValueError(f"slices={slices} must divide n_devices"
                         f"={n_devices}")
    per_slice = n_devices // slices
    if slices > 1 and per_slice % tp:
        raise ValueError(
            f"tp={tp} must divide the per-slice chip count {per_slice}: a "
            f"tp group crossing a slice boundary would put the "
            f"per-iteration all_gather on DCN instead of ICI")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise ValueError(
                f"make_mesh({n_devices}) needs {n_devices} CUDA devices, "
                f"this machine has {have}; pass devices= to place several "
                f"mesh positions on one device (devices=[torch.device("
                f"'cuda', 0)] * {n_devices}, or ['cpu'] * {n_devices})")
        flat = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        flat = [torch.device(d) for d in devices]
        if len(flat) < n_devices:
            raise ValueError(f"make_mesh({n_devices}) was given "
                             f"{len(flat)} devices")
    dp = n_devices // tp
    grid = np.empty((dp, tp), dtype=object)
    for i in range(dp):
        for j in range(tp):
            grid[i, j] = flat[i * tp + j]
    return Mesh(grid)


def _merge_gathered(all_d, all_i, all_p, k: int, all_n=None):
    """Merge per-shard candidates: ``[tp, ..., N, kk]`` distances and ids
    and ``[tp, ..., N, kk, 3]`` points (and normals) -> the k least along
    the ``tp * kk`` axis, shard-major. The sort is stable, so ties go to
    the lower shard and, within it, to the shard's own order: the order
    ``(d2, id)`` of K1 over the whole reference."""
    tp, n, kk = all_d.shape[0], all_d.shape[-2], all_d.shape[-1]
    lead = all_d.shape[1:-2]
    d = torch.movedim(all_d, 0, -2).reshape(*lead, n, tp * kk)
    i = torch.movedim(all_i, 0, -2).reshape(*lead, n, tp * kk)
    arg = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    best_d = torch.gather(d, -1, arg)
    best_i = torch.gather(i, -1, arg)

    def pick(all_v):
        v = torch.movedim(all_v, 0, -3).reshape(*lead, n, tp * kk, 3)
        return torch.gather(v, -2, arg[..., None].expand(*arg.shape, 3))

    return (best_d, best_i, pick(all_p),
            None if all_n is None else pick(all_n))


def shard_match(pts, mask, shards, k: int, home, normals: bool = False):
    """Match ``pts [N, 3]`` (on ``home``) against every reference shard
    ``(points, mask, normals or None)`` on its own device: K1 there (its
    plain version on the CPU), ids globalized by the shard's offset, the
    candidate points (and normals, else zeros) gathered on the shard's
    device; the candidate sets are gathered to ``home`` and merged
    (:func:`_merge_gathered`). Returns (Matches [N, k], points
    [N, k, 3], normals [N, k, 3] or None)."""
    ds, ids, ps, ns = [], [], [], []
    offset = 0
    for f_pts, f_mask, f_nrm in shards:
        dev = f_pts.device
        m = knn(pts.to(dev), mask.to(dev), f_pts, f_mask, k=k)
        local = m.ids.long()
        cand_p = f_pts[local]
        ds.append(m.dists2.to(home))
        ids.append((m.ids + offset).to(home))
        ps.append(cand_p.to(home))
        if normals:
            ns.append((f_nrm[local] if f_nrm is not None
                       else torch.zeros_like(cand_p)).to(home))
        offset += f_pts.shape[0]
    d, i, p, n = _merge_gathered(torch.stack(ds), torch.stack(ids),
                                 torch.stack(ps), k,
                                 torch.stack(ns) if normals else None)
    return Matches(dists2=d, ids=i), p, n


def ring_match(pts, mask, shards, home):
    """The ring pass at k = 1: the reading and its running best visit the
    shards in order from the group's first position, each hop a copy to
    the next position; a shard's candidate replaces the best only when
    strictly nearer (``d2 < best``), so ties keep the first-visited
    shard and the result is :func:`shard_match`'s. Returns (d2 [N, 1],
    ids [N, 1], points [N, 1, 3]) on ``home``."""
    n = pts.shape[0]
    best_d = torch.full((n, 1), float("inf"), dtype=pts.dtype, device=home)
    best_i = torch.zeros((n, 1), dtype=torch.int32, device=home)
    best_p = torch.zeros((n, 1, 3), dtype=pts.dtype, device=home)
    offset = 0
    for f_pts, f_mask, _ in shards:
        dev = f_pts.device
        pts, mask = pts.to(dev), mask.to(dev)
        best_d, best_i, best_p = (best_d.to(dev), best_i.to(dev),
                                  best_p.to(dev))
        m = knn(pts, mask, f_pts, f_mask, k=1)
        better = m.dists2 < best_d
        best_d = torch.where(better, m.dists2, best_d)
        best_i = torch.where(better, m.ids + offset, best_i)
        best_p = torch.where(better[..., None],
                             f_pts[m.ids.long()], best_p)
        offset += f_pts.shape[0]
    return best_d.to(home), best_i.to(home), best_p.to(home)


def split_reference(mesh: Mesh, g: int, rows: slice, points, mask,
                    normals=None):
    """dp group ``g``'s reference shards: agent rows ``rows`` of ``[B, M,
    ...]``, the point axis cut into tp equal pieces, piece j on
    ``mesh.devices[g, j]``. Returns per agent a list of (points, mask,
    normals or None) per shard."""
    tp = mesh.shape["tp"]
    m = points.shape[1] // tp
    out = []
    for a in range(rows.start, rows.stop):
        shards = []
        for j in range(tp):
            dev = mesh.devices[g, j]
            cut = lambda x: x[a, j * m:(j + 1) * m].contiguous().to(dev)
            shards.append((cut(points), cut(mask),
                           None if normals is None else cut(normals)))
        out.append(shards)
    return out


def check_divisible(mesh: Mesh, B: int, M: int) -> None:
    """Raise where ``shard_map`` would: the agents must split over dp and
    each reference's points over tp."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    if B % dp:
        raise ValueError(f"{B} agents do not split over dp={dp}")
    if M % tp:
        raise ValueError(f"a reference of {M} points does not split over "
                         f"tp={tp}")


def sharded_icp_step(mesh: Mesh, cfg: ICPConfig, merge: str = "all_gather"):
    """Build a one-iteration ICP update sharded (dp, tp).

    Returns ``step(reading_pts, reading_mask, ref_pts, ref_mask, T)`` with
    reading ``[B, N, 3]`` split over dp and reference ``[B, M, 3]`` over
    (dp, tp); produces the updated ``[B, 4, 4]`` transforms and per-agent
    overlaps on the mesh's first device. k = 1, point-to-point.

    ``merge``: how per-shard candidates combine across the point axis:
    ``"all_gather"`` (every shard's candidate set to the group's first
    device, :func:`shard_match`) or ``"ring"`` (the reading and its
    running best around the tp ring, :func:`ring_match`); the same
    result."""
    if merge not in ("all_gather", "ring"):
        raise ValueError(f"merge must be 'all_gather' or 'ring', not "
                         f"{merge!r}")
    dp = mesh.shape["dp"]

    def step(reading_pts, reading_mask, ref_pts, ref_mask, T):
        B = reading_pts.shape[0]
        check_divisible(mesh, B, ref_pts.shape[1])
        b = B // dp
        T_out, ov_out = [], []
        for g in range(dp):
            home = mesh.devices[g, 0]
            rows = slice(g * b, (g + 1) * b)
            shards = split_reference(mesh, g, rows, ref_pts, ref_mask)
            for a, sh in zip(range(rows.start, rows.stop), shards):
                Ta = T[a].to(home)
                qm = reading_mask[a].to(home)
                q = se3.apply(Ta, reading_pts[a].to(home))
                if merge == "ring":
                    d, _, p = ring_match(q, qm, sh, home)
                else:
                    mt, p, _ = shard_match(q, qm, sh, 1, home)
                    d = mt.dists2
                w = O.compute_weights(
                    cfg.outlier, Matches(dists2=d, ids=torch.zeros(
                        d.shape, dtype=torch.int32, device=home)), qm)
                elems = M.ErrorElements(reading=q, reference=p[:, 0],
                                        weights=w[:, 0])
                delta = M.point_to_point(elems)
                T_out.append((delta @ Ta).to(mesh.first))
                ov_out.append(M.overlap(w, qm.sum()).to(mesh.first))
        return torch.stack(T_out), torch.stack(ov_out)

    return step


def multichip_slam_step(mesh: Mesh, cfg: ICPConfig,
                        pgo_cfg: PGOConfig = PGOConfig(max_iterations=3)):
    """One full sharded registration (:mod:`.sharded_icp`, the semantics
    ``MultiAgentSlam(mesh=)`` runs) for B agents feeding one pose-graph
    optimization on the mesh's first device.

    Returns ``step(*args) -> (T_new, overlaps, opt_poses)`` where args is
    (reading_pts, reading_mask, ref_pts, ref_mask, ref_normals, T_init,
    poses, vmask, edge_from, edge_to, edge_T, edge_cov, emask,
    agent_edge_ids, agent_edge_mask), tensors or numpy arrays.
    ``agent_edge_ids [B]`` names the edge slot that carries each agent's
    refined measurement; ``agent_edge_mask`` False drops the agent's
    write."""
    from ..cloud import Cloud
    from .sharded_icp import make_sharded_register

    register = make_sharded_register(mesh, cfg)
    dev = mesh.first

    def step(reading_pts, reading_mask, ref_pts, ref_mask, ref_nrm, T_init,
             poses, vmask, ef, et, eT, ec, emask,
             agent_edge_ids, agent_edge_mask):
        on = lambda x: torch.as_tensor(x, device=dev)
        reading = Cloud(points=on(reading_pts), mask=on(reading_mask))
        reference = Cloud(points=on(ref_pts), mask=on(ref_mask),
                          descriptors={"normals": on(ref_nrm)})
        res = register(reading, reference, on(T_init))
        eT = on(eT).clone()
        keep = on(agent_edge_mask)
        eT[on(agent_edge_ids).long()[keep]] = res.T[keep]
        opt, _ = optimize_pose_graph(on(poses), on(vmask), on(ef), on(et),
                                     eT, on(ec), on(emask), 0,
                                     config=pgo_cfg)
        return res.T, res.overlap, opt

    return step


def _se3_np(yaw, t):
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = t
    return T


DRYRUN_TOL_M = 0.05


def dryrun_multichip(n_devices: int, devices=None):
    """Build an ``n_devices`` mesh (tp = 2 where n_devices is even) and
    drive :func:`multichip_slam_step` over a 10-scan trajectory of B =
    2 dp agents: each scan a sharded registration of 64 points against a
    world of 128 tp points, keyframes and odometry edges appended on a
    schedule, each agent's closure slot (anchor -> its last keyframe)
    written by the step, one optimization, and the agents' live poses
    re-anchored on their last keyframe's optimized pose. ``devices`` is
    :func:`make_mesh`'s. Returns each agent's final error to the truth
    (m); raises if one is not below DRYRUN_TOL_M."""
    from ..ops.outlier import MaxDist, TrimmedDist

    mesh = make_mesh(n_devices, tp=2 if n_devices % 2 == 0 else 1,
                     devices=devices)
    tp = mesh.shape["tp"]
    B = 2 * mesh.shape["dp"]
    N, Mref = 64, 128 * tp
    n_scans, K = 10, 3                    # keyframes/agent at scans 2/5/8
    V = 1 + B * K                         # anchor + per-agent keyframes
    E = B * K + B                         # odometry edges + closure slots

    cfg = ICPConfig(error="point_to_point", max_iterations=8,
                    outlier=(TrimmedDist(0.9), MaxDist(2.0)))
    step = multichip_slam_step(mesh, cfg, PGOConfig(max_iterations=2,
                                                    cg_iterations=10))

    rng = np.random.default_rng(0)
    world = rng.normal(size=(Mref, 3)).astype(np.float32) * 3.0
    nrm = rng.normal(size=(B, Mref, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    ref = np.broadcast_to(world, (B, Mref, 3)).copy()  # world frame

    poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    vmask = np.zeros(V, bool)
    vmask[0] = True                                     # anchor
    ef = np.zeros(E, np.int32)
    et = np.zeros(E, np.int32)
    eT = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    ec = np.tile(np.eye(6, dtype=np.float32) * 0.01, (E, 1, 1))
    emask = np.zeros(E, bool)
    closure_slot = np.arange(B * K, B * K + B, dtype=np.int32)
    ef[closure_slot] = 0                                # anchor -> last kf

    T_true = [np.eye(4, dtype=np.float32) for _ in range(B)]
    T_live = [np.eye(4, dtype=np.float32) for _ in range(B)]
    last_v = [-1] * B
    last_v_pose = [None] * B
    n_kf = [0] * B

    for t in range(1, n_scans + 1):
        readings = np.empty((B, N, 3), np.float32)
        T_inits = np.empty((B, 4, 4), np.float32)
        for b in range(B):
            # truth advances; odometry prediction carries drift
            dT = _se3_np(0.02 + 0.005 * b, [0.12, 0.02 * b, 0.0])
            T_true[b] = (T_true[b] @ dT).astype(np.float32)
            drift = _se3_np(0.004, [0.015, -0.01, 0.005])
            T_inits[b] = (T_live[b] @ dT @ drift).astype(np.float32)
            sample = world[(np.arange(N) * (b + 3)) % Mref]
            Rw = T_true[b][:3, :3]
            readings[b] = ((sample - T_true[b][:3, 3]) @ Rw).astype(
                np.float32) + rng.normal(
                    0, 0.003, (N, 3)).astype(np.float32)
        spawn = t % 3 == 2 and n_kf[0] < K
        if spawn:
            # each closure slot points at the keyframe this scan spawns;
            # the step writes the refined measurement there (still
            # masked for this optimize, live from the next scan on).
            for b in range(B):
                et[closure_slot[b]] = 1 + b * K + n_kf[b]
        agent_edge_mask = np.full(B, spawn, bool)
        T_new, _, opt = step(readings, np.ones((B, N), bool), ref,
                             np.ones((B, Mref), bool), nrm, T_inits,
                             poses, vmask, ef, et, eT, ec, emask,
                             closure_slot, agent_edge_mask)
        T_new = T_new.cpu().numpy()
        opt = opt.cpu().numpy()
        if not (np.isfinite(T_new).all() and np.isfinite(opt).all()):
            raise AssertionError(f"dryrun_multichip: non-finite poses at "
                                 f"scan {t}")
        for b in range(B):
            T_live[b] = T_new[b]
        # writeback re-anchor: the live pose recomposes against the
        # agent's last keyframe's optimized pose.
        for b in range(B):
            if last_v[b] >= 0:
                rel = np.linalg.inv(last_v_pose[b]) @ T_live[b]
                T_live[b] = (opt[last_v[b]] @ rel).astype(np.float32)
                poses[last_v[b]] = opt[last_v[b]]
                last_v_pose[b] = opt[last_v[b]]
        if spawn:
            for b in range(B):
                v = 1 + b * K + n_kf[b]
                poses[v] = T_live[b]
                vmask[v] = True
                e = b * K + n_kf[b]
                prev = last_v[b] if last_v[b] >= 0 else 0
                prev_pose = last_v_pose[b] if last_v[b] >= 0 \
                    else np.eye(4, dtype=np.float32)
                ef[e], et[e] = prev, v
                eT[e] = (np.linalg.inv(prev_pose) @ T_live[b]).astype(
                    np.float32)
                emask[e] = True
                eT[closure_slot[b]] = T_new[b]
                emask[closure_slot[b]] = True
                last_v[b], last_v_pose[b] = v, T_live[b].copy()
                n_kf[b] += 1

    errs = [float(np.linalg.norm(T_live[b][:3, 3] - T_true[b][:3, 3]))
            for b in range(B)]
    if max(errs) >= DRYRUN_TOL_M:
        raise AssertionError(f"final-pose errors vs truth {errs} >= "
                             f"{DRYRUN_TOL_M}")
    return errs
