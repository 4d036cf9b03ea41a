"""The comparison that decides ``correct``: what the timed window
produced, against the plain reference (``slambench/core/reference``),
which works everything out again from the benchmark's own inputs (the
rendered scans and the odometry).

The reference follows the program step by step: each registration is
recomputed from the program's state just before it (which keyframes the
local map holds, their poses in the graph, the relative pose after the
previous scan), since a SLAM run is a chain in which every step starts
from the last. What that skips, the keyframe and composition decisions,
shows in the next registrations' maps: a wrong keyframe pose or a wrong
map moves them. The numbers compared, each the widest over its sample:

* ``reg_gap_m``, ``reg_gap_agent_m``, ``reg_settle_agent_m``: the front
  end. A sample of each agent's registrations in the window, drawn from
  the seed; the gap between the program's and the reference's transform
  is how far apart they put a point at the sensor's range,
  ``|dt| + range * angle(dR)``; the widest gap, and the widest over the
  agents of each agent's median gap. A fleet's trimmed ICP along a
  corridor can end a registration at another converged solution after a
  last-bit difference, on some seeds for many of one agent's
  registrations, so ``reg_settle_agent_m`` takes for each registration
  the smaller of its gap and how far the reference's ICP, started from
  the program's answer, moves it (near zero where that answer is itself
  a converged registration of the reference): an answer that is neither
  the reference's nor converged reads large, and one agent's
  registrations gone wrong move its median. Where a compared one is over
  its limit, ``reg_widest`` shows where the widest gap lies. The reference runs the
  ICP semantics of the route the program takes: the classic loop, or
  at ``"k2"`` those of the fused kernel (``reference/k2.py``, a batch at
  a time). The configuration's ``check.route`` names it for the
  registrations and the verifications alike (a string), or for each
  (``{"front": ..., "verify": ...}``, :func:`routes`).
* ``closure_gap_m``: the loop closer. Every step of sampled sessions:
  the reference's own candidate search on the graph the program searched,
  its verification ICP, its acceptance; the same gap for a closure both
  accept, ``DECISION_M`` for a decision the reference does not share
  (none where a threshold decides it by less than its knife edge).
* ``pgo_gap_sigma`` (and ``pgo_step_m``): the back end. After every
  optimization of those sessions, the Gauss-Newton step (float64) that
  the reference would still take from the program's poses on the graph
  the program optimized: zero at the optimum; the widest over the
  session in the graph's standard deviations (in metres at the range).

``readings(control=True)`` puts the reference, computed with TF32
matmuls (the nearest precision below the configurations' float32 with
TF32 off), in the program's place and reads the same numbers.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from .reference import geometry as G
from .reference import graph as RG
from .reference import icp as RI
from .reference import pgo as RP
from .record import judges_closures
from .slamconfig import icp_section

DECISION_M = 1.0
SAMPLE_SALT = 0x5A17
BATCH = 16
ROUTES = ("classic", "k2")
SECTIONS = ("front", "verify")


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def pose_gap(A: np.ndarray, B: np.ndarray, reach: float) -> float:
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    dR = A[:3, :3].T @ B[:3, :3]
    c = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    s = 0.5 * np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                              dR[1, 0] - dR[0, 1]])
    return float(np.linalg.norm(A[:3, 3] - B[:3, 3])
                 + reach * np.arctan2(s, c))


def routes(check: dict) -> Dict[str, str]:
    """The reference's ICP route for each section, ``front`` (the
    localizer's registrations) and ``verify`` (the loop closer's): the
    check's ``route``, a string for both or an object with one for each,
    ``"classic"`` where it is absent."""
    route = check.get("route", "classic")
    if isinstance(route, str):
        route = {"front": route, "verify": route}
    if set(route) != set(SECTIONS) or not set(route.values()) <= set(ROUTES):
        raise ValueError(f"check.route {route!r}: one of {ROUTES} for "
                         f"each of {SECTIONS}")
    return route


class Reference:
    """The reference's view of one run: the configuration's ICP
    sections, the keyframe clouds from the rendered scans, and cached
    local maps."""

    def __init__(self, cfg: dict, session, device):
        self.cfg, self.session, self.device = cfg, session, device
        slam = cfg["slam"]
        route = routes(cfg["check"])
        self.front = dict(icp_section(cfg, slam["localizer"]["icp"]),
                          route=route["front"])
        self.verify = dict(icp_section(cfg, slam["loop_closer"]["icp"]),
                           route=route["verify"])
        self.lc = slam["loop_closer"]
        self.kf_cap = slam["localizer"]["keyframe_cloud_capacity"]
        self.reach = session.max_range
        self._maps = {}

    def scan(self, step: int, agent: int) -> G.Cloud:
        pts = self.session.scans[self.session.index[step, agent]]
        return G.cloud_from_points(pts, self.device, capacity=self.kf_cap)

    def local_map(self, rec, comp, poses, icp_cfg) -> G.Cloud:
        """The keyframes' clouds in the last one's frame, concatenated in
        order, through the reference filter chain."""
        key = (id(rec), tuple(comp), poses.tobytes(), id(icp_cfg))
        hit = self._maps.get(key)
        if hit is not None:
            return hit
        Tref_inv = np.linalg.inv(np.asarray(poses[-1], np.float64))
        parts = []
        for v, P in zip(comp, poses):
            T = (Tref_inv @ np.asarray(P, np.float64)).astype(np.float32)
            c = self.scan(*rec.vertex_src[v])
            parts.append(G.apply(torch.as_tensor(T, device=self.device),
                                 c.points))
        pts = torch.cat(parts)
        cloud = G.Cloud(points=pts, mask=torch.ones(
            pts.shape[0], dtype=torch.bool, device=self.device))
        cloud = RI.prepare_reference(cloud, icp_cfg)
        if len(self._maps) > 64:
            self._maps.clear()
        self._maps[key] = cloud
        return cloud

    def _inputs(self, rec, reg):
        """(reading, local map, starting transform) of a registration."""
        odom = self.session.odom[reg.step, reg.agent]
        dT = (np.linalg.inv(np.asarray(reg.odom_prev, np.float64))
              @ np.asarray(odom, np.float64)).astype(np.float32)
        T0 = torch.as_tensor(reg.T_refkf_prev @ dT, device=self.device)
        ref = self.local_map(rec, reg.comp, reg.comp_poses, self.front)
        reading = RI.prepare_reading(self.scan(reg.step, reg.agent),
                                     self.front)
        return reading, ref, T0

    def registration(self, rec, reg) -> np.ndarray:
        return RI.register(*self._inputs(rec, reg), self.front
                           ).T.cpu().numpy()

    def registrations(self, picked, starts=None) -> List[np.ndarray]:
        """The reference's transforms of ``[(record, registration)]``,
        each from its own starting transform or from ``starts``; the K2
        route runs them ``BATCH`` at a time."""
        ins = [self._inputs(rec, reg) for rec, reg in picked]
        if starts is not None:
            ins = [(r, m, torch.as_tensor(np.asarray(T, np.float32),
                                          device=self.device))
                   for (r, m, _), T in zip(ins, starts)]
        if self.front["route"] != "k2":
            return [RI.register(*i, self.front).T.cpu().numpy()
                    for i in ins]
        return [r.T.cpu().numpy() for r in self._batched(ins, self.front)]

    @staticmethod
    def _batched(ins, cfg):
        """K2-route results of ``[(reading, map, T0)]``, ``BATCH`` at a
        time."""
        out = []
        for i in range(0, len(ins), BATCH):
            part = ins[i:i + BATCH]
            out += RI.register_batch([r for r, _, _ in part],
                                     [m for _, m, _ in part],
                                     torch.stack([t for _, _, t in part]),
                                     cfg)
        return out

    def _verify_inputs(self, rec, graph, v: int, comp):
        poses = graph["poses"][list(comp)]
        ref = self.local_map(rec, comp, poses, self.verify)
        T0 = (np.linalg.inv(np.asarray(poses[-1], np.float64))
              @ np.asarray(graph["poses"][v], np.float64)
              ).astype(np.float32)
        reading = RI.prepare_reading(self.scan(*rec.vertex_src[v]),
                                     self.verify)
        return reading, ref, torch.as_tensor(T0, device=self.device)

    def verification(self, rec, graph, v: int, comp):
        """The reference's verification of keyframe ``v`` against the
        candidate composition ``comp`` of the graph snapshot."""
        return RI.register(*self._verify_inputs(rec, graph, v, comp),
                           self.verify)

    def verifications(self, rec, graph, items):
        """The verifications of ``[(v, comp)]``, a batch at a time on the
        K2 route."""
        ins = [self._verify_inputs(rec, graph, v, c) for v, c in items]
        if self.verify["route"] != "k2":
            return [RI.register(*i, self.verify) for i in ins]
        return self._batched(ins, self.verify)

    def accepts(self, res) -> bool:
        return (not res.diverged and not res.max_iter_reached
                and res.overlap >= self.lc["overlap_threshold"]
                and not res.residual > self.lc.get(
                    "residual_error_threshold", 5000.0))

    def knife_edge(self, res) -> bool:
        """A decision a rounding could flip: the overlap within 0.01 of
        its threshold, or the ICP stopping within 3 iterations of its
        cap."""
        return (abs(res.overlap - self.lc["overlap_threshold"]) < 0.01
                or res.iterations >= self.verify["max_iterations"] - 3)


def widest_look(ref: Reference, rec, reg) -> Dict:
    """Where the widest registration gap lies: the translation and angle
    between the two transforms, and how far the reference's ICP moves
    the program's transform when started from it (near zero where the
    program's answer is itself a converged registration)."""
    with matmul_precision(False):
        T_ref = ref.registration(rec, reg)
        fr = ref.local_map(rec, reg.comp, reg.comp_poses, ref.front)
        reading = RI.prepare_reading(ref.scan(reg.step, reg.agent),
                                     ref.front)
        pol = RI.register(reading, fr, torch.as_tensor(
            reg.T, device=ref.device), ref.front)
    P = pol.T.cpu().numpy()
    return {"dt": (reg.T[:3, 3] - T_ref[:3, 3]).tolist(),
            "gap_m": pose_gap(reg.T, T_ref, ref.reach),
            "polish_m": pose_gap(reg.T, P, ref.reach),
            "polish_iterations": pol.iterations}


def sample(seed: int, n: int, k: int) -> List[int]:
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, SAMPLE_SALT])
    if n <= k:
        return list(range(n))
    return sorted(rng.choice(n, size=k, replace=False).tolist())


def choose(records, seed: int, cfg: dict):
    """The sampled registrations ``[(record, registration)]``, each
    agent's ``check.registrations`` drawn apart, and sessions for the
    loop-closure and back-end checks."""
    chk = cfg["check"]
    picked = []
    for b in range(int(cfg["agents"])):
        regs = [(r, g) for r in records for g in r.regs if g.agent == b]
        picked += [regs[i] for i in sample(seed + 7919 * b, len(regs),
                                           chk["registrations"])]
    sess = [records[i] for i in sample(seed + 1, len(records),
                                       chk["sessions"])]
    return picked, sess


def closure_readings(ref: Reference, rec, program_T) -> Dict:
    """Widest closure gap over a session's steps, the knife edges left
    out, the verifications compared and the program's closures.
    ``program_T(verification, v)`` gives the program's accepted closure
    into ``v`` as ``(ref_v, T)`` or None."""
    worst, knife, compared, accepted_prog, flips = 0.0, 0, 0, 0, []
    for ver in rec.verifications:
        g = ver.graph
        accepted = set()
        cands = [(v,) + tuple(RG.candidate(g, v, ref.lc))
                 for v in range(ver.n_before, g["n"])]
        found = [(v, comp) for v, comp, _ in cands if comp is not None]
        results = dict(zip((v for v, _ in found),
                           ref.verifications(rec, g, found)))
        for v, comp, edge in cands:
            prog = program_T(ver, v)
            accepted_prog += prog is not None
            if comp is None:
                if prog is not None:
                    if edge:
                        knife += 1
                    else:
                        worst = max(worst, DECISION_M)
                        flips.append(_flip(ver, v, None, None))
                continue
            res = results[v]
            ref_v = comp[-1]
            dup = (bool(np.any(((g["edge_from"] == ref_v)
                                & (g["edge_to"] == v))
                               | ((g["edge_from"] == v)
                                  & (g["edge_to"] == ref_v))))
                   or (ref_v, v) in accepted or (v, ref_v) in accepted)
            ok = not dup and ref.accepts(res)
            if ok:
                accepted.add((ref_v, v))
            compared += 1
            if ok and prog is not None and prog[0] == ref_v:
                worst = max(worst, pose_gap(prog[1], res.T.cpu().numpy(),
                                            ref.reach))
            elif ok != (prog is not None) or (ok and prog[0] != ref_v):
                if ref.knife_edge(res) or edge:
                    knife += 1
                else:
                    worst = max(worst, DECISION_M)
                    flips.append(_flip(ver, v, comp, res, ok))
    return {"closure_gap_m": worst, "closure_knife_edges": knife,
            "closures_compared": compared, "closures_accepted": accepted_prog,
            "closure_flips": flips}


def _flip(ver, v, comp, res, accepted=False) -> Dict:
    """A closure decision the reference does not share, outside a knife
    edge: the step, the keyframe, the reference's candidate and
    verification, and the program's where its driver read it."""
    out = {"step": ver.step, "vertex": v, "program": ver.program}
    if comp is not None:
        out["reference"] = {"ref_vertex": comp[-1], "accepted": accepted,
                            "overlap": res.overlap,
                            "iterations": res.iterations,
                            "converged": res.converged,
                            "residual": res.residual}
    return out


def program_closures(rec):
    """The program's closures: the loop edges each step added."""
    E = rec.edges

    def find(ver, v):
        for e in range(ver.graph["e"], ver.e_after):
            if E["edge_type"][e] == RG.LOOP_EDGE and E["edge_to"][e] == v:
                return int(E["edge_from"][e]), E["edge_T"][e]
        return None
    return find


def pgo_reading(ref: Reference, rec, poses_of):
    """The widest Gauss-Newton step from the poses ``poses_of(ver)``
    gives after each optimization of a session: (in standard deviations,
    in metres at the range)."""
    worst, worst_m, look = 0.0, 0.0, {}
    E = rec.edges
    for ver in rec.verifications:
        if ver.poses_after is None:
            continue
        e = ver.e_after
        dev, dt = torch.device("cpu"), torch.float64
        args = [torch.as_tensor(E[k][:e], device=dev)
                for k in ("edge_from", "edge_to")]
        args += [torch.as_tensor(E[k][:e], device=dev, dtype=dt)
                 for k in ("edge_T", "edge_cov")]
        poses = torch.as_tensor(poses_of(ver), dtype=dt)
        anchor = torch.as_tensor(ver.graph["poses"][rec.fixed], dtype=dt)
        step, g = RP.gauss_newton_step(poses, *args, rec.fixed, anchor)
        s = RP.sigma(step, g)
        if s >= worst:
            worst, look = s, {"step": ver.step, "vertices": len(poses),
                              "edges": e, "lm": ver.lm_stats}
        worst_m = max(worst_m, float(RP.displacement(step, ref.reach).max()))
    return worst, worst_m, look


def readings(cfg: dict, session, records, seed: int, device,
             control: bool = False) -> Dict[str, float]:
    """The numbers compared: the program's against the reference, or,
    with ``control``, the TF32 reference's in the program's place."""
    ref = Reference(cfg, session, device)
    picked, sessions = choose(records, seed, cfg)
    out: Dict[str, float] = {}
    with matmul_precision(False):
        T_ref = ref.registrations(picked)
    if control:
        with matmul_precision(True):
            T_prog = Reference(cfg, session, device).registrations(picked)
    else:
        T_prog = [reg.T for _, reg in picked]
    gaps = [pose_gap(a, b, ref.reach) for a, b in zip(T_prog, T_ref)]
    limits = cfg["check"]["limits"]
    settle = gaps
    if "reg_settle_agent_m" in limits:
        with matmul_precision(False):
            T_pol = ref.registrations(picked, starts=T_prog)
        settle = [min(g, pose_gap(a, b, ref.reach))
                  for g, a, b in zip(gaps, T_prog, T_pol)]
    by_agent, settle_by_agent = {}, {}
    for (_, reg), gap, st in zip(picked, gaps, settle):
        by_agent.setdefault(reg.agent, []).append(gap)
        settle_by_agent.setdefault(reg.agent, []).append(st)
    # A window that registered nothing shows nothing correct.
    out["reg_gap_m"] = float(max(gaps)) if gaps else float("inf")
    out["reg_gap_agent_m"], out["reg_settle_agent_m"] = (float(max(
        (np.median(g) for g in d.values()), default=float("inf")))
        for d in (by_agent, settle_by_agent))
    out["registrations_compared"] = len(picked)
    if gaps and not control and any(out[k] > limits[k] for k in (
            "reg_gap_m", "reg_gap_agent_m", "reg_settle_agent_m")
            if k in limits):
        out["reg_widest"] = widest_look(ref, *picked[int(np.argmax(gaps))])
    if not judges_closures(cfg):
        return out
    cg, knife, compared, closed, pg, pm = 0.0, 0, 0, 0, 0.0, 0.0
    with matmul_precision(False):
        for rec in sessions:
            if control:
                prog_T = _control_closures(cfg, session, rec, device)
                poses_of = _control_poses(rec, device)
            else:
                prog_T = program_closures(rec)
                poses_of = (lambda ver: ver.poses_after)
            c = closure_readings(ref, rec, prog_T)
            cg = max(cg, c["closure_gap_m"])
            knife += c["closure_knife_edges"]
            compared += c["closures_compared"]
            closed += c["closures_accepted"]
            if not control and c["closure_flips"]:
                out.setdefault("closure_flips", []).extend(
                    c["closure_flips"][:8])
            sg, sm, look = pgo_reading(ref, rec, poses_of)
            if sg >= pg and not control:
                out["pgo_worst"] = look
            pg, pm = max(pg, sg), max(pm, sm)
    out.update(closure_gap_m=cg, closure_knife_edges=knife,
               closures_compared=compared, closures_accepted=closed,
               pgo_gap_sigma=pg, pgo_step_m=pm)
    return out


def _control_closures(cfg, session, rec, device):
    """The TF32 reference's verifications in the program's place."""
    ctl = Reference(cfg, session, device)

    def find(ver, v):
        with matmul_precision(True):
            comp, _ = RG.candidate(ver.graph, v, ctl.lc)
            if comp is None:
                return None
            res = ctl.verification(rec, ver.graph, v, comp)
            if not ctl.accepts(res):
                return None
            return comp[-1], res.T.cpu().numpy()
    return find


def _control_poses(rec, device):
    """The TF32 reference's optimization, float32 on the device, in the
    program's place."""
    E = rec.edges

    def poses_of(ver):
        e, dt = ver.e_after, torch.float32
        with matmul_precision(True):
            args = [torch.as_tensor(E[k][:e], device=device)
                    for k in ("edge_from", "edge_to")]
            args += [torch.as_tensor(E[k][:e], device=device, dtype=dt)
                     for k in ("edge_T", "edge_cov")]
            P0 = torch.as_tensor(ver.graph["poses"], device=device, dtype=dt)
            out = RP.solve(P0, *args, rec.fixed, P0[rec.fixed])
        return out.cpu().numpy()
    return poses_of


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(values[k] <= lim for k, lim in limits.items())


def lines(values: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"{k} {values[k]!r} limit {lim!r}" for k, lim in limits.items()]


def checks_json(values, limits) -> Dict[str, Dict[str, float]]:
    return {k: {"value": values[k], "limit": lim}
            for k, lim in limits.items()}
