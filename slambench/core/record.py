"""What the timed window produced, kept for the correctness check after
the window has closed.

The drivers read the program's public state between and around its
calls, never its inputs to a kernel: per registration the local map's
composition and the graph poses of its keyframes, the relative pose and
the odometry it started from, and the registration it returned; per
step of a fleet, and per keyframe of one robot whose check judges its
closures (:func:`judges_closures`), the graph the loop closer searched
(copied when its verification starts) and the edges and poses the step
left; per session which step and agent each keyframe came from. Each
copy is a few small host arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


CLOSURE_LIMITS = ("closure_gap_m", "pgo_gap_sigma")


def judges_closures(cfg: dict) -> bool:
    """Whether the configuration's check judges the loop closer and the
    back end, so that the drivers record each step's verification."""
    return any(k in cfg["check"]["limits"] for k in CLOSURE_LIMITS)


@dataclasses.dataclass
class Registration:
    step: int
    agent: int
    comp: Tuple[int, ...]        # the local map's keyframes, reference last
    comp_poses: np.ndarray       # their graph poses [k, 4, 4]
    T_refkf_prev: np.ndarray     # relative pose after the previous scan
    odom_prev: np.ndarray        # the previous scan's odometry
    T: Optional[np.ndarray] = None   # the registration returned


@dataclasses.dataclass
class Verification:
    """One step's loop-closure stage and optimization."""
    step: int
    n_before: int                # vertices before the step
    graph: Dict[str, np.ndarray]  # the graph when verification started
    e_after: int = 0             # edges after the step
    poses_after: Optional[np.ndarray] = None   # poses after an optimize
    lm_stats: Optional[dict] = None            # the optimizer's own stats
    program: Optional[dict] = None             # one robot's verification


@dataclasses.dataclass
class SessionRecord:
    vertex_src: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)    # vertex -> (step, agent)
    regs: List[Registration] = dataclasses.field(default_factory=list)
    verifications: List[Verification] = dataclasses.field(
        default_factory=list)
    fixed: int = 0
    edges: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)


def graph_snapshot(g) -> Dict[str, np.ndarray]:
    n, e = g.n_vertices, g.n_edges
    return {"n": n, "e": e, "poses": g.optimized_poses[:n].copy(),
            "edge_from": g.edge_from[:e].copy(),
            "edge_to": g.edge_to[:e].copy(),
            "edge_weight": g.edge_weight[:e].copy(),
            "edge_type": g.edge_type[:e].copy()}


def close_verification(ver: Verification, g, optimizer) -> None:
    """After the step: the edges, and where it added any the optimized
    poses of the vertices the loop closer searched and the optimizer's
    stats."""
    ver.e_after = g.n_edges
    if ver.e_after > ver.graph["e"]:
        ver.poses_after = g.optimized_poses[:ver.graph["n"]].copy()
        ver.lm_stats = dict(optimizer.last_stats or {})


def verification_outcome(v: int, ref_v: int, res) -> dict:
    """What one verification of keyframe ``v`` against the candidate map
    of ``ref_v`` returned."""
    return {"vertex": int(v), "ref_vertex": int(ref_v),
            "overlap": float(res.overlap),
            "iterations": int(res.iterations),
            "converged": bool(res.converged),
            "max_iter_reached": bool(res.max_iter_reached)}


def final_edges(g) -> Dict[str, np.ndarray]:
    e = g.n_edges
    return {"edge_from": g.edge_from[:e].copy(),
            "edge_to": g.edge_to[:e].copy(), "edge_T": g.edge_T[:e].copy(),
            "edge_cov": g.edge_cov[:e].copy(),
            "edge_type": g.edge_type[:e].copy()}


def agent_state(loc, g, step: int, agent: int) -> Registration:
    """A localizer's state before its registration."""
    comp = tuple(loc.local_map.get_composition().as_list())
    return Registration(step=step, agent=agent, comp=comp,
                        comp_poses=g.optimized_poses[list(comp)].copy(),
                        T_refkf_prev=np.array(loc.T_refkf_robot, np.float32),
                        odom_prev=np.array(loc.last_input_T_world_robot,
                                           np.float32))


def note_new_vertices(rec: SessionRecord, g, step: int, locs) -> None:
    """Each vertex added in this step came from the agent whose local map
    now ends on it."""
    backs = {}
    for b, loc in enumerate(locs):
        comp = loc.local_map.get_composition().as_list()
        if comp:
            backs[comp[-1]] = b
    for v in range(len(rec.vertex_src), g.n_vertices):
        if v not in backs:
            raise RuntimeError(f"keyframe {v} of step {step} is in no "
                               f"agent's local map")
        rec.vertex_src.append((step, backs[v]))
