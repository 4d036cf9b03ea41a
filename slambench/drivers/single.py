"""Driver of ``PoseGraphSlam.add_data``: one robot, one scan at a time,
closed loop, a device synchronize after each scan (the pose is then on
the host, where the robot reads it). A session is a fresh
``PoseGraphSlam`` fed the mix's steps in order. ``record_s`` sums the
seconds the step spends copying what the check needs.

Where the configuration's check judges the loop closer and the back end
(``record.judges_closures``), the step also copies the graph as the loop
closer's ``process_vertex`` starts on the step's new keyframe, with the
verification's outcome, and after the step the edges and, when it added
a closure, the optimized poses (``record.Verification``, as the fleet's
driver does). Otherwise the step does no more than the registration's
copies."""

from __future__ import annotations

import time

import numpy as np

from slambench.core import record as R

SPANS = (("localizer", "process_data", "frontend"),
         ("loop_closer", "process_vertex", "loop_closer"),
         ("optimizer", "process_data", "optimizer"))
T_ROBOT_SENSOR = np.eye(4, dtype=np.float32)


class Driver:
    scans_per_step = 1

    def __init__(self, cfg: dict, slam_config, session, devices, spans=None):
        self.cfg, self.slam_config = cfg, slam_config
        self.session, self.devices, self.spans = session, devices, spans
        self.slam = None
        self.rec = None
        self._verif = None
        self.record_s = 0.0

    def open(self) -> R.SessionRecord:
        from pgslam_tpu_torch import PoseGraphSlam
        self.slam = PoseGraphSlam(self.slam_config, device=self.devices[0])
        if R.judges_closures(self.cfg):
            self._capture(self.slam)
        if self.spans is not None:
            for comp, attr, name in SPANS:
                self.spans.wrap(getattr(self.slam, comp), attr, name)
        self.rec = R.SessionRecord()
        return self.rec

    def _capture(self, slam) -> None:
        """Copy the graph as the loop closer starts on a new keyframe, and
        read what its verification returned."""
        lc = slam.loop_closer
        process_vertex = lc.process_vertex
        g = slam.map_manager.get_graph()

        def captured(v):
            t = time.perf_counter()
            self._verif = R.Verification(step=self._i,
                                         n_before=self._n_before,
                                         graph=R.graph_snapshot(g))
            before = lc.last_result
            self.record_s += time.perf_counter() - t
            out = process_vertex(v)
            t = time.perf_counter()
            res = lc.last_result
            if res is not before:
                self._verif.program = R.verification_outcome(
                    v, lc.candidate_local_map.reference_vertex(), res)
            self.record_s += time.perf_counter() - t
            return out

        lc.process_vertex = captured

    def step(self, i: int) -> None:
        slam, rec, s = self.slam, self.rec, self.session
        loc, g = slam.localizer, slam.map_manager.get_graph()
        self._i, self._n_before, self._verif = i, g.n_vertices, None
        t = time.perf_counter()
        reg = R.agent_state(loc, g, i, 0) if i > 0 else None
        self.record_s += time.perf_counter() - t
        slam.add_data(i, "world", s.odom[i, 0], T_ROBOT_SENSOR,
                      s.scans[s.index[i, 0]])
        self.sync()
        t = time.perf_counter()
        if reg is not None:
            reg.T = np.array(loc.last_result.T, np.float32)
            rec.regs.append(reg)
        v = self._verif
        if v is not None:
            R.close_verification(v, g, slam.optimizer)
            rec.verifications.append(v)
        R.note_new_vertices(rec, g, i, [loc])
        self.record_s += time.perf_counter() - t

    def sync(self) -> None:
        import torch
        if self.devices[0].type == "cuda":
            torch.cuda.synchronize(self.devices[0])

    def close(self) -> None:
        g = self.slam.map_manager.get_graph()
        self.rec.fixed = int(self.slam.map_manager.get_fixed_vertex() or 0)
        self.rec.edges = R.final_edges(g)
        self.slam = None
