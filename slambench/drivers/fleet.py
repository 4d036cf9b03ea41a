"""Driver of ``MultiAgentSlam.add_data_batch``: every agent's scan of a
step in one call over one shared pose graph, closed loop, a synchronize
of the device after each step. A session is a fresh fleet fed the mix's
steps in order.

What the check needs is copied inside the step (each agent's state as
its registration starts, the graph as the verification starts) and
after it; ``record_s`` sums the seconds those copies take."""

from __future__ import annotations

import time

import numpy as np

from slambench.core import record as R

SPANS = (("", "_register", "registration"),
         ("", "_batched_probes", "probes"),
         ("", "_batched_set_map", "map_builds"),
         ("loop_closer", "process_pending_batched", "verify"),
         ("optimizer", "process_pending", "optimize"))
T_ROBOT_SENSOR = np.eye(4, dtype=np.float32)


class Driver:
    def __init__(self, cfg: dict, slam_config, session, devices, spans=None):
        self.cfg, self.slam_config = cfg, slam_config
        self.session, self.devices, self.spans = session, devices, spans
        self.n_agents = int(cfg["agents"])
        self.scans_per_step = self.n_agents
        self.fleet = None
        self.rec = None
        self._verif = None
        self.record_s = 0.0

    def open(self) -> R.SessionRecord:
        from pgslam_tpu_torch import MultiAgentSlam
        fleet = MultiAgentSlam(self.slam_config, self.n_agents,
                               device=self.devices[0])
        self.fleet, self.rec = fleet, R.SessionRecord()
        self._capture(fleet)
        if self.spans is not None:
            for comp, attr, name in SPANS:
                obj = getattr(fleet, comp) if comp else fleet
                self.spans.wrap(obj, attr, name)
        return self.rec

    def _capture(self, fleet) -> None:
        """Read each agent's state as its registration starts, and copy
        the graph as the step's verification starts."""
        register = fleet._register
        verify = fleet.loop_closer.process_pending_batched
        g = fleet.map_manager.get_graph()

        def captured_register(*a, **kw):
            t = time.perf_counter()
            self._regs = [R.agent_state(loc, g, self._i, b)
                          for b, loc in enumerate(fleet.localizers)]
            self.record_s += time.perf_counter() - t
            return register(*a, **kw)

        def captured_verify(*a, **kw):
            t = time.perf_counter()
            self._verif = R.Verification(step=self._i,
                                         n_before=self._n_before,
                                         graph=R.graph_snapshot(g))
            self.record_s += time.perf_counter() - t
            return verify(*a, **kw)

        fleet._register = captured_register
        fleet.loop_closer.process_pending_batched = captured_verify

    def step(self, i: int) -> None:
        fleet, rec, s = self.fleet, self.rec, self.session
        g = fleet.map_manager.get_graph()
        self._i, self._n_before = i, g.n_vertices
        self._regs, self._verif = [], None
        fleet.add_data_batch(i, "world", s.odom[i], T_ROBOT_SENSOR,
                             s.step_clouds(i))
        self.sync()
        t = time.perf_counter()
        for reg, loc in zip(self._regs, fleet.localizers):
            reg.T = np.array(loc.last_result.T, np.float32)
            rec.regs.append(reg)
        v = self._verif
        if v is not None:
            R.close_verification(v, g, fleet.optimizer)
            rec.verifications.append(v)
        R.note_new_vertices(rec, g, i, fleet.localizers)
        self.record_s += time.perf_counter() - t

    def sync(self) -> None:
        import torch
        if self.devices[0].type == "cuda":
            torch.cuda.synchronize(self.devices[0])

    def close(self) -> None:
        g = self.fleet.map_manager.get_graph()
        self.rec.fixed = int(self.fleet.map_manager.get_fixed_vertex() or 0)
        self.rec.edges = R.final_edges(g)
        self.fleet = None
