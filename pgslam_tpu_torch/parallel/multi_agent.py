"""Multi-agent SLAM: N agents over one shared pose graph (BASELINE config
5, "16 SLAM instances sharing one pose graph").

Counterpart of :mod:`pgslam_tpu.parallel.multi_agent` on one device.
Each agent keeps its own Localizer state (local map, composition, pose
chain); every step registers the whole fleet in one batched registration
(one K2 launch on the card), evaluates every agent's overlap probe, then
serializes the graph mutations in agent order (deterministic), verifies
the keyframes spawned this step in one batch and runs one optimization
over every accepted closure. Optimization writebacks resync the agents at
the next step.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..cloud import Cloud, make_cloud, stack_clouds
from ..devices import resolve_device
from ..graph.pose_graph import MapManager
from ..localizer import (Localizer, prepare_input_batched,
                         probe_build_batched, probe_overlap_from_batched)
from ..localmap import batch_rebuild, stack_compositions
from ..loopcloser import LoopCloser
from ..ops.icp import to_host
from ..optimizer import Optimizer
from ..slam import SlamConfig
from .batched import batched_register


class MultiAgentSlam:
    """N SLAM agents over one shared pose graph, on ``device`` (the GPU
    unless the caller passes ``device="cpu"``). ``fused`` routes the
    fleet's registration batch as :func:`batched_register` does ("auto":
    K2 on the card, ``icp_core`` on the CPU; "on": K2, or its plain
    version on the CPU; "off": ``icp_core``)."""

    def __init__(self, config: SlamConfig, n_agents: int, mesh=None,
                 device=None, fused: str = "auto"):
        if mesh is not None:
            raise NotImplementedError(
                "the multi-device fleet (mesh=) is not ported yet")
        self.config = config
        self.n_agents = n_agents
        self.device = resolve_device(device)
        self.fused = fused
        self.map_manager = MapManager()
        self.optimizer = Optimizer(self.map_manager, config.optimizer,
                                   device=self.device)
        self.loop_closer = LoopCloser(self.map_manager, self.optimizer,
                                      config.loop_closer, device=self.device)
        self.localizers: List[Localizer] = []
        for _ in range(n_agents):
            loc = Localizer(self.map_manager, config.localizer,
                            device=self.device)
            loc.defer_graph_resync = True
            self.map_manager.add_localizer(loc)
            self.localizers.append(loc)
        self.map_manager.set_loop_closer(self.loop_closer)
        # Verify the step's new keyframes in one batch, and optimize once
        # per step over every accepted closure.
        self.loop_closer.queue_mode = True
        self.loop_closer.batch_pad_to = n_agents
        self.optimizer.queue_mode = True

    def prewarm(self) -> None:
        """Bring-up warm-up. Eager PyTorch traces nothing ahead of time,
        so this builds the kernel library on the card and leaves the graph
        untouched."""
        if self.device.type == "cuda":
            from .. import _build
            _build.lib()

    def add_data_batch(self, timestamp, world_frame_id: str,
                       T_world_robot: np.ndarray,      # [B, 4, 4]
                       T_robot_sensor: np.ndarray,     # [B, 4, 4] or [4, 4]
                       clouds: Sequence) -> None:
        """Feed one scan per agent; the fleet's registrations run as one
        batch."""
        del timestamp, world_frame_id
        B = self.n_agents
        if len(clouds) != B:
            raise ValueError(f"expected {B} clouds, got {len(clouds)}")
        T_world_robot = np.asarray(T_world_robot, np.float32)
        T_rs = np.asarray(T_robot_sensor, np.float32)
        if T_rs.ndim == 2:
            T_rs = np.repeat(T_rs[None], B, axis=0)

        # Phase 0: the resyncs that optimization writebacks deferred.
        resync = [loc for loc in self.localizers if loc._needs_resync]
        self._batched_set_map([loc for loc in resync
                               if loc.resync_from_graph(build=False)])

        # Input preparation and reading filters for the whole fleet.
        raw = [c if isinstance(c, Cloud) else make_cloud(
            np.asarray(c), capacity=self.config.sensor_cloud_capacity,
            device=self.device) for c in clouds]
        lcfg = self.config.localizer
        prepped, readings_all = prepare_input_batched(
            lcfg.input_filters, lcfg.keyframe_cloud_capacity, raw,
            torch.as_tensor(T_rs, device=self.device),
            reading_chain=lcfg.icp.reading_filters)
        preps = [loc.prepare_scan(T_world_robot[b], T_rs[b], raw[b],
                                  prepared=prepped[b],
                                  reading=readings_all[b])
                 for b, loc in enumerate(self.localizers)]
        live = [b for b, p in enumerate(preps) if p is not None]
        if not live:
            return

        # One registration batch at the fleet's size: the live agents
        # padded with copies of the first.
        pad_ix = live + [live[0]] * (B - len(live))
        references = stack_clouds([self.localizers[b].icp_engine.reference
                                   for b in pad_ix])
        readings = stack_clouds([preps[b][0] for b in pad_ix])
        T0s = torch.as_tensor(np.stack([preps[b][1] for b in pad_ix]),
                              device=self.device)
        results = batched_register(readings, references, T0s,
                                   self.config.localizer.icp,
                                   fused=self.fused)

        # Phase 1: pose updates and the overlap-probe requests.
        res_of, probe_req = {}, {}
        for i, b in enumerate(live):
            loc = self.localizers[b]
            res_of[b] = loc.begin_finish(to_host(results, index=i))
            comp = loc.neighbor_probe_request()
            if comp is not None:
                probe_req[b] = comp

        # Phase 2: every agent's overlap probe.
        probe_val = self._batched_probes(probe_req)

        # Phase 3: decisions and graph mutations in agent order (keyframe
        # insertions queue their verifications in the shared LoopCloser).
        changed = []
        for b in live:
            loc = self.localizers[b]
            loc.decide_composition(res_of[b], probe_req.get(b),
                                   probe_val.get(b))
            if loc.apply_composition(build=False):
                changed.append(loc)
            loc.last_input_T_world_robot = T_world_robot[b].copy()

        # Phase 4: the changed local maps in one batched build.
        self._batched_set_map(changed)

        # Phase 5: this step's verifications in one batch, then one
        # optimization over every accepted closure.
        self.loop_closer.process_pending_batched()
        self.optimizer.process_pending()

    def _batched_set_map(self, locs) -> None:
        """Rebuild the agents' changed local maps in one batched build and
        install each as its ICP reference (reference filter chain)."""
        if not locs:
            return
        batch_rebuild([loc.local_map for loc in locs], pad_to=self.n_agents)
        for loc in locs:
            loc.finish_apply()

    def _batched_probes(self, probe_req) -> dict:
        """Overlap of each requesting agent's reading against its
        candidate map; the probe-cache misses are built in one batched
        build."""
        if not probe_req:
            return {}
        keys = list(probe_req)
        locs = [self.localizers[b] for b in keys]
        worlds = [loc._probe_cache_get(probe_req[b])
                  for b, loc in zip(keys, locs)]
        miss = [i for i, w in enumerate(worlds) if w is None]
        if miss:
            comps = [probe_req[keys[i]] for i in miss]
            built = probe_build_batched(
                *stack_compositions(self.map_manager.get_graph(),
                                    [c.as_list() for c in comps],
                                    comps[0].capacity),
                self.config.localizer.icp.reference_filters)
            for i, comp, world in zip(miss, comps, built):
                worlds[i] = world
                locs[i]._probe_cache_put(comp, world)
        readings = [loc._last_reading for loc in locs]
        T_world_robots = [loc._tensor(loc.T_world_robot) for loc in locs]
        ovs = probe_overlap_from_batched(readings, worlds, T_world_robots,
                                         self.config.localizer.icp)
        ovs = ovs.cpu().numpy()
        return {b: float(ovs[i]) for i, b in enumerate(keys)}

    # -- state access --------------------------------------------------------

    def poses(self) -> np.ndarray:
        """Current robot pose per agent ``[B, 4, 4]``."""
        return np.stack([loc.T_world_robot for loc in self.localizers])

    def get_graph(self):
        return self.map_manager.get_graph()

    def trajectory(self) -> np.ndarray:
        g = self.map_manager.get_graph()
        return g.optimized_poses[:g.n_vertices].copy()

    def write_graphviz(self, path: str) -> None:
        self.map_manager.write_graphviz(path)
