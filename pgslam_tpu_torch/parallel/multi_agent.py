"""Multi-agent SLAM: N agents over one shared pose graph (BASELINE config
5, "16 SLAM instances sharing one pose graph").

Counterpart of :mod:`pgslam_tpu.parallel.multi_agent`. Each agent keeps
its own Localizer state (local map, composition, pose chain); every step
registers the whole fleet in one batched registration (one K2 launch on
the card), evaluates every agent's overlap probe, then serializes the
graph mutations in agent order (deterministic), verifies the keyframes
spawned this step in one batch and runs one optimization over every
accepted closure. Optimization writebacks resync the agents at the next
step.

With a (dp, tp) ``mesh`` (:func:`.multichip.make_mesh`) the fleet's
registration runs over it: with tp > 1 the sharded registration
(:mod:`.sharded_icp`, agents over dp, each reference's points over tp),
with tp = 1 :func:`batched_register` on each dp chunk on its device
(:func:`.batched.shard_batch`). Everything else stays on the mesh's
first device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..cloud import (Cloud, dequantize_cloud, make_cloud, make_cloud_batch,
                     pad_cloud, stack_clouds, upload)
from ..devices import resolve_device
from ..graph.pose_graph import MapManager
from ..localizer import (Localizer, prepare_input_batched,
                         probe_build_batched, probe_overlap_from_batched)
from ..localmap import batch_rebuild, stack_compositions
from ..loopcloser import LoopCloser
from ..ops.icp import HostFetch, pack_result, unpack_result
from ..optimizer import Optimizer
from ..slam import SlamConfig
from ..utils import timing
from .batched import batched_register, concat_results, shard_batch
from .multichip import Mesh
from .sharded_icp import make_sharded_register


def _same_device(a, b) -> bool:
    """Whether two device specs name one device ("cuda" is the current
    card)."""
    def norm(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


class MultiAgentSlam:
    """N SLAM agents over one shared pose graph, on ``device`` (the GPU
    unless the caller passes ``device="cpu"``). ``fused`` routes the
    fleet's registration batch as :func:`batched_register` does ("auto":
    K2 on the card, ``icp_core`` on the CPU; "on": K2, or its plain
    version on the CPU; "off": ``icp_core``). With a ``mesh``
    (:class:`.multichip.Mesh`) the fleet lives on ``mesh.devices[0, 0]``
    (a ``device`` that differs raises) and registers over the mesh."""

    def __init__(self, config: SlamConfig, n_agents: int, mesh=None,
                 device=None, fused: str = "auto"):
        self.config = config
        self.n_agents = n_agents
        self.mesh = mesh
        self._tp = 1
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.multichip.Mesh, "
                                f"not {type(mesh).__name__}")
            home = mesh.devices[0, 0]
            if device is not None and not _same_device(device, home):
                raise ValueError(f"device={device} differs from the mesh's "
                                 f"first device {home}")
            device = home
            self._tp = int(mesh.shape.get("tp", 1))
            if self._tp > 1:
                self._sharded = make_sharded_register(mesh,
                                                      config.localizer.icp)
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
        with timing.span("pgslam.fleet.step", step=True):
            timing.count("steps")
            timing.count("scans", self.n_agents)
            self._step(T_world_robot, T_robot_sensor, clouds)

    def _step(self, T_world_robot, T_robot_sensor, clouds) -> None:
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

        # Input preparation and reading filters for the whole fleet, as
        # one batch: one upload of the step's scans and transforms.
        with timing.span("pgslam.fleet.prepare"):
            raw, T_rs_dev = self._upload_scans(clouds, T_rs)
            lcfg = self.config.localizer
            prep = prepare_input_batched(
                lcfg.input_filters, lcfg.keyframe_cloud_capacity, raw,
                T_rs_dev, reading_chain=lcfg.icp.reading_filters,
                seeds=[loc.count for loc in self.localizers])
            timing.count("fleet.prepare.per_agent" if lcfg.input_filters
                         else "fleet.prepare.batched")
            preps = [loc.prepare_scan(T_world_robot[b], T_rs[b], None,
                                      prepared=prep.clouds[b],
                                      reading=prep.readings[b])
                     for b, loc in enumerate(self.localizers)]
            live = [b for b, p in enumerate(preps) if p is not None]
            if not live:
                return

            # One registration batch at the fleet's size: the live agents
            # padded with copies of the first. With every agent live the
            # readings are the prepared batch itself.
            pad_ix = live + [live[0]] * (B - len(live))
            references = stack_clouds(
                [self.localizers[b].icp_engine.reference for b in pad_ix])
            if len(live) == B and prep.reading_batch is not None:
                readings = prep.reading_batch
            else:
                readings = stack_clouds([preps[b][0] for b in pad_ix])
            (T0s,) = upload([np.stack([preps[b][1] for b in pad_ix])],
                            self.device)
        # One host copy of the fleet's results, packed.
        with timing.span("pgslam.fleet.register"):
            vec = HostFetch(pack_result(
                self._register(readings, references, T0s))).get()

        # Phase 1: pose updates and the overlap-probe requests.
        res_of, probe_req = {}, {}
        with timing.span("pgslam.fleet.agents"):
            for i, b in enumerate(live):
                loc = self.localizers[b]
                res_of[b] = loc.begin_finish(unpack_result(vec[i])[0])
                comp = loc.neighbor_probe_request()
                if comp is not None:
                    probe_req[b] = comp

        # Phase 2: every agent's overlap probe.
        probe_val = self._batched_probes(probe_req)

        # Phase 3: decisions and graph mutations in agent order (keyframe
        # insertions queue their verifications in the shared LoopCloser).
        changed = []
        with timing.span("pgslam.fleet.agents"):
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

    def _upload_scans(self, clouds, T_rs: np.ndarray):
        """The step's scans as one ``[B, sensor capacity]`` cloud and the
        sensor transforms on the fleet's device: arrays in one upload
        (:func:`make_cloud_batch`); clouds already on the device are
        dequantized, padded to the largest capacity (padding compacts
        away) and stacked."""
        cap = self.config.sensor_cloud_capacity
        if not any(isinstance(c, Cloud) for c in clouds):
            raw, (T_rs_dev,) = make_cloud_batch(clouds, cap, self.device,
                                                riders=[T_rs])
            return raw, T_rs_dev
        cs = [dequantize_cloud(c) if isinstance(c, Cloud) else make_cloud(
            np.asarray(c), capacity=cap, device=self.device) for c in clouds]
        top = max(c.capacity for c in cs)
        raw = stack_clouds([pad_cloud(c, top) for c in cs])
        (T_rs_dev,) = upload([T_rs], self.device)
        return raw, T_rs_dev

    def _register(self, readings: Cloud, references: Cloud, T0s):
        """The fleet's registration batch: over the mesh where there is
        one, else one :func:`batched_register` call."""
        cfg = self.config.localizer.icp
        if self._tp > 1:
            return self._sharded(readings, references, T0s)
        if self.mesh is not None:
            chunks = shard_batch(self.mesh)((readings, references, T0s))
            return concat_results([batched_register(*c, cfg, fused=self.fused)
                                   for c in chunks], self.device)
        return batched_register(readings, references, T0s, cfg,
                                fused=self.fused)

    def _batched_set_map(self, locs) -> None:
        """Rebuild the agents' changed local maps in one batched build and
        install each as its ICP reference (reference filter chain)."""
        if not locs:
            return
        batch_rebuild([loc.local_map for loc in locs], pad_to=self.n_agents)
        for loc in locs:
            loc.finish_apply()

    @timing.spanned("pgslam.fleet.probes")
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
            with timing.span("pgslam.localmap.build"):
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
        with timing.wait("probes.fetch"):
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
