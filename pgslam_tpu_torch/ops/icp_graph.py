"""The ICP loop of ``icp.icp_core``, as segments over static buffers,
run two ways with the same bits.

Each stage (the coarse one, then the full one) is a run of iterations:
one starts with ``active = ~done``, an inactive one leaves T, the
smoothed ``dts`` / ``drs`` windows, Anderson's window and the iteration
count as they were, and the smoothed test sets ``done``. Active
iterations are a prefix, so a stage run to its cap and a stage left as
soon as ``done`` is set give the same T, ``iterations`` and
``converged``, bit for bit, and so every other field of the result.

A :class:`Registration` holds the state in buffers of one shape and
splits a registration into *segments* that read and write only those
buffers, with a match between each two:

* ``start``: T from T_init, the first stage's entry (the windows reset,
  the reading at T, decimated for a coarse stage);
* ``body<s>``: weigh, minimize, check and mask one iteration of stage s,
  then the reading at the new T for the next match;
* ``enter<s>``: the entry of stage s > 0 at the T the last one left;
* ``final_a``: the bound check, ``converged`` and the reading at the
  result; ``final_b``: overlap, residual and covariance.

The match runs eagerly between segments, through ``icp.match_clouds``
(K1's wrapper, so its launch counters and the benchmark's K1 tally see
every launch, or the grid matcher). The two ways:

* :func:`register` (point-to-plane on the card, :func:`graph_route`):
  the buffers are static, the matches are copied into them, and each
  segment is captured once as a CUDA graph and replayed, every stage to
  its cap; nothing in the loop waits on the host. Graphs live
  in one cache of the process, keyed by device, config, reading and
  reference rows, dtype and whether the reference has normals, so a new
  SLAM object reuses them. Capture warms up on a stream of its own and
  synchronizes the device (wait site ``icp.capture``).
* :func:`register_eager` (everything else, on any device): the segments
  of a :class:`Registration` made for the one run (not ``static``) run
  as plain calls over the inputs themselves, and the host reads
  ``done`` after each iteration (wait site ``icp.converged``) and leaves
  the stage once it is set. Every iteration that runs is active, so a
  segment binds what it computes where the graphs copy it, masked, into
  their buffers; the matches are bound the same way.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from .. import se3
from ..cloud import Cloud
from ..utils import timing
from . import icp as I
from . import minimizer as M
from . import outlier as O
from .knn import Matches


def graph_route(reading: Cloud, reference: Cloud, T_init: torch.Tensor,
                cfg) -> bool:
    """Whether ``icp_core`` runs as graph replays: one fp32 registration
    on a CUDA device, point-to-plane against a reference with normals.
    Point-to-point runs eagerly: its SVD reads an error flag on the host,
    which no graph captures."""
    p = reading.points
    return (p.device.type == "cuda" and p.dim() == 2
            and p.dtype == torch.float32
            and reference.points.device == p.device
            and T_init.device == p.device
            and cfg.error == "point_to_plane"
            and "normals" in reference.descriptors)


class _Stage:
    """A stage's reading, the reading at the current T, its matches and
    its cap of iterations (the first two static for the graphs)."""

    def __init__(self, cloud: Cloud, cap: int, k: int, static: bool):
        self.cloud, self.cap = cloud, cap
        self.pts = self.matches = None
        if static:
            n = cloud.points.shape[0]
            self.pts = torch.empty_like(cloud.points)
            self.matches = Matches(
                dists2=torch.empty((n, k), dtype=cloud.points.dtype,
                                   device=cloud.points.device),
                ids=torch.empty((n, k), dtype=torch.int32,
                                device=cloud.points.device))


def _empty_like_cloud(cloud: Cloud, rows=None) -> Cloud:
    n = cloud.points.shape[0] if rows is None else rows
    dev, dt = cloud.points.device, cloud.points.dtype
    return Cloud(points=torch.empty((n, 3), dtype=dt, device=dev),
                 mask=torch.empty((n,), dtype=torch.bool, device=dev))


class Registration:
    """The buffers and segments of registrations shaped like ``reading``
    against ``reference`` under ``cfg``.

    ``static`` (for the graphs): every buffer is static, a segment writes
    in place and an iteration after ``done`` leaves the state as it was.
    Otherwise the registration of ``reading`` runs once, eagerly: the
    inputs are its buffers, a segment binds what it writes, and the run
    leaves a stage once it has converged, so every iteration that runs
    is active and needs no mask."""

    def __init__(self, reading: Cloud, reference: Cloud, cfg,
                 static: bool = True):
        self.cfg, self.static = cfg, static
        dev, dt = reading.points.device, reading.points.dtype
        full = lambda *shape, v, dtype=dt: torch.full(
            shape, v, dtype=dtype, device=dev)
        # The state each stage's entry resets in place.
        L = max(1, cfg.smooth_length)
        self.dts, self.drs = full(L, v=0.0), full(L, v=0.0)
        self.done = full(v=False, dtype=torch.bool)
        self.iterations = full(v=0, dtype=torch.int32)
        self.aa = bool(cfg.anderson_m and cfg.anderson_m > 1)
        if self.aa:
            m = cfg.anderson_m
            self.X, self.GX = full(m, 6, v=0.0), full(m, 6, v=0.0)
            self.eye = torch.eye(m - 1, dtype=dt, device=dev)
        div, coarse = cfg.coarse_div, []
        if div and div > 1:
            n = len(range(0, reading.points.shape[0], div))
            coarse.append(_empty_like_cloud(reading, n) if static else
                          reading.map(lambda a: a[::div].contiguous()))
        if static:
            self.reading = _empty_like_cloud(reading)
            self.reference = _empty_like_cloud(reference)
            if "normals" in reference.descriptors:
                self.reference.descriptors["normals"] = torch.empty_like(
                    self.reference.points)
            self.T_start, self.T = full(4, 4, v=0.0), full(4, 4, v=0.0)
            if self.aa:
                self.T0, self.Tinv0 = full(4, 4, v=0.0), full(4, 4, v=0.0)
            # The result's other fields (its iterations are the state's).
            self.T_out = full(4, 4, v=0.0)
            self.diverged = full(v=False, dtype=torch.bool)
            self.converged = full(v=False, dtype=torch.bool)
            self.max_iter_reached = full(v=False, dtype=torch.bool)
            self.overlap, self.residual = full(v=0.0), full(v=0.0)
            self.cov = full(6, 6, v=0.0)
        else:
            self.reading, self.reference = reading, reference
        self.stages = [_Stage(c, cfg.coarse_iterations, cfg.knn, static)
                       for c in coarse]
        self.stages.append(_Stage(self.reading, cfg.max_iterations,
                                  cfg.knn, static))
        self.segments = {"start": self.start, "final_a": self.final_a,
                         "final_b": self.final_b}
        for s in range(len(self.stages)):
            self.segments[f"body{s}"] = (lambda s=s: self.body(s))
            if s:
                self.segments[f"enter{s}"] = (lambda s=s: self.enter(s))
        self.graphs: Optional[Dict[str, torch.cuda.CUDAGraph]] = None
        self.lock = threading.Lock()
        self.event = None

    def _set(self, owner, name: str, value, active=None) -> None:
        """``owner.<name>`` takes ``value``: bound in an eager run; in
        place in a static buffer, and there only where ``active`` (the
        iteration's mask) holds, where it is given."""
        if not self.static:
            setattr(owner, name, value)
            return
        buf = getattr(owner, name)
        buf.copy_(value if active is None
                  else torch.where(active, value, buf))

    # -- inputs and outputs -------------------------------------------------

    def load(self, reading: Cloud, reference: Cloud, T_init) -> None:
        """Copy a registration's inputs into the static buffers (an eager
        registration, made over its clouds, takes only ``T_init``)."""
        if not self.static:
            p = self.reading.points
            self.T_start = T_init.to(device=p.device, dtype=p.dtype)
            return
        self.reading.points.copy_(reading.points)
        self.reading.mask.copy_(reading.mask)
        self.reference.points.copy_(reference.points)
        self.reference.mask.copy_(reference.mask)
        if "normals" in self.reference.descriptors:
            self.reference.descriptors["normals"].copy_(
                reference.descriptors["normals"])
        self.T_start.copy_(T_init)

    def result(self) -> I.ICPResult:
        """The result; copied out of static buffers, which the next
        registration overwrites."""
        fields = dict(T=self.T_out, iterations=self.iterations,
                      converged=self.converged,
                      max_iter_reached=self.max_iter_reached,
                      overlap=self.overlap, residual=self.residual,
                      cov=self.cov, diverged=self.diverged)
        if self.static:
            fields = {k: v.clone() for k, v in fields.items()}
        return I.ICPResult(**fields)

    # -- segments -------------------------------------------------------------

    def start(self) -> None:
        self._set(self, "T", self.T_start)
        if len(self.stages) > 1 and self.static:
            c = self.stages[0].cloud
            div = self.cfg.coarse_div
            c.points.copy_(self.reading.points[::div])
            c.mask.copy_(self.reading.mask[::div])
        self.enter(0)

    def enter(self, s: int) -> None:
        """Stage s starts at the current T: fresh windows and count."""
        self.dts.fill_(float("inf"))
        self.drs.fill_(float("inf"))
        self.done.fill_(False)
        self.iterations.zero_()
        if self.aa:
            self.X.zero_()
            self.GX.zero_()
            self._set(self, "T0", self.T)
            self._set(self, "Tinv0", se3.inverse(self.T))
        st = self.stages[s]
        self._set(st, "pts", se3.apply(self.T, st.cloud.points))

    def body(self, s: int) -> None:
        """One iteration of stage s from its matches, masked by ``done``
        in static buffers."""
        cfg, st, T = self.cfg, self.stages[s], self.T
        active = ~self.done if self.static else None
        T_new, delta = I._minimize(st.pts, st.cloud.mask, self.reference,
                                   st.matches, T, cfg)
        if self.aa:
            T_new, X, GX = I._anderson(
                T, T_new, self.X, self.GX, self.T0, self.Tinv0, self.eye,
                self.iterations + 1 >= cfg.anderson_m)
            delta = T_new @ se3.inverse(T)
            self._set(self, "X", X, active)
            self._set(self, "GX", GX, active)
        dts = torch.cat([se3.translation_norm(delta)[None], self.dts[:-1]])
        drs = torch.cat([se3.rotation_angle(delta)[None], self.drs[:-1]])
        converged = (dts.mean() < cfg.trans_eps) & (drs.mean() < cfg.rot_eps)
        self._set(self, "T", T_new, active)
        self._set(self, "dts", dts, active)
        self._set(self, "drs", drs, active)
        # An inactive iteration's test is its frozen windows', true.
        self._set(self, "done", self.done | converged)
        self.iterations.add_(1 if active is None else active.to(torch.int32))
        self._set(st, "pts", se3.apply(self.T, st.cloud.points))

    def final_a(self) -> None:
        T, diverged = I.bound_check(self.T, self.T_start, self.cfg)
        self._set(self, "T_out", T)
        self._set(self, "diverged", diverged)
        self._set(self, "converged", self.done & ~diverged)
        st = self.stages[-1]
        self._set(st, "pts", se3.apply(T, self.reading.points))

    def final_b(self) -> None:
        cfg, st = self.cfg, self.stages[-1]
        weights = O.compute_weights(cfg.outlier, st.matches,
                                    self.reading.mask)
        elems = I.build_error_elements(st.pts, self.reference, st.matches,
                                       weights, cfg)
        self._set(self, "max_iter_reached",
                  (self.iterations >= cfg.max_iterations) & ~self.converged)
        self._set(self, "overlap", M.overlap(weights, self.reading.count()))
        self._set(self, "residual", M.residual_error(elems, cfg.error))
        self._set(self, "cov", M.covariance(elems, cfg.error))

    # -- running a registration -----------------------------------------------

    def match(self, s: int, index) -> None:
        st = self.stages[s]
        m = I.match_clouds(st.pts, st.cloud.mask, self.reference, self.cfg,
                           index)
        if not self.static:
            st.matches = m
            return
        st.matches.dists2.copy_(m.dists2)
        st.matches.ids.copy_(m.ids)

    def run(self, index, call, count: bool = True) -> None:
        """One registration over the buffers: ``call(name)`` runs segment
        ``name`` (eagerly, or as a replay), the matches between them.
        Over static buffers each stage runs to its cap; otherwise the
        host reads ``done`` after each iteration and leaves the stage
        once it is set. Every iteration run counts in
        ``icp.iterations``."""
        call("start")
        for s, st in enumerate(self.stages):
            if s:
                call(f"enter{s}")
            for _ in range(st.cap):
                self.match(s, index)
                call(f"body{s}")
                if count:
                    timing.count("icp.iterations")
                if not self.static:
                    with timing.wait("icp.converged"):
                        if bool(self.done):
                            break
        call("final_a")
        self.match(len(self.stages) - 1, index)
        call("final_b")

    def eager(self, name: str) -> None:
        self.segments[name]()

    def replay(self, name: str) -> None:
        self.graphs[name].replay()

    def capture(self, index) -> None:
        """Warm up on a side stream (one eager registration of the loaded
        inputs), then capture every segment on it."""
        stream = torch.cuda.Stream(self.T.device)
        stream.wait_stream(torch.cuda.current_stream(self.T.device))
        with torch.cuda.stream(stream):
            self.run(index, self.eager, count=False)
        torch.cuda.current_stream(self.T.device).wait_stream(stream)
        graphs = {}
        for name, fn in self.segments.items():
            graph = torch.cuda.CUDAGraph()
            # Capture synchronizes the device first.
            with timing.wait("icp.capture"):
                with torch.cuda.graph(graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    fn()
            timing.count("icp.graph.captures")
            graphs[name] = graph
        self.graphs = graphs


_CACHE: Dict[tuple, Registration] = {}
_CACHE_LOCK = threading.Lock()


def _key(reading: Cloud, reference: Cloud, cfg) -> tuple:
    return (reading.points.device, cfg, reading.points.shape[0],
            reference.points.shape[0], reading.points.dtype,
            "normals" in reference.descriptors)


def registration(reading: Cloud, reference: Cloud, cfg) -> Registration:
    """The cached :class:`Registration` of this shape (made at first
    use)."""
    key = _key(reading, reference, cfg)
    reg = _CACHE.get(key)
    if reg is None:
        with _CACHE_LOCK:
            reg = _CACHE.get(key)
            if reg is None:
                reg = _CACHE[key] = Registration(reading, reference, cfg)
    return reg


def register(reading: Cloud, reference: Cloud, T_init: torch.Tensor, cfg,
             index=None) -> I.ICPResult:
    """``icp_core`` as replays of the shape's CUDA graphs (captured at
    the first registration of the shape in the process)."""
    reg = registration(reading, reference, cfg)
    dev = reading.points.device
    with reg.lock, torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        if reg.event is not None:
            # The last registration may have run on another stream.
            stream.wait_event(reg.event)
        reg.load(reading, reference, T_init)
        if reg.graphs is None:
            reg.capture(index)
        reg.run(index, reg.replay)
        result = reg.result()
        reg.event = torch.cuda.Event()
        reg.event.record(stream)
    timing.count("icp.graph.registrations")
    return result


def register_eager(reading: Cloud, reference: Cloud, T_init: torch.Tensor,
                   cfg, index=None) -> I.ICPResult:
    """``icp_core`` with the segments of a fresh :class:`Registration`
    run eagerly, on any device, each stage left once it has converged."""
    timing.count("icp.eager.registrations")
    reg = Registration(reading, reference, cfg, static=False)
    reg.load(reading, reference, T_init)
    reg.run(index, reg.eager)
    return reg.result()
