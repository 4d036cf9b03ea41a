"""``icp_core`` with the decision to stop made on the device, and the CUDA
graphs that replay it on the card.

The host-decided loop (``icp._icp_loop``) reads its convergence test on
the host every iteration and leaves the loop early. Here each stage (the
coarse one, then the full one) runs to its cap instead: an iteration
starts with ``active = ~done``, an inactive one leaves T, the smoothed
``dts`` / ``drs`` windows, Anderson's window and the iteration count as
they were, and the same smoothed test sets ``done``. Active iterations
are a prefix, so T, ``iterations`` and ``converged`` are the host loop's
bit for bit, and so is every other field of the result.

A :class:`Registration` holds the state in static buffers of one shape
and splits a registration into *segments* that read and write only
those buffers, with a match between each two:

* ``start``: T from T_init, the first stage's entry (the windows reset,
  the reading at T, decimated for a coarse stage);
* ``body<s>``: weigh, minimize, check and mask one iteration of stage s,
  then the reading at the new T for the next match;
* ``enter<s>``: the entry of stage s > 0 at the T the last one left;
* ``final_a``: the bound check, ``converged`` and the reading at the
  result; ``final_b``: overlap, residual and covariance.

The match runs eagerly between segments, through ``icp.match_clouds``
(K1's wrapper, so its launch counters and the benchmark's K1 tally see
every launch, or the grid matcher), and is copied into static match
buffers. On the card each segment is captured once as a CUDA graph and
replayed (:func:`register`): nothing in the loop waits on the host.
Graphs live in one cache of the process, keyed by device, config,
reading and reference rows, dtype and whether the reference has
normals, so a new SLAM object reuses them. Capture warms up on a stream
of its own and synchronizes the device (wait site ``icp.capture``).
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
    Point-to-point keeps the host-decided loop: its SVD reads an error
    flag on the host, which no graph captures."""
    p = reading.points
    return (p.device.type == "cuda" and p.dim() == 2
            and p.dtype == torch.float32
            and reference.points.device == p.device
            and T_init.device == p.device
            and cfg.error == "point_to_plane"
            and "normals" in reference.descriptors)


class _Stage:
    """A stage's reading (static), the reading at the current T, its
    matches and its cap of iterations."""

    def __init__(self, cloud: Cloud, cap: int, k: int):
        self.cloud, self.cap = cloud, cap
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
    """The static buffers and segments of registrations shaped like
    ``reading`` against ``reference`` under ``cfg``."""

    def __init__(self, reading: Cloud, reference: Cloud, cfg):
        self.cfg = cfg
        dev, dt = reading.points.device, reading.points.dtype
        full = lambda *shape, v, dtype=dt: torch.full(
            shape, v, dtype=dtype, device=dev)
        self.reading = _empty_like_cloud(reading)
        self.reference = _empty_like_cloud(reference)
        if "normals" in reference.descriptors:
            self.reference.descriptors["normals"] = torch.empty_like(
                self.reference.points)
        self.T_start = full(4, 4, v=0.0)
        self.T = full(4, 4, v=0.0)
        L = max(1, cfg.smooth_length)
        self.dts, self.drs = full(L, v=0.0), full(L, v=0.0)
        self.done = full(v=False, dtype=torch.bool)
        self.iterations = full(v=0, dtype=torch.int32)
        self.aa = bool(cfg.anderson_m and cfg.anderson_m > 1)
        if self.aa:
            m = cfg.anderson_m
            self.X, self.GX = full(m, 6, v=0.0), full(m, 6, v=0.0)
            self.T0, self.Tinv0 = full(4, 4, v=0.0), full(4, 4, v=0.0)
            self.eye = torch.eye(m - 1, dtype=dt, device=dev)
        self.stages = []
        div = cfg.coarse_div
        if div and div > 1:
            n = len(range(0, reading.points.shape[0], div))
            self.stages.append(_Stage(_empty_like_cloud(reading, n),
                                      cfg.coarse_iterations, cfg.knn))
        self.stages.append(_Stage(self.reading, cfg.max_iterations,
                                  cfg.knn))
        # The result's other fields (its iterations are the state's).
        self.T_out = full(4, 4, v=0.0)
        self.diverged = full(v=False, dtype=torch.bool)
        self.converged = full(v=False, dtype=torch.bool)
        self.max_iter_reached = full(v=False, dtype=torch.bool)
        self.overlap, self.residual = full(v=0.0), full(v=0.0)
        self.cov = full(6, 6, v=0.0)
        self.segments = {"start": self.start, "final_a": self.final_a,
                         "final_b": self.final_b}
        for s in range(len(self.stages)):
            self.segments[f"body{s}"] = (lambda s=s: self.body(s))
            if s:
                self.segments[f"enter{s}"] = (lambda s=s: self.enter(s))
        self.graphs: Optional[Dict[str, torch.cuda.CUDAGraph]] = None
        self.lock = threading.Lock()
        self.event = None

    # -- inputs and outputs -------------------------------------------------

    def load(self, reading: Cloud, reference: Cloud, T_init) -> None:
        """Copy a registration's inputs into the static buffers."""
        self.reading.points.copy_(reading.points)
        self.reading.mask.copy_(reading.mask)
        self.reference.points.copy_(reference.points)
        self.reference.mask.copy_(reference.mask)
        if "normals" in self.reference.descriptors:
            self.reference.descriptors["normals"].copy_(
                reference.descriptors["normals"])
        self.T_start.copy_(T_init)

    def result(self) -> I.ICPResult:
        """The result, copied out of the static buffers (the next
        registration overwrites them)."""
        return I.ICPResult(
            T=self.T_out.clone(), iterations=self.iterations.clone(),
            converged=self.converged.clone(),
            max_iter_reached=self.max_iter_reached.clone(),
            overlap=self.overlap.clone(), residual=self.residual.clone(),
            cov=self.cov.clone(), diverged=self.diverged.clone())

    # -- segments -------------------------------------------------------------

    def start(self) -> None:
        self.T.copy_(self.T_start)
        if len(self.stages) > 1:
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
            self.T0.copy_(self.T)
            self.Tinv0.copy_(se3.inverse(self.T))
        st = self.stages[s]
        st.pts.copy_(se3.apply(self.T, st.cloud.points))

    def body(self, s: int) -> None:
        """One iteration of stage s from its matches, masked by ``done``."""
        cfg, st, T = self.cfg, self.stages[s], self.T
        active = ~self.done
        T_new, delta = I._minimize(st.pts, st.cloud.mask, self.reference,
                                   st.matches, T, cfg)
        if self.aa:
            T_new, X, GX = I._anderson(
                T, T_new, self.X, self.GX, self.T0, self.Tinv0, self.eye,
                self.iterations + 1 >= cfg.anderson_m)
            delta = T_new @ se3.inverse(T)
        dts = torch.cat([se3.translation_norm(delta)[None], self.dts[:-1]])
        drs = torch.cat([se3.rotation_angle(delta)[None], self.drs[:-1]])
        converged = (dts.mean() < cfg.trans_eps) & (drs.mean() < cfg.rot_eps)
        self.T.copy_(torch.where(active, T_new, T))
        self.dts.copy_(torch.where(active, dts, self.dts))
        self.drs.copy_(torch.where(active, drs, self.drs))
        if self.aa:
            self.X.copy_(torch.where(active, X, self.X))
            self.GX.copy_(torch.where(active, GX, self.GX))
        # An inactive iteration's test is its frozen windows', true.
        self.done.copy_(self.done | converged)
        self.iterations.add_(active.to(torch.int32))
        st.pts.copy_(se3.apply(self.T, st.cloud.points))

    def final_a(self) -> None:
        T, diverged = I.bound_check(self.T, self.T_start, self.cfg)
        self.T_out.copy_(T)
        self.diverged.copy_(diverged)
        self.converged.copy_(self.done & ~diverged)
        st = self.stages[-1]
        st.pts.copy_(se3.apply(T, self.reading.points))

    def final_b(self) -> None:
        cfg, st = self.cfg, self.stages[-1]
        weights = O.compute_weights(cfg.outlier, st.matches,
                                    self.reading.mask)
        elems = I.build_error_elements(st.pts, self.reference, st.matches,
                                       weights, cfg)
        self.max_iter_reached.copy_((self.iterations >= cfg.max_iterations)
                                    & ~self.converged)
        self.overlap.copy_(M.overlap(weights, self.reading.count()))
        self.residual.copy_(M.residual_error(elems, cfg.error))
        self.cov.copy_(M.covariance(elems, cfg.error))

    # -- running a registration -----------------------------------------------

    def match(self, s: int, index) -> None:
        st = self.stages[s]
        m = I.match_clouds(st.pts, st.cloud.mask, self.reference, self.cfg,
                           index)
        st.matches.dists2.copy_(m.dists2)
        st.matches.ids.copy_(m.ids)

    def run(self, index, call, count: bool = True) -> None:
        """One registration over the loaded buffers: ``call(name)`` runs
        segment ``name`` (eagerly, or as a replay), the matches between
        them. Every iteration to the caps counts in ``icp.iterations``."""
        call("start")
        for s, st in enumerate(self.stages):
            if s:
                call(f"enter{s}")
            for _ in range(st.cap):
                self.match(s, index)
                call(f"body{s}")
                if count:
                    timing.count("icp.iterations")
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
    """The same registration run segment by segment without graphs, on
    any device (what the graphs replay; the CPU tests hold it to the
    host-decided loop)."""
    reg = Registration(reading, reference, cfg)
    reg.load(reading, reference, T_init)
    reg.run(index, reg.eager)
    return reg.result()
