"""The multi-threaded pipeline: :class:`PoseGraphSlamMT` and the ``*MT``
components. Counterpart of :mod:`pgslam_tpu.pipeline`: three worker
threads (localize, loop-close, optimize) around one pose graph guarded by
a reentrant lock, with the reference's locking discipline:

* localizer: the registration runs unlocked; the commit (pose
  composition, the decision tree, the local-map rebuild) holds the graph
  lock. An optimizer's notification only sets an ``outdated`` flag that
  the worker consumes at the top of its loop.
* loop closer: the candidate search holds the lock, the verification
  runs unlocked on the snapshot it took.
* optimizer: drains every pending constraint into one batch; the LM
  solve runs unlocked between its two locked phases, and the writeback
  covers only the vertices the problem held.

Every worker stays on the default CUDA stream. A worker that raises keeps
the exception; :meth:`PoseGraphSlamMT.wait_idle`, ``flush`` and ``stop``
raise it again.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from .cloud import Cloud, make_cloud
from .devices import resolve_device
from .graph.pose_graph import LOOP_CONSTRAINT, MapManager
from .localizer import Localizer, LocalizerConfig
from .loopcloser import LoopCloser, LoopCloserConfig
from .optimizer import Optimizer, OptimizerConfig
from .slam import SlamConfig, assemble_global_map

log = logging.getLogger("pgslam_tpu_torch.pipeline")

# The localizer's queue item that asks its worker to flush, and what
# _Worker._next returns for a wake-up with an empty queue.
_FLUSH = object()
_NOTHING = object()


class MapManagerMT(MapManager):
    """A MapManager with the graph lock."""

    def __init__(self):
        super().__init__()
        self._graph_lock = threading.RLock()

    def get_graph_lock(self) -> threading.RLock:
        return self._graph_lock


class WorkerError(RuntimeError):
    """A pipeline worker failed; the worker's exception is the cause."""


class _Worker:
    """A worker thread: a queue, a condition, a stop flag, and the
    exception that ended its loop."""

    def __init__(self, name: str):
        self._name = name
        self._queue = deque()
        self._mutex = threading.Lock()
        self._cond = threading.Condition(self._mutex)
        self._stop = False
        self._busy = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        # Besides its queue, what else wakes the worker (read under
        # _mutex); pending wake-ups keep it from counting as idle.
        self._wake = lambda: False

    def run(self) -> None:
        log.info("[%s] Starting main thread...", self._name)
        self._stop = False
        self._thread = threading.Thread(target=self._guarded_main,
                                        name=self._name, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._mutex:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _enqueue(self, item) -> None:
        with self._mutex:
            self._queue.append(item)
            self._cond.notify()

    def idle(self) -> bool:
        """Nothing queued and nothing running (or the worker failed)."""
        with self._mutex:
            return self._error is not None or not (
                self._queue or self._busy or self._wake())

    def raise_error(self) -> None:
        if self._error is not None:
            raise WorkerError(f"{self._name} failed: {self._error!r}") \
                from self._error

    def _guarded_main(self) -> None:
        try:
            self._main()
        except Exception as e:  # the worker's boundary: kept and re-raised
            log.exception("[%s] worker failed", self._name)
            with self._mutex:
                self._error = e
                self._busy = False

    def _next(self):
        """Wait for an item or a wake-up and mark the worker busy; None
        once stopped, ``_NOTHING`` for a wake-up with an empty queue."""
        with self._mutex:
            while not self._queue and not self._stop and not self._wake():
                self._cond.wait()
            if self._stop:
                return None
            self._busy = True
            return self._queue.popleft() if self._queue else _NOTHING

    def _done(self) -> None:
        with self._mutex:
            self._busy = False

    def _main(self):  # pragma: no cover - overridden
        raise NotImplementedError


class LocalizerMT(Localizer, _Worker):
    """The localizer on its own thread."""

    def __init__(self, map_manager: MapManagerMT,
                 config: LocalizerConfig = LocalizerConfig(), device=None):
        if config.micro_batch > 1:
            # Buffered scans would wait in the buffer with no flush to
            # come between drains; the worker already overlaps the scans.
            raise ValueError(
                "LocalizerConfig.micro_batch is a single-threaded "
                "streaming mode; the MT pipeline would strand buffered "
                "scans. Use sync_lag (and deferred_verification) with "
                "PoseGraphSlamMT instead.")
        Localizer.__init__(self, map_manager, config, device=device)
        _Worker.__init__(self, "LocalizerMT")
        self._outdated = False
        self._wake = lambda: self._outdated

    def add_new_data(self, timestamp, world_frame_id, T_world_robot,
                     T_robot_sensor, cloud: Cloud) -> None:
        self._enqueue((np.asarray(T_world_robot, np.float32),
                       np.asarray(T_robot_sensor, np.float32), cloud))

    def request_flush(self) -> None:
        """Have the worker commit every in-flight scan after the scans
        queued before this call."""
        self._enqueue(_FLUSH)

    def _main(self):
        while True:
            item = self._next()
            if item is None:
                return
            # The resync an optimization asked for runs before the next
            # scan, and also when no scan waits.
            with self._mutex:
                outdated, self._outdated = self._outdated, False
            if outdated:
                with self.mm.get_graph_lock():
                    Localizer.update_from_graph(self)
            if item is _FLUSH:
                Localizer.flush(self)
            elif item is not _NOTHING:
                self.process_data(*item)
            self._done()

    def process_first_cloud(self, cloud, T_world_robot) -> None:
        with self.mm.get_graph_lock():
            Localizer.process_first_cloud(self, cloud, T_world_robot)

    def _commit(self, inflight, fresh=None) -> None:
        # The reference's MT localizer commits under the graph lock; the
        # JAX package's does not (pgslam_tpu/pipeline.py:152-156 is never
        # reached from process_data). No extra resync is added, so the
        # numbers stay the JAX package's.
        with self.mm.get_graph_lock():
            Localizer._commit(self, inflight, fresh)

    def update_from_graph(self) -> None:
        """Only flag: the worker resyncs at the top of its loop."""
        with self._mutex:
            self._outdated = True
            self._cond.notify()


class LoopCloserMT(LoopCloser, _Worker):
    """The loop closer on its own thread."""

    def __init__(self, map_manager: MapManagerMT, optimizer,
                 config: LoopCloserConfig = LoopCloserConfig(), device=None):
        LoopCloser.__init__(self, map_manager, optimizer, config,
                            device=device)
        _Worker.__init__(self, "LoopCloserMT")

    def add_new_vertex(self, v: int) -> None:
        self._enqueue(int(v))

    def _main(self):
        while True:
            v = self._next()
            if v is None:
                return
            self.process_vertex(v)
            self._done()

    def process_local_map_candidate(self) -> bool:
        # The search and the input snapshot under the lock; the
        # verification that follows runs unlocked.
        with self.mm.get_graph_lock():
            return LoopCloser.process_local_map_candidate(self)


class OptimizerMT(Optimizer, _Worker):
    """The optimizer on its own thread."""

    def __init__(self, map_manager: MapManagerMT,
                 config: OptimizerConfig = OptimizerConfig(), device=None):
        Optimizer.__init__(self, map_manager, config, device=device)
        _Worker.__init__(self, "OptimizerMT")

    def add_new_data(self, from_v, to_v, T_from_to, cov_from_to) -> None:
        self._enqueue((int(from_v), int(to_v),
                       np.asarray(T_from_to, np.float32),
                       np.asarray(cov_from_to, np.float32)))

    def _main(self):
        while True:
            first = self._next()
            if first is None:
                return
            # Every pending constraint joins one batch.
            with self._mutex:
                self.data_buffer = [first] + list(self._queue)
                self._queue.clear()
            self.process_data()
            self._done()

    def prepare_for_optimization(self):
        with self.mm.get_graph_lock():
            return Optimizer.prepare_for_optimization(self)

    def prepare_for_optimization_resident(self):
        # The mirror's snapshot reads the graph under the lock; its solve
        # runs unlocked (OptimizerMT.hpp:71-82).
        with self.mm.get_graph_lock():
            return Optimizer.prepare_for_optimization_resident(self)

    def update_after_optimization(self, new_poses) -> None:
        with self.mm.get_graph_lock():
            Optimizer.update_after_optimization(self, new_poses)


class PoseGraphSlamMT:
    """Multi-threaded facade: the workers start with :meth:`run` (or the
    context manager) and scans are queued by :meth:`add_data`. ``device``
    is where the clouds and every kernel run: the card by default, the
    CPU with ``device="cpu"``."""

    def __init__(self, config: SlamConfig = SlamConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        self.map_manager = MapManagerMT()
        self.optimizer = OptimizerMT(self.map_manager, config.optimizer,
                                     device=self.device)
        self.loop_closer = LoopCloserMT(self.map_manager, self.optimizer,
                                        config.loop_closer,
                                        device=self.device)
        self.localizer = LocalizerMT(self.map_manager, config.localizer,
                                     device=self.device)
        self.map_manager.set_localizer(self.localizer)
        self.map_manager.set_loop_closer(self.loop_closer)
        self._workers = (self.localizer, self.loop_closer, self.optimizer)

    def run(self) -> None:
        """Start the three workers. On the card the kernel library is
        built first, once, before any worker can launch."""
        if self.device.type == "cuda":
            from . import _build
            _build.lib()
        for w in self._workers:
            w.run()

    Run = run

    def stop(self) -> None:
        """Stop and join the workers; raise a worker's failure."""
        for w in self._workers:
            w.stop()
        self._raise_errors()

    def __enter__(self):
        self.run()
        return self

    def __exit__(self, *exc):
        for w in self._workers:
            w.stop()
        if exc[0] is None:
            self._raise_errors()
        return False

    def _raise_errors(self) -> None:
        for w in self._workers:
            w.raise_error()

    def wait_idle(self, timeout: float = 60.0, poll: float = 0.02) -> bool:
        """Block until every queue is drained and every worker idle; False
        after ``timeout`` seconds. Raises a worker's failure."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._raise_errors()
            if all(w.idle() for w in self._workers):
                # Once more after a poll: a worker may be handing work on.
                time.sleep(poll)
                if all(w.idle() for w in self._workers):
                    self._raise_errors()
                    return True
            time.sleep(poll)
        self._raise_errors()
        return False

    # -- data entry --------------------------------------------------------

    def add_data(self, timestamp, world_frame_id, T_world_robot,
                 T_robot_sensor, cloud) -> None:
        if not isinstance(cloud, Cloud):
            cloud = make_cloud(np.asarray(cloud),
                               capacity=self.config.sensor_cloud_capacity,
                               device=self.device)
        self.localizer.add_new_data(timestamp, world_frame_id, T_world_robot,
                                    T_robot_sensor, cloud)

    AddData = add_data

    def flush(self, timeout: float = 600.0) -> None:
        """Have the localizer's worker commit its in-flight scans
        (``sync_lag``) and wait until the pipeline is idle."""
        self.localizer.request_flush()
        if not self.wait_idle(timeout=timeout):
            raise TimeoutError(f"the pipeline was not idle after {timeout} s")

    # -- state access ------------------------------------------------------

    def get_graph(self):
        return self.map_manager.get_graph()

    def trajectory(self) -> np.ndarray:
        with self.map_manager.get_graph_lock():
            g = self.map_manager.get_graph()
            return g.optimized_poses[:g.n_vertices].copy()

    def n_loop_edges(self) -> int:
        with self.map_manager.get_graph_lock():
            g = self.map_manager.get_graph()
            return int(np.sum(g.edge_type[:g.n_edges] == LOOP_CONSTRAINT))

    def write_graphviz(self, path: str) -> None:
        with self.map_manager.get_graph_lock():
            self.map_manager.write_graphviz(path)

    WriteGraphviz = write_graphviz

    @property
    def T_world_robot(self) -> np.ndarray:
        return self.localizer.T_world_robot

    def get_local_map(self):
        return self.localizer.get_local_map()

    def get_local_map_in_world_frame(self):
        return self.localizer.get_local_map_in_world_frame()

    def global_map(self, max_points_per_keyframe: int = 0) -> np.ndarray:
        """``PoseGraphSlam.global_map`` of the graph as it stands, read
        under the graph lock."""
        with self.map_manager.get_graph_lock():
            return assemble_global_map(self.map_manager.get_graph(),
                                       max_points_per_keyframe)
