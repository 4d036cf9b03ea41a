"""Host-side C++ runtime pieces, loaded with ctypes.

``graph_core.cpp`` is the pose graph's shortest-path core (weighted
Dijkstra with vertex and edge suppression and an early stop, and
connected components); ``scan_loader.cpp`` streams a directory of KITTI
``.bin`` scans from a background reader thread. Both are built at first
use by the host ``g++`` into ``pgslam_tpu_torch/_build/``, named by a
hash of the sources, so an edited source is rebuilt and a stale library
is never loaded. Where the build fails the callers fall back to the pure
Python paths (:mod:`pgslam_tpu_torch.graph.shortest_path`,
:func:`pgslam_tpu_torch.datasets.load_kitti_bin`);
:func:`native_available` says which is in use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

from .._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("graph_core.cpp", "scan_loader.cpp")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as fh:
            h.update(name.encode())
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libpgslam_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless the one for these sources exists;
    returns its path. Raises ``RuntimeError`` when ``g++`` fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, *(os.path.join(_DIR, s) for s in SOURCES),
             "-o", tmp], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed:\n" + proc.stdout + proc.stderr)
        os.replace(tmp, path)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"g++ could not build the native core: {e}")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; None when it cannot be
    built or loaded."""
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError):
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    signatures = {
        "pg_dijkstra": (I, [I, I, i32p, i32p, f32p, I, P, P, I, f32p, i32p]),
        "pg_components": (I, [I, I, i32p, i32p, i32p]),
        "sl_open": (I, [ctypes.c_char_p, ctypes.c_char_p, I, I]),
        "sl_count": (I, [I]),
        "sl_max_points": (L, [I]),
        "sl_next": (L, [I, f32p, P, L]),
        "sl_next_q": (L, [I, i16p, L]),
        "sl_eos": (I, [I]),
        "sl_close": (None, [I]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def native_available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise ImportError("native graph core unavailable")
    return lib


def native_dijkstra(n_vertices: int, edge_from, edge_to, weights,
                    source: int, vertex_ok=None, edge_ok=None,
                    max_settled: Optional[int] = None):
    """:func:`pgslam_tpu_torch.graph.shortest_path.dijkstra` in C++:
    (dists ``[n]``, settled vertices in order). Raises ``ImportError``
    when the library is unavailable."""
    lib = _lib()
    ef = np.ascontiguousarray(edge_from, np.int32)
    et = np.ascontiguousarray(edge_to, np.int32)
    w = np.ascontiguousarray(weights, np.float32)
    dist = np.empty(n_vertices, np.float32)
    settled = np.empty(max(n_vertices, 1), np.int32)
    # The masks are read as bytes; keep the arrays alive over the call.
    masks = [None if m is None else np.ascontiguousarray(m, bool)
             .view(np.uint8) for m in (vertex_ok, edge_ok)]
    ptrs = [None if m is None else m.ctypes.data_as(ctypes.c_void_p)
            for m in masks]
    n = lib.pg_dijkstra(n_vertices, len(ef), ef, et, w, int(source),
                        ptrs[0], ptrs[1],
                        0 if max_settled is None else int(max_settled),
                        dist, settled)
    return dist, settled[:n].tolist()


def native_components(n_vertices: int, edge_from, edge_to):
    """(number of connected components, label per vertex)."""
    lib = _lib()
    ef = np.ascontiguousarray(edge_from, np.int32)
    et = np.ascontiguousarray(edge_to, np.int32)
    labels = np.empty(n_vertices, np.int32)
    n = lib.pg_components(n_vertices, len(ef), ef, et, labels)
    return n, labels


class ScanLoader:
    """A stream of the KITTI ``.bin`` scans of a directory in filename
    order, read and parsed ahead of the consumer by the native reader
    thread. Yields ``[N, 3]`` float32 arrays (with ``with_reflectance``,
    (points, reflectance) pairs), or with ``quantize_mm`` int16
    millimetre arrays, which ``make_cloud`` and the localizer take as
    they are; the reader drops points outside the int16 range (±32.767
    m). A scan that cannot be read, or that has no point left, is
    skipped; the stream ends only at its last file."""

    def __init__(self, directory: str, ext: str = ".bin",
                 prefetch_depth: int = 2, with_reflectance: bool = False,
                 quantize_mm: bool = False):
        if quantize_mm and with_reflectance:
            raise ValueError("quantize_mm drops reflectance")
        lib = _load()
        if lib is None:
            raise ImportError("native scan loader unavailable")
        self._lib = lib
        self._h = lib.sl_open(directory.encode(), ext.encode(),
                              int(prefetch_depth), 1 if quantize_mm else 0)
        if self._h < 0:
            raise FileNotFoundError(f"no '{ext}' scans under {directory!r}")
        self._cap = int(lib.sl_max_points(self._h))
        self._with_refl = with_reflectance
        self._quant = quantize_mm

    def __len__(self) -> int:
        return int(self._lib.sl_count(self._h))

    def __iter__(self):
        return self

    def __next__(self):
        # -3 ends the stream and -1 is a closed handle; -2 (a failed
        # read) and 0 (no point left) skip the scan.
        while True:
            if self._h < 0:
                raise StopIteration
            if self._quant:
                q = np.empty((self._cap, 3), np.int16)
                n = self._lib.sl_next_q(self._h, q, self._cap)
            else:
                xyz = np.empty((self._cap, 3), np.float32)
                refl = (np.empty(self._cap, np.float32)
                        if self._with_refl else None)
                n = self._lib.sl_next(
                    self._h, xyz, None if refl is None
                    else refl.ctypes.data_as(ctypes.c_void_p), self._cap)
            if n in (-3, -1):
                self.close()
                raise StopIteration
            if n == -4:
                raise RuntimeError("a ScanLoader opened without quantize_mm "
                                   "cannot serve the int16 stream")
            if n <= 0:
                continue
            if self._quant:
                return np.ascontiguousarray(q[:n])
            if self._with_refl:
                return (np.ascontiguousarray(xyz[:n]),
                        np.ascontiguousarray(refl[:n]))
            return np.ascontiguousarray(xyz[:n])

    def close(self) -> None:
        if self._h >= 0:
            self._lib.sl_close(self._h)
            self._h = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
