"""Builds the port's CUDA kernels and loads them with ctypes.

The sources under ``csrc/`` are compiled at first use by ``nvcc`` for
``sm_90a``, one process per source, all at once, and linked into one
shared library with a plain C interface (no PyTorch headers, so the
build takes seconds). The library lands in ``_build/``
beside this file, named by a hash of the sources, so an edited source is
rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

from .utils import timing

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("knn.cu", "icp_fused.cu", "lm.cu", "pcg.cu")
HEADERS = ("rowmath.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every C entry point returns cudaGetLastError() after its launch.
SIGNATURES = {
    # q, qmask, nq, r, rmask, nr, k, the layout (slices, threads a CTA),
    # out_d, out_i, stream
    "pgs_knn": (P, P, I, P, P, I, I, I, I, P, P, P),
    # reading, rmask, nq, coarse_div, ref, normals, refmask, nr, T0,
    # params (host float*), iparams (host int*), window, out, batch, and
    # the layout: C, S, map_cap, local chunks, smem bytes; stream
    "pgs_icp_fused": (P, P, I, I, P, P, P, I, P, P, P, P, P, I, I, I, I, I,
                      I, P),
    # out (host int[6]): CTA shared-memory budget, then the clusters of 1,
    # 2, 4, 8 and 16 CTAs with that budget held at once
    "pgs_icp_fused_limits": (P,),
    # poses, vmask, V, ef, et, edge_T, cov, rmask, fixed, meta, C, NV, NS,
    # smem bytes, params (host float*), iparams (host int*), scratch,
    # out_poses, out_stats, stream
    "pgs_lm": (P, P, I, P, P, P, P, P, I, P, I, I, I, I, P, P, P, P, P, P),
    # out (host int[3]): CTA shared-memory budget, largest cluster with it,
    # largest cluster without
    "pgs_lm_limits": (P,),
    # Hff, Htt, Hft, Pinv, damp, b, prior, csr ptr, csr entries, meta, V,
    # and the layout: CTAs, cluster, NV, NS, smem bytes, in_smem, barrier,
    # publish; fixed, cg_iterations, cg_tol, scratch and its offsets (bar,
    # pub, work), out, the step total (int64 [1], added to), stream
    "pgs_pcg": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
                I, F, P, I, I, I, P, P, P),
    # out (host int[3]): CTA shared-memory budget, SMs, largest cluster
    "pgs_pcg_limits": (P,),
    # CTAs, cluster, smem bytes, barrier, out (host int[1]): CTAs resident
    "pgs_pcg_resident": (I, I, I, I, P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode())
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libpgslam_kernels_{_source_hash()}.so")


def build(verbose: bool = False) -> tuple:
    """Compile the kernels unless the library for these sources exists.
    Returns (path, seconds spent, compiler output)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        nvcc = _nvcc()
        extra = ["-Xptxas", "-v"] if verbose else []
        objs = [os.path.join(work, s + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-I", CSRC, "-c", "-o", o,
             os.path.join(CSRC, src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for src, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [src for src, p in zip(SOURCES, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(logs))
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path, time.perf_counter() - t0, "".join(logs)


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _, _ = build()
    handle = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return handle


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, kernel: str = "", **tallies) -> None:
    """Count one launch of ``wrapper``'s kernel: one more in
    ``wrapper.launches`` and in ``getattr(wrapper, name)[key]`` for each
    ``name=key``, and in the tracer's ``launch.<kernel>`` (``k1`` ...
    ``k4``) while a profiler records. Under one lock: the threaded
    pipeline's workers launch from their own threads, and ``+=`` is not
    atomic."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        for name, key in tallies.items():
            getattr(wrapper, name)[key] += 1
    if kernel:
        timing.count("launch." + kernel)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def to_device(arrays, device):
    """Host arrays as tensors on ``device`` in one copy: packed at 16-byte
    offsets into one buffer and viewed back as the arrays' dtypes and
    shapes (the tensors share the buffer's storage, and none shares
    memory with an array). To the card the buffer is pinned and the copy
    does not synchronize the stream (a copy from pageable memory waits
    for the device)."""
    import numpy as np
    import torch
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, n = [], 0
    for a in arrays:
        n = -(-n // 16) * 16
        offsets.append(n)
        n += a.nbytes
    cuda = torch.device(device).type == "cuda"
    host = torch.empty(max(n, 1), dtype=torch.uint8, pin_memory=cuda)
    flat = host.numpy()
    for a, o in zip(arrays, offsets):
        flat[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(device, non_blocking=True) if cuda else host
    return [buf[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, o in zip(arrays, offsets)]


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


class KernelDtypeError(TypeError, ValueError):
    """A tensor of another dtype than its kernel computes in. The kernels
    are fp32 and no wrapper casts, so fp64 never reaches one quietly;
    fp64 runs on the CPU through the plain versions."""


def require(t, name: str, dtype, shape=None, device=None,
            kernel: str = "") -> None:
    """Validate a tensor handed to a kernel (``kernel`` names it in the
    error): device, dtype (:class:`KernelDtypeError`), shape,
    contiguity."""
    name = f"{kernel}: {name}" if kernel else name
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise KernelDtypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
