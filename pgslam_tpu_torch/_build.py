"""Builds the port's CUDA kernels and loads them with ctypes.

The sources under ``csrc/`` are compiled at first use by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface (no PyTorch
headers, so the build takes seconds). The library lands in ``_build/``
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
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("knn.cu", "icp_fused.cu", "lm.cu")
HEADERS = ("rowmath.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

P, I = ctypes.c_void_p, ctypes.c_int
# Every C entry point returns cudaGetLastError() after its launch.
SIGNATURES = {
    # q, qmask, nq, r, rmask, nr, k, out_d, out_i, stream
    "pgs_knn": (P, P, I, P, P, I, I, P, P, P),
    # reading, rmask, nq, coarse_div, ref, normals, refmask, nr, T0,
    # params, iparams, scratch, out, batch, stream
    "pgs_icp_fused": (P, P, I, I, P, P, P, I, P, P, P, P, P, I, P),
    # poses, vmask, V, ef, et, Zinv, cov, emask, rmask, E, fixed,
    # csr_ptr, csr_ent, params(float*), iparams(int*), scratch, out_poses,
    # out_stats, stream
    "pgs_lm": (P, P, I, P, P, P, P, P, P, I, I, P, P, P, P, P, P, P, P),
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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp] + [os.path.join(CSRC, s) for s in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


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


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape=None, device=None) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape,
    contiguity."""
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
