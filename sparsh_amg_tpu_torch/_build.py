"""Builds and loads the package's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  ``nvcc`` compiles all
of them into one shared library for Hopper (``sm_90a``) at first use, keyed
by a hash of the sources and flags, in ``_build/`` next to this file; the
library is loaded with ``ctypes``.  Nothing here runs at import time: the
CPU tests import every module of the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float

# C entry points: (name, argtypes).  Each returns cudaGetLastError().
_ENTRIES = {
    # band_bf16, tail, bands, n_bands, offsets (host int[n_bands]), n_pad,
    # v, b, dinv, x, s0, s1, y0, y1, y2, stream
    "dia_fused_launch": [_i, _i, _p, _i, _p, _i, _p, _p, _p, _p, _f, _f,
                         _p, _p, _p, _p],
    # val_bf16, cols, vals, k, n_pad, x, y, stream
    "ell_spmv_launch": [_i, _p, _p, _i, _i, _p, _p, _p],
}


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build() -> str:
    """Compile csrc/*.cu into the shared library (cached by content hash);
    return its path.  Raises RuntimeError with nvcc's output on failure."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"kernels-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    # per-process temporary name: concurrent builds must not clobber
    # each other's half-written output
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _ENTRIES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error (launch refused, bad
    argument): such a launch never ran, and synchronising would not say so."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
