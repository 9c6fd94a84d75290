"""Builds and loads the package's CUDA kernels.

The sources under ``csrc/`` have a plain C interface (headers ``*.cuh``
are shared between them and enter the hash).  At first use one
``nvcc`` per source compiles it for Hopper (``sm_90a``), all started
together, and one more links the objects into a shared library, keyed by a
hash of the sources and flags, in ``_build/`` next to this file; the
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

from .utils import trace

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float

# C entry points: (name, argtypes).  Each launcher returns
# cudaGetLastError().
_ENTRIES = {
    # band_bf16, tail, bands, n_bands, offsets (host int[n_bands]), n_pad,
    # v, b, dinv, x, s0, s1, y0, y1, y2, stream
    "dia_fused_launch": [_i, _i, _p, _i, _p, _i, _p, _p, _p, _p, _f, _f,
                         _p, _p, _p, _p],
    # band_bf16, tail, bands, n_bands, offsets, n_pad, v, left, right, h,
    # lo, hi, b, dinv, x, s0, s1, y0, y1, y2, stream: the boundary rows of
    # a rank block (lo, hi: whether it has a left / right neighbour)
    "dia_fused_boundary_launch": [_i, _i, _p, _i, _p, _i, _p, _p, _p, _i,
                                  _i, _i, _p, _p, _p, _f, _f, _p, _p, _p,
                                  _p],
    # band_bf16, n_bands: the instantiation's band count (0: run-time
    # count); band_bf16, n_bands, offsets: the halo staged around each
    # tile.  No CUDA call
    "dia_instantiation": [_i, _i],
    "dia_halo": [_i, _i, _p],
    # csrc/dia_finish64.cu.  bands (fp64), n_bands, offsets (host
    # int[n_bands]), n_pad, x64, d, b64, b, scratch, rr, stream; n_pad:
    # the scratch's fp64 entries; n_bands, offsets: the staged halo.  The
    # last two make no CUDA call
    "dia_finish64_launch": [_p, _i, _p, _i, _p, _p, _p, _p, _p, _p, _p],
    "dia_finish64_scratch": [_i],
    "dia_finish64_halo": [_i, _p],
    # val_bf16, lanes (T), vec (V), cols, vals, slice_off, slice_width,
    # perm, lens, n_slices, n_rows, n_pad, split lanes, cluster, x, y,
    # stream
    "ell_spmv_launch": [_i, _i, _i, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
                        _i, _p, _p, _p],
    # the same, then v (for x), y, tail, b, dinv, x, s0, stream
    "ell_fused_launch": [_i, _i, _i, _p, _p, _p, _p, _p, _p, _i, _i, _i,
                         _i, _i, _p, _p, _i, _p, _p, _p, _f, _p],
    # val_bf16, bs, cols, vals, lens, kn, n, n_pad, nodes (W), lanes (T),
    # split lanes, cluster, x, y, stream
    "block_ell_spmv_launch": [_i, _i, _p, _p, _p, _i, _i, _i, _i, _i, _i,
                              _i, _p, _p, _p],
    # the split-row launch's limits (csrc/split_rows.cuh); no CUDA call
    "split_max_lanes": [],
    "split_max_cluster": [],
    # csrc/graph_loop.cu.  rr, k, brk (or None), target, budget, prog, go,
    # stream
    "loop_guard_launch": [_p, _p, _p, _p, _p, _p, _p, _p],
    # buf (int64 (2 cap + 1,)), cap, slot, reset, stream
    "trace_stamp_launch": [_p, _i, _i, _i, _p],
    # heads (void*[]), n_heads, body, tails (void*[]), n_tails, rr, k, brk,
    # target, budget, prog, exec_out (void**), msg, msg_len, stream
    "pass_graph_create": [_p, _i, _p, _p, _i, _p, _p, _p, _p, _p, _p, _p,
                          _p, _i, _p],
    # exec, stream; exec
    "pass_graph_launch": [_p, _p],
    "pass_graph_destroy": [_p],
    # graph, counts (int[n]), n
    "graph_node_counts": [_p, _p, _i],
}


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


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
    for s in srcs + headers():
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"kernels-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    # per-process temporary names: concurrent builds must not clobber
    # each other's half-written output
    tmp = f"{so}.tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    nvcc = nvcc_path()
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
              for s, o in zip(srcs, objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so)
    finally:
        for f in (*objs, tmp):
            if os.path.exists(f):
                os.remove(f)
    return so


def _run(cmds: list) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    trace.count("build.compiles", len(cmds))
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}"
                               f"\n{out}\n{err}")


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            with trace.span("build.kernels", kind="cuda"):
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
