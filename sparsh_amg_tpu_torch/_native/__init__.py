"""Loader for the native (C++) setup-phase kernels.

Compiles ``amg_core.cpp`` on first use with g++ (cached by source hash under
``build/``) and exposes ctypes wrappers.  Every entry point has a pure
numpy fallback in :mod:`sparsh_amg_tpu.setup`, so the package works even
without a toolchain — the native path is ~100x faster at large n.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "amg_core.cpp")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_i64 = ctypes.c_int64
_u64 = ctypes.c_uint64
_f64 = ctypes.c_double
_i32 = ctypes.c_int32


def _ptr(dtype):
    return np.ctypeslib.ndpointer(dtype=dtype, flags="C_CONTIGUOUS")


def _compile() -> str | None:
    os.makedirs(os.path.join(_HERE, "build"), exist_ok=True)
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_HERE, "build", f"amg_core-{h}.so")
    if os.path.exists(so):
        return so
    # per-process tmp name: concurrent processes compiling the same hash
    # must not clobber each other's output (observed: silent fallback to
    # the numpy paths when two processes raced)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [
        "g++", "-O3", "-std=c++17", "-fopenmp", "-shared", "-fPIC",
        "-march=native", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, so)
        return so
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError):
        return None


def get_lib():
    """Return the ctypes-wrapped native library, or None if unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        so = _compile()
        if so is None:
            _TRIED = True
            return None
        lib = ctypes.CDLL(so)

        lib.soc_classical.restype = None
        lib.soc_classical.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64), _f64,
            _ptr(np.uint8),
        ]
        lib.soc_symmetric.restype = None
        lib.soc_symmetric.argtypes = lib.soc_classical.argtypes
        lib.soc_classical_rows.restype = None
        lib.soc_classical_rows.argtypes = [
            _i64, _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _f64, _ptr(np.uint8),
        ]
        lib.mask_indptr.restype = None
        lib.mask_indptr.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.uint8), _ptr(np.int64),
        ]
        lib.mask_compress.restype = None
        lib.mask_compress.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.uint8),
            _ptr(np.int64), _ptr(np.int32),
        ]
        lib.dia_offsets.restype = _i64
        lib.dia_offsets.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _i64, _ptr(np.int64),
        ]
        lib.dia_fill_df64.restype = None
        lib.dia_fill_df64.argtypes = [
            _i64, _i64, _i64, _ptr(np.int64), _ptr(np.int32),
            _ptr(np.float64), _ptr(np.int64), _ptr(np.float32),
            _ptr(np.float32),
        ]
        lib.dia_fill_f32.restype = None
        lib.dia_fill_f32.argtypes = [
            _i64, _i64, _i64, _ptr(np.int64), _ptr(np.int32),
            _ptr(np.float64), _ptr(np.int64), _ptr(np.float32),
        ]
        lib.poisson3d_fill.restype = None
        # pass 1: indices=None fills indptr; pass 2 fills indices/data
        lib.poisson3d_fill.argtypes = [
            _i64, _i64, _i64, _ptr(np.int64),
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.poisson3d_fill_rows.restype = None
        lib.poisson3d_fill_rows.argtypes = [
            _i64, _i64, _i64, _i64, _i64, _ptr(np.int64),
            ctypes.c_void_p, ctypes.c_void_p,
        ]

        lib.rs_cf.restype = _i64
        lib.rs_cf.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.int64),
            _ptr(np.int32), _ptr(np.int8), ctypes.c_int,
        ]
        lib.pmis_cf.restype = _i64
        lib.pmis_cf.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.int64),
            _ptr(np.int32), _u64, _ptr(np.int8),
        ]
        lib.set_omp_threads.restype = None
        lib.set_omp_threads.argtypes = [_i64]
        lib.omp_fork_prepare.restype = None
        lib.omp_fork_prepare.argtypes = []
        lib.stable_counting_order.restype = None
        lib.stable_counting_order.argtypes = [
            _i64, _ptr(np.int64), _i64, _ptr(np.int64),
        ]
        lib.coo_to_csr_pattern.restype = None
        lib.coo_to_csr_pattern.argtypes = [
            _i64, _i64, _ptr(np.int64), _ptr(np.int64), _ptr(np.int64),
            _ptr(np.int32),
        ]
        lib.pmis_round_select.restype = None
        lib.pmis_round_select.argtypes = [
            _i64, _ptr(np.int32), _ptr(np.int64), _ptr(np.int32),
            _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.int8), _ptr(np.uint8),
        ]
        lib.pmis_round_fassign.restype = None
        lib.pmis_round_fassign.argtypes = [
            _i64, _ptr(np.int32), _ptr(np.int64), _ptr(np.int32),
            _ptr(np.int8),
        ]
        lib.aggregate_greedy.restype = _i64
        lib.aggregate_greedy.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.int32),
        ]
        lib.direct_interp.restype = _i64
        lib.direct_interp.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.uint8), _ptr(np.int8), _ptr(np.int32), _ptr(np.int64),
            _ptr(np.int32), _ptr(np.float64),
        ]
        lib.extpi_symbolic.restype = _i64
        lib.extpi_symbolic.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.uint8),
            _ptr(np.int8), _ptr(np.int64),
        ]
        lib.extpi_numeric.restype = None
        lib.extpi_numeric.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.uint8), _ptr(np.int8), _ptr(np.int32), _ptr(np.int64),
            _ptr(np.int32), _ptr(np.float64),
        ]
        lib.truncate_interp.restype = None
        lib.truncate_interp.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64), _i64,
            _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
        ]
        lib.rap_filter_symbolic.restype = _i64
        lib.rap_filter_symbolic.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64), _f64,
            _ptr(np.float64), _ptr(np.int64),
        ]
        lib.rap_filter_numeric.restype = None
        lib.rap_filter_numeric.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64), _f64,
            _ptr(np.float64), _ptr(np.int64), _ptr(np.int32),
            _ptr(np.float64),
        ]
        lib.fill_f32.restype = None
        lib.fill_f32.argtypes = [_i64, ctypes.c_float, _ptr(np.float32)]
        lib.ell_fill_f32.restype = None
        lib.ell_fill_f32.argtypes = [
            _i64, _i64, _i64, _ptr(np.int64), _ptr(np.int32),
            _ptr(np.float64), _ptr(np.int32), _ptr(np.float32),
        ]
        lib.rap_fused_compute.restype = _i64
        lib.rap_fused_compute.argtypes = [
            _i64, _i64,
            _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
        ]
        lib.rap_fused_extract.restype = _i64
        lib.rap_fused_extract.argtypes = [_f64, _ptr(np.int64)]
        lib.rap_fused_emit.restype = None
        lib.rap_fused_emit.argtypes = [
            _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
        ]
        lib.prefault.restype = None
        lib.prefault.argtypes = [ctypes.c_void_p, _i64]
        lib.abs_row_sum.restype = None
        lib.abs_row_sum.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.float64), _ptr(np.float64),
        ]
        lib.csr_transpose_f64.restype = None
        lib.csr_transpose_f64.argtypes = [
            _i64, _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
        ]
        lib.csr_transpose_pattern.restype = None
        lib.csr_transpose_pattern.argtypes = [
            _i64, _i64, _ptr(np.int64), _ptr(np.int32),
            _ptr(np.int64), _ptr(np.int32),
        ]
        lib.rcm_order.restype = _i64
        lib.rcm_order.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.int32),
        ]
        lib.spgemm_symbolic.restype = _i64
        lib.spgemm_symbolic.argtypes = [
            _i64, _i64, _ptr(np.int64), _ptr(np.int32),
            _ptr(np.int64), _ptr(np.int32), _ptr(np.int64),
        ]
        lib.gell_windows.restype = _i64
        lib.gell_windows.argtypes = [
            _i64, _i64, _i64, _i64, _ptr(np.int64), _ptr(np.int32), _i64,
        ]
        lib.gell_fill.restype = None
        lib.gell_fill.argtypes = [
            _i64, _i64, _i64, _i64, _i64, _ptr(np.int64), _ptr(np.int32),
            _ptr(np.float64), _ptr(np.int32), _ptr(np.int32),
            _ptr(np.int32), _ptr(np.float32),
        ]
        lib.gell_fill_bf16.restype = None
        lib.gell_fill_bf16.argtypes = [
            _i64, _i64, _i64, _i64, _i64, _ptr(np.int64), _ptr(np.int32),
            _ptr(np.float64), _ptr(np.int32), _ptr(np.int32),
            _ptr(np.int32), _ptr(np.uint16),
        ]
        lib.spgemm_numeric.restype = None
        lib.spgemm_numeric.argtypes = [
            _i64, _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
        ]
        lib.segment_rows_count.restype = None
        lib.segment_rows_count.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _i64, _ptr(np.int64),
        ]
        lib.segment_rows_fill.restype = None
        lib.segment_rows_fill.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _i64, _ptr(np.int64),
            _ptr(np.int64), _ptr(np.int32),
        ]
        lib.ext_col_map_ecol.restype = None
        lib.ext_col_map_ecol.argtypes = [
            _i64, _ptr(np.int64), _i64, _i64, _ptr(np.int64), _i64,
            _ptr(np.int32),
        ]
        lib.ext_col_map_local.restype = None
        lib.ext_col_map_local.argtypes = [
            _i64, _ptr(np.int64), _i64, _i64, _ptr(np.int64), _i64,
            _i64, _ptr(np.int64),
        ]
        lib.gather_subrows.restype = None
        lib.gather_subrows.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int64), _ptr(np.int64),
            _ptr(np.int32), _ptr(np.float64), _ptr(np.int32),
            _ptr(np.float64),
        ]
        lib.gather_subrows_pattern.restype = None
        lib.gather_subrows_pattern.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int64), _ptr(np.int64),
            _ptr(np.int32), _ptr(np.int32),
        ]
        lib.mask_compress_data.restype = None
        lib.mask_compress_data.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.uint8), _ptr(np.int64), _ptr(np.int32),
            _ptr(np.float64),
        ]
        lib.csr_row_scale.restype = None
        lib.csr_row_scale.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.float64), _ptr(np.float64),
        ]
        lib.weak_row_sum.restype = None
        lib.weak_row_sum.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.uint8), _ptr(np.float64),
        ]
        lib.csr_add_symbolic.restype = None
        lib.csr_add_symbolic.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32),
            _ptr(np.int64), _ptr(np.int32), _ptr(np.int64),
        ]
        lib.csr_add_fill.restype = None
        lib.csr_add_fill.argtypes = [
            _i64, ctypes.c_double, _ptr(np.int64), _ptr(np.int32),
            _ptr(np.float64), ctypes.c_double, _ptr(np.int64),
            _ptr(np.int32), _ptr(np.float64), _ptr(np.int64),
            _ptr(np.int32), _ptr(np.float64),
        ]
        lib.dist2_cc_symbolic.restype = _i64
        lib.dist2_cc_symbolic.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.int8),
            _ptr(np.int32), _i64, _ptr(np.int64),
        ]
        lib.dist2_cc_fill.restype = None
        lib.dist2_cc_fill.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.int8),
            _ptr(np.int32), _ptr(np.int64), _ptr(np.int32),
        ]
        lib.multipass_interp.restype = _i64
        lib.multipass_interp.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.uint8), _ptr(np.int8), _ptr(np.int32), _i64, _i64,
            _ptr(np.int32), _ptr(np.float64), _ptr(np.int32),
        ]
        lib.multipass_ready.restype = None
        lib.multipass_ready.argtypes = [
            _i64, _ptr(np.int32), _ptr(np.int64), _ptr(np.int32),
            _ptr(np.uint8), _i32, _ptr(np.int32), _ptr(np.uint8),
        ]
        lib.multipass_step.restype = None
        lib.multipass_step.argtypes = [
            _i32, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.uint8), _ptr(np.int8), _ptr(np.int32), _i64,
            _ptr(np.int32), _ptr(np.int32), _i64,
            _ptr(np.int32), _ptr(np.float64), _ptr(np.int32),
        ]
        lib.slot_compact.restype = None
        lib.slot_compact.argtypes = [
            _i64, _i64, _ptr(np.int32), _ptr(np.float64), _ptr(np.int32),
            _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
        ]
        lib.interp_jacobi_smooth.restype = _i64
        lib.interp_jacobi_smooth.argtypes = [
            _i64, _ptr(np.int64), _ptr(np.int32), _ptr(np.float64),
            _ptr(np.uint8), ctypes.c_double, _i64, _i64,
            _ptr(np.int32), _ptr(np.float64), _ptr(np.int32),
            _ptr(np.int32), _ptr(np.float64), _ptr(np.int32),
        ]
        _LIB = lib
        _TRIED = True
        return _LIB


_MALLOC_TUNED = False


def tune_malloc() -> bool:
    """Keep freed pages on the process heap (glibc mallopt).

    The deploy VM (firecracker-class microVM) services FRESH anonymous
    pages at ~0.1-1 GB/s while already-faulted pages run at 4-9 GB/s
    (measured, RESULTS.md round 2).  glibc serves every >128 KB
    allocation via mmap and munmaps it on free, so each large numpy
    temporary re-pays the fault storm.  M_MMAP_MAX=0 + M_TRIM_THRESHOLD
    =-1 route large allocations through the brk heap and never return
    pages — each page faults at most once per process.  Gated by
    SPARSH_NO_MALLOC_TUNE; no-op off glibc.
    """
    global _MALLOC_TUNED
    if _MALLOC_TUNED or os.environ.get("SPARSH_NO_MALLOC_TUNE"):
        return _MALLOC_TUNED
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4
        ok = bool(libc.mallopt(M_MMAP_MAX, 0))
        ok = bool(libc.mallopt(M_TRIM_THRESHOLD, -1)) and ok
        _MALLOC_TUNED = ok
    except OSError:
        _MALLOC_TUNED = False
    return _MALLOC_TUNED


def empty_prefaulted(shape, dtype):
    """np.empty + parallel first-touch: a kernel faulting its own fresh
    output sustains ~0.2 GB/s on this VM; a dedicated touch pass ~3.2."""
    out = np.empty(shape, dtype=dtype)
    lib = get_lib()
    if lib is not None and out.nbytes >= (1 << 24):
        lib.prefault(out.ctypes.data, out.nbytes)
    return out


def csr_arrays(A):
    """Return (indptr_int64, indices_int32, data_float64) views/copies of a
    scipy CSR matrix in the layout the native kernels expect."""
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    return indptr, indices, data
