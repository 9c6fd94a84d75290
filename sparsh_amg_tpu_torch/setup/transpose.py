"""Parallel CSR transpose (SURVEY.md §2 C7: R = P^T in the reference's
setup phase).

scipy's ``.T.tocsr()`` is a serial two-pass scatter; on this deploy VM its
fresh-page allocations fault at 0.1-1 GB/s and the 42M-edge strength graph
took 4-14 s to transpose.  The native kernel (amg_core.cpp
csr_transpose_*) is block-parallel, deterministic, and writes directly
into preallocated numpy arrays so the fault cost is paid in parallel.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .._native import get_lib, csr_arrays, empty_prefaulted


def transpose_arrays(n: int, m: int, indptr: np.ndarray,
                     indices: np.ndarray, data: np.ndarray | None = None):
    """Transpose a CSR given as raw (int64 indptr, int32 indices[, f64
    data]) arrays; returns the transposed triple (data None when pattern-
    only).  Requires the native library."""
    lib = get_lib()
    nnz = int(indptr[-1])
    T_indptr = np.empty(m + 1, dtype=np.int64)
    T_indices = empty_prefaulted(nnz, np.int32)
    if data is None:
        lib.csr_transpose_pattern(n, m, indptr, indices, T_indptr,
                                  T_indices)
        return T_indptr, T_indices, None
    T_data = empty_prefaulted(nnz, np.float64)
    lib.csr_transpose_f64(n, m, indptr, indices, data, T_indptr, T_indices,
                          T_data)
    return T_indptr, T_indices, T_data


def csr_transpose(A: sp.csr_matrix) -> sp.csr_matrix:
    """T = A.T as CSR with sorted rows (native parallel; scipy fallback)."""
    n, m = A.shape
    lib = get_lib()
    if lib is None or A.nnz < (1 << 16):
        return A.T.tocsr()
    indptr, indices, data = csr_arrays(A)
    T_indptr, T_indices, T_data = transpose_arrays(n, m, indptr, indices,
                                                   data)
    T = sp.csr_matrix((T_data, T_indices, T_indptr), shape=(m, n))
    T.has_sorted_indices = True
    T.has_canonical_format = True
    return T
