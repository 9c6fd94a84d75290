"""Strength of connection (reference: SURVEY.md §2 C9).

Classical SoC: j in S_i  iff  -a_ij >= theta * max_{k != i}(-a_ik).
Symmetric SoC (for aggregation): |a_ij| >= theta * sqrt(|a_ii a_jj|).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .._native import get_lib, csr_arrays, empty_prefaulted


def _rows_of_nnz(A: sp.csr_matrix) -> np.ndarray:
    return np.repeat(
        np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr))


def _strength_csr(lib, A: sp.csr_matrix, indptr, indices,
                  strong: np.ndarray) -> sp.csr_matrix:
    """Build the pattern-only strength CSR from the per-nonzero mask with
    native single-pass kernels (no nnz-length cumsum / fancy-index — both
    pathologically slow on the deploy VM).  S.data is a contiguous ones
    fill (one streaming write): the in-package consumers (splitting,
    aggregation) read only the pattern, but tests and users index S."""
    n = A.shape[0]
    S_indptr = np.empty(n + 1, dtype=np.int64)
    lib.mask_indptr(n, indptr, strong, S_indptr)
    nnz = int(S_indptr[-1])
    S_indices = empty_prefaulted(nnz, np.int32)
    lib.mask_compress(n, indptr, indices, strong, S_indptr, S_indices)
    # S.data is never read in-package (splitting/aggregation/dist2 use
    # only the pattern) but scipy wants an array: a length-nnz broadcast
    # VIEW of one float costs 4 bytes instead of a 2.4 GB ones fill at
    # the 100M north star.  Consumers that need real data (tests, users)
    # go through .toarray()/@ which read it fine; anything mutating S
    # would raise on the read-only view, which is the correct signal.
    ones = np.broadcast_to(np.float32(1.0), (nnz,))
    S = sp.csr_matrix(A.shape)
    S.data, S.indices, S.indptr = ones, S_indices, S_indptr
    return S


def classical_strength(A: sp.csr_matrix, theta: float = 0.25,
                       row_offset: int = 0):
    """Return (strong_mask over A.data, S) where S is the 0/1 strength CSR.

    ``row_offset``: global index of row 0 — set for a row-block CSR with
    GLOBAL column ids (blocked per-host setup), so the diagonal of local
    row i is detected at column row_offset + i."""
    n = A.shape[0]
    lib = get_lib()
    if lib is not None:
        indptr, indices, data = csr_arrays(A)
        strong = empty_prefaulted(len(indices), np.uint8)
        lib.soc_classical_rows(n, int(row_offset), indptr, indices, data,
                               float(theta), strong)
        return strong.view(bool), _strength_csr(lib, A, indptr, indices,
                                                strong)
    else:
        rows = _rows_of_nnz(A) + row_offset
        offdiag = A.indices != rows
        neg = np.where(offdiag, -A.data, -np.inf)
        maxoff = np.full(n, -np.inf)
        np.maximum.at(maxoff, rows - row_offset, neg)
        cut = theta * maxoff
        rows = rows - row_offset
        mask = offdiag & (-A.data > 0) & (maxoff[rows] > 0) & (-A.data >= cut[rows])
    S = sp.csr_matrix(
        (np.ones(int(mask.sum()), dtype=np.float32),
         A.indices[mask].astype(np.int32), _mask_indptr(A, mask)),
        shape=A.shape)
    return mask, S


def _mask_indptr(A: sp.csr_matrix, mask: np.ndarray) -> np.ndarray:
    """indptr of the masked CSR: kept-entry prefix sum sampled at the old
    row starts (no per-nnz rows array; ~100x cheaper than np.add.at)."""
    csum = np.zeros(len(mask) + 1, dtype=np.int64)
    np.cumsum(mask, out=csum[1:])
    return csum[A.indptr]


def symmetric_strength(A: sp.csr_matrix, theta: float = 0.25):
    """Vanek-style symmetric strength for aggregation."""
    n = A.shape[0]
    lib = get_lib()
    if lib is not None:
        indptr, indices, data = csr_arrays(A)
        strong = empty_prefaulted(len(indices), np.uint8)
        lib.soc_symmetric(n, indptr, indices, data, float(theta), strong)
        return strong.view(bool), _strength_csr(lib, A, indptr, indices,
                                                strong)
    else:
        rows = _rows_of_nnz(A)
        diag = np.zeros(n)
        dmask = A.indices == rows
        diag[rows[dmask]] = np.abs(A.data[dmask])
        cut = theta * np.sqrt(diag[rows] * diag[A.indices])
        mask = (~dmask) & (np.abs(A.data) >= cut) & (cut > 0)
    S = sp.csr_matrix(
        (np.ones(int(mask.sum()), dtype=np.float32),
         A.indices[mask].astype(np.int32),
         _mask_indptr(A, mask)), shape=A.shape)
    return mask, S
