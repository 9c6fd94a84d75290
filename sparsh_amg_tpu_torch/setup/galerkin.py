"""Galerkin coarse operator A_coarse = R A P = P^T A P (SURVEY.md §2 C13).

The reference does the triple SpGEMM natively; here a row-parallel OpenMP
C++ SpGEMM (amg_core.cpp) does the host-side product — the setup-phase hot
spot (SURVEY.md §3.2) where scipy's single-threaded product dominates setup
time at n >= 10^7 — with scipy as the always-available fallback.
"""
from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

from .._native import get_lib, csr_arrays, empty_prefaulted


def spgemm(A: sp.csr_matrix, B: sp.csr_matrix) -> sp.csr_matrix:
    """C = A @ B via the row-parallel OpenMP kernel.

    Native wins at every shape once the product is big enough to matter
    (re-measured round 2 after the monotonic-schedule fix: fine-level A@P
    at 2M rows native 0.2-0.7 s vs scipy 1.2-2.2 s; fat R@(AP) 3.5 s vs
    10.6 s); scipy only serves tiny products and the no-toolchain
    fallback.
    """
    n, k = A.shape
    k2, m = B.shape
    assert k == k2
    lib = get_lib()
    if lib is None or A.nnz + B.nnz < (1 << 16):
        return (A @ B).tocsr()
    A_indptr, A_indices, A_data = csr_arrays(A)
    B_indptr, B_indices, B_data = csr_arrays(B)
    C_indptr = np.empty(n + 1, dtype=np.int64)
    nnz = lib.spgemm_symbolic(n, m, A_indptr, A_indices, B_indptr,
                              B_indices, C_indptr)
    C_indices = empty_prefaulted(nnz, np.int32)
    C_data = empty_prefaulted(nnz, np.float64)
    lib.spgemm_numeric(n, m, A_indptr, A_indices, A_data,
                       B_indptr, B_indices, B_data,
                       C_indptr, C_indices, C_data)
    C = sp.csr_matrix((C_data, C_indices, C_indptr), shape=(n, m))
    # rows are sorted inside spgemm_numeric (parallel, vs scipy's serial
    # sort_indices pass) and contain no duplicates by construction
    C.has_sorted_indices = True
    C.has_canonical_format = True
    return C


def galerkin_product(A: sp.csr_matrix, P: sp.csr_matrix,
                     R: sp.csr_matrix | None = None,
                     drop_tol: float = 0.0) -> sp.csr_matrix:
    """Compute R A P (R defaults to P^T), pruning explicit zeros.

    drop_tol > 0 filters the result: entries with |a_ij| <
    drop_tol*sqrt(|a_ii a_jj|) are dropped and lumped into the diagonal
    (ML-style operator filtering) — this is what bounds nnz/row on the
    irregular coarse levels, where Galerkin fill otherwise reaches
    hundreds of entries per row.
    """
    if R is None:
        from .transpose import csr_transpose
        R = csr_transpose(P)
    lib = get_lib()
    # The fused path re-expands each fine row's A-row x P product once per
    # coarse row containing it, so its flop count is ~dup x the two-pass
    # SpGEMM's, where dup = R.nnz / n_fine = avg coarse rows per fine row.
    # Classical interpolation (extpi/multipass, <=4-5 entries/row) keeps
    # dup small and the fused path wins on memory (no A*P intermediate:
    # 0.9 GB of fresh-page faults at 192^3).  Smoothed aggregation on
    # systems explodes dup (3-D elasticity blocksize-3: P nnz/row ~31 ->
    # measured 39.5 s fused vs 0.98 s two-pass at m=24), so fall through
    # to the two-pass product when the duplication factor is large.
    dup = R.nnz / max(A.shape[0], 1)
    if (lib is not None and A.nnz + P.nnz >= (1 << 16) and dup <= 8.0
            and not os.environ.get("SPARSH_NO_FUSED_RAP")):
        # fused one-pass triple product: no A*P intermediate (0.9 GB of
        # fresh-page faults at 192^3), filter applied during emission
        R_ip, R_ix, R_d = csr_arrays(R)
        A_ip, A_ix, A_d = csr_arrays(A)
        P_ip, P_ix, P_d = csr_arrays(P)
        nc = R.shape[0]
        lib.rap_fused_compute(nc, P.shape[1], R_ip, R_ix, R_d,
                              A_ip, A_ix, A_d, P_ip, P_ix, P_d)
        C_indptr = np.empty(nc + 1, dtype=np.int64)
        nnz = lib.rap_fused_extract(float(drop_tol), C_indptr)
        C_indices = empty_prefaulted(nnz, np.int32)
        C_data = empty_prefaulted(nnz, np.float64)
        lib.rap_fused_emit(C_indptr, C_indices, C_data)
        Ac = sp.csr_matrix((C_data, C_indices, C_indptr),
                           shape=(nc, P.shape[1]))
        Ac.has_sorted_indices = True
        Ac.has_canonical_format = True
        Ac.eliminate_zeros()
        return Ac
    Ac = spgemm(R, spgemm(A, P))
    Ac.sum_duplicates()
    Ac.eliminate_zeros()
    if drop_tol > 0.0 and Ac.nnz:
        n = Ac.shape[0]
        lib = get_lib()
        if lib is not None:
            indptr, indices, data = csr_arrays(Ac)
            diag_abs = np.empty(n, dtype=np.float64)
            C_indptr = np.empty(n + 1, dtype=np.int64)
            nnz = lib.rap_filter_symbolic(n, indptr, indices, data,
                                          float(drop_tol), diag_abs,
                                          C_indptr)
            C_indices = np.empty(nnz, dtype=np.int32)
            C_data = np.empty(nnz, dtype=np.float64)
            lib.rap_filter_numeric(n, indptr, indices, data,
                                   float(drop_tol), diag_abs, C_indptr,
                                   C_indices, C_data)
            Ac = sp.csr_matrix((C_data, C_indices, C_indptr), shape=Ac.shape)
            Ac.eliminate_zeros()
            return Ac
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(Ac.indptr))
        dmask = Ac.indices == rows
        diag_s = np.zeros(n)
        diag_s[rows[dmask]] = Ac.data[dmask]
        diag = np.abs(diag_s)
        cut = drop_tol * np.sqrt(diag[rows] * diag[Ac.indices])
        keep = dmask | (np.abs(Ac.data) >= cut)
        lump = np.zeros(n)
        np.add.at(lump, rows[~keep], Ac.data[~keep])
        # diagonal-collapse guard (matches the native rap_keep_whole_row):
        # rows whose lumped diagonal would fall below 10% of the original
        # (or flip sign) keep all entries — high-contrast jump operators
        # otherwise produce exactly-zero diagonals -> singular coarse A
        nd = diag_s + lump
        bad = np.where(diag_s > 0, nd < 0.1 * diag_s,
                       np.where(diag_s < 0, nd > 0.1 * diag_s, True))
        keep = keep | bad[rows]
        lump = np.where(bad, 0.0, lump)
        data = np.where(keep, Ac.data, 0.0)
        data = np.where(dmask, data + lump[rows], data)
        Ac = sp.csr_matrix((data, Ac.indices.copy(), Ac.indptr.copy()),
                           shape=Ac.shape)
        Ac.eliminate_zeros()
    return Ac


def csr_add(alpha: float, A: sp.csr_matrix, beta: float,
            B: sp.csr_matrix) -> sp.csr_matrix:
    """C = alpha*A + beta*B, row-parallel (scipy's csr_binop is
    single-threaded: 2.4 s on the fine-level P-smoothing merge at 96^3).
    Requires sorted indices in both operands; output is canonical."""
    assert A.shape == B.shape
    n = A.shape[0]
    lib = get_lib()
    if lib is None or A.nnz + B.nnz < (1 << 16):
        C = (alpha * A + beta * B).tocsr()
        C.sum_duplicates()
        return C
    if not A.has_sorted_indices:
        A.sort_indices()
    if not B.has_sorted_indices:
        B.sort_indices()
    Ap, Ai, Ax = csr_arrays(A)
    Bp, Bi, Bx = csr_arrays(B)
    counts = np.empty(n, dtype=np.int64)
    lib.csr_add_symbolic(n, Ap, Ai, Bp, Bi, counts)
    Cp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=Cp[1:])
    nnz = int(Cp[-1])
    Ci = empty_prefaulted(nnz, np.int32)
    Cx = empty_prefaulted(nnz, np.float64)
    lib.csr_add_fill(n, float(alpha), Ap, Ai, Ax, float(beta), Bp, Bi, Bx,
                     Cp, Ci, Cx)
    C = sp.csr_matrix((Cx, Ci, Cp), shape=A.shape)
    C.has_sorted_indices = True
    C.has_canonical_format = True
    return C
