"""C/F splitting: classical Ruge-Stuben and PMIS (SURVEY.md §2 C10).

Native C++ implementations in ``_native/amg_core.cpp``; the Python
fallbacks here are reference implementations used when no toolchain is
available (and as test oracles at small n).
"""
from __future__ import annotations

import heapq

import numpy as np
import scipy.sparse as sp

from .._native import get_lib

FPT, CPT = 0, 1


def _graph_arrays(S: sp.csr_matrix):
    Sp = np.ascontiguousarray(S.indptr, dtype=np.int64)
    Si = np.ascontiguousarray(S.indices, dtype=np.int32)
    if get_lib() is not None and S.nnz >= (1 << 16):
        # pattern-only parallel transpose — scipy's serial .T.tocsr() on
        # the 42M-edge fine strength graph was seconds per level
        from .transpose import transpose_arrays
        STp, STi, _ = transpose_arrays(S.shape[0], S.shape[1], Sp, Si)
        return Sp, Si, STp, STi
    ST = S.T.tocsr()
    return (Sp, Si,
            np.ascontiguousarray(ST.indptr, dtype=np.int64),
            np.ascontiguousarray(ST.indices, dtype=np.int32))


def rs_splitting(S: sp.csr_matrix, second_pass: bool = True) -> np.ndarray:
    """Classical two-pass Ruge-Stuben C/F splitting.

    S is the strength CSR (row i lists points i strongly depends on).
    Returns cf int8 array: 0 = F, 1 = C.
    """
    n = S.shape[0]
    Sp, Si, STp, STi = _graph_arrays(S)
    cf = np.empty(n, dtype=np.int8)
    lib = get_lib()
    if lib is not None:
        lib.rs_cf(n, Sp, Si, STp, STi, cf, int(second_pass))
        return cf
    return _rs_python(n, Sp, Si, STp, STi, cf, second_pass)


def _rs_python(n, Sp, Si, STp, STi, cf, second_pass):
    UNASSIGNED = -1
    cf[:] = UNASSIGNED
    lam = (STp[1:] - STp[:-1]).astype(np.int64)
    # lazy max-heap of (-lambda, i); stale entries skipped via lam check
    heap = [(-lam[i], i) for i in range(n)]
    heapq.heapify(heap)
    remaining = n
    while remaining > 0:
        while heap:
            neg_l, c = heap[0]
            if cf[c] != UNASSIGNED or -neg_l != lam[c]:
                heapq.heappop(heap)
                continue
            break
        if not heap or lam[heap[0][1]] <= 0:
            cf[cf == UNASSIGNED] = FPT
            break
        _, c = heapq.heappop(heap)
        cf[c] = CPT
        remaining -= 1
        for f in STi[STp[c]:STp[c + 1]]:
            if cf[f] != UNASSIGNED:
                continue
            cf[f] = FPT
            remaining -= 1
            for j in Si[Sp[f]:Sp[f + 1]]:
                if cf[j] == UNASSIGNED:
                    lam[j] += 1
                    heapq.heappush(heap, (-lam[j], int(j)))
        for j in Si[Sp[c]:Sp[c + 1]]:
            if cf[j] == UNASSIGNED and lam[j] > 0:
                lam[j] -= 1
                heapq.heappush(heap, (-lam[j], int(j)))
    if second_pass:
        _rs_second_pass(n, Sp, Si, cf)
    return cf


def _rs_second_pass(n, Sp, Si, cf):
    in_Ci = np.zeros(n, dtype=bool)
    for i in range(n):
        if cf[i] != FPT:
            continue
        Ci = [j for j in Si[Sp[i]:Sp[i + 1]] if cf[j] == CPT]
        in_Ci[Ci] = True
        tentative = -1
        for j in Si[Sp[i]:Sp[i + 1]]:
            if cf[j] != FPT:
                continue
            if not in_Ci[Si[Sp[j]:Sp[j + 1]]].any():
                if tentative < 0:
                    tentative = j
                    cf[j] = CPT
                    in_Ci[j] = True
                else:
                    cf[tentative] = FPT
                    in_Ci[tentative] = False
                    cf[i] = CPT
                    tentative = -1
                    break
        in_Ci[Ci] = False
        if tentative >= 0:
            in_Ci[tentative] = False


def pmis_splitting(S: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """PMIS splitting (De Sterck/Yang/Heys 2006) — the parallel-friendly
    variant used for distributed setup (deterministic hash tiebreaker)."""
    n = S.shape[0]
    Sp, Si, STp, STi = _graph_arrays(S)
    cf = np.empty(n, dtype=np.int8)
    lib = get_lib()
    if lib is not None:
        lib.pmis_cf(n, Sp, Si, STp, STi, int(seed), cf)
        return cf
    return _pmis_python(n, Sp, Si, STp, STi, seed, cf)


def _hash01(x: np.ndarray, seed: int) -> np.ndarray:
    x = (x.astype(np.uint64) ^ np.uint64(seed + 0x9E3779B97F4A7C15)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return (x >> np.uint64(11)).astype(np.float64) / 9007199254740992.0


def _pmis_python(n, Sp, Si, STp, STi, seed, cf):
    UNASSIGNED = -1
    cf[:] = UNASSIGNED
    w = (STp[1:] - STp[:-1]).astype(np.float64) + _hash01(
        np.arange(n, dtype=np.uint64), seed)
    isolated = (Sp[1:] == Sp[:-1]) & (STp[1:] == STp[:-1])
    cf[isolated] = FPT
    Ssym = sp.csr_matrix(
        (np.ones(len(Si)), Si, Sp), shape=(n, n))
    Ssym = (Ssym + Ssym.T).tocsr()
    Gp, Gi = Ssym.indptr, Ssym.indices
    prev = -1
    while True:
        un = cf == UNASSIGNED
        rem = int(un.sum())
        if rem == 0 or rem == prev:
            break
        prev = rem
        # i is selected if its weight beats every unassigned neighbour
        nbr_max = np.zeros(n)
        for i in np.where(un)[0]:
            nb = Gi[Gp[i]:Gp[i + 1]]
            nb = nb[(cf[nb] == UNASSIGNED) & (nb != i)]
            nbr_max[i] = w[nb].max() if len(nb) else -np.inf
        newc = un & (w > nbr_max)
        cf[newc] = CPT
        for i in np.where(cf == UNASSIGNED)[0]:
            if (cf[Si[Sp[i]:Sp[i + 1]]] == CPT).any():
                cf[i] = FPT
    cf[cf == UNASSIGNED] = CPT
    return cf


def dist2_cc_graph(S: sp.csr_matrix, cf: np.ndarray) -> sp.csr_matrix:
    """Distance-2 strength graph among C-points (hypre aggressive
    coarsening, agg_num_levels): c1 ~ c2 iff c2 in S(c1), or some F-point
    f has f in S(c1) and c2 in S(f).  Rows/cols are C-local indices; a
    second PMIS round on this graph yields the aggressive C set without
    ever forming the intermediate Galerkin operator."""
    n = S.shape[0]
    is_c = cf == CPT
    n_c = int(is_c.sum())
    cmap = (np.cumsum(is_c, dtype=np.int64) - 1).astype(np.int32)
    lib = get_lib()
    if lib is not None and S.nnz >= (1 << 12):
        Sp = np.ascontiguousarray(S.indptr, dtype=np.int64)
        Si = np.ascontiguousarray(S.indices, dtype=np.int32)
        cf8 = np.ascontiguousarray(cf, dtype=np.int8)
        S2p = np.empty(n_c + 1, dtype=np.int64)
        nnz = int(lib.dist2_cc_symbolic(n, Sp, Si, cf8, cmap, n_c, S2p))
        S2i = np.empty(nnz, dtype=np.int32)
        lib.dist2_cc_fill(n, Sp, Si, cf8, cmap, S2p, S2i)
        ones = np.ones(nnz, dtype=np.float32)
        return sp.csr_matrix((ones, S2i, S2p), shape=(n_c, n_c))
    # numpy oracle: boolean pattern algebra
    B = sp.csr_matrix(
        (np.ones(S.nnz, dtype=bool), S.indices, S.indptr), shape=S.shape)
    B.setdiag(False)
    B.eliminate_zeros()
    C = np.where(is_c)[0]
    F = np.where(~is_c)[0]
    S_cc = B[C][:, C]
    S_cf = B[C][:, F]
    S_fc = B[F][:, C]
    S2 = (S_cc + S_cf @ S_fc).tocsr()
    S2.setdiag(False)
    S2.eliminate_zeros()
    S2.sort_indices()
    return sp.csr_matrix(
        (np.ones(S2.nnz, dtype=np.float32), S2.indices, S2.indptr),
        shape=(n_c, n_c))
