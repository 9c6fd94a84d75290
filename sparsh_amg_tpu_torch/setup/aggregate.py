"""Aggregation coarsening (SURVEY.md §2 C11): greedy root-node aggregation
(Vanek, Mandel & Brezina 1996), tentative piecewise-constant prolongator, and
optional prolongator smoothing  P = (I - omega D^-1 A) P_tent."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .._native import get_lib


def greedy_aggregation(S: sp.csr_matrix) -> tuple[np.ndarray, int]:
    """Return (agg, n_agg): aggregate id per point."""
    n = S.shape[0]
    Sp = np.ascontiguousarray(S.indptr, dtype=np.int64)
    Si = np.ascontiguousarray(S.indices, dtype=np.int32)
    agg = np.empty(n, dtype=np.int32)
    lib = get_lib()
    if lib is not None:
        n_agg = lib.aggregate_greedy(n, Sp, Si, agg)
        return agg, int(n_agg)
    return _aggregate_python(n, Sp, Si, agg)


def _aggregate_python(n, Sp, Si, agg):
    agg[:] = -1
    next_agg = 0
    for i in range(n):                      # pass 1: free roots
        if agg[i] != -1:
            continue
        nb = Si[Sp[i]:Sp[i + 1]]
        if (agg[nb] == -1).all():
            agg[i] = next_agg
            agg[nb] = next_agg
            next_agg += 1
    agg2 = agg.copy()
    for i in range(n):                      # pass 2: attach to neighbours
        if agg[i] != -1:
            continue
        nb = Si[Sp[i]:Sp[i + 1]]
        owned = nb[agg[nb] != -1]
        if len(owned):
            agg2[i] = agg[owned[0]]
    agg[:] = agg2
    for i in range(n):                      # pass 3: leftovers
        if agg[i] != -1:
            continue
        agg[i] = next_agg
        nb = Si[Sp[i]:Sp[i + 1]]
        agg[nb[agg[nb] == -1]] = next_agg
        next_agg += 1
    return agg, next_agg


def dist2_graph(S: sp.csr_matrix) -> sp.csr_matrix:
    """Pattern of the distance<=2 graph of a SYMMETRIC strength graph:
    S2 = pattern(S + S*S) minus the diagonal.  Greedy pass-1 roots are
    exactly the lexicographic MIS on this graph (see
    greedy_aggregation_rounds)."""
    n = S.shape[0]
    P1 = sp.csr_matrix(
        (np.ones(S.nnz, dtype=np.float32), S.indices, S.indptr),
        shape=S.shape)
    S2 = (P1 + P1 @ P1).tocsr()
    S2.setdiag(0)
    S2.eliminate_zeros()
    S2.sort_indices()
    return S2


def greedy_aggregation_rounds(S: sp.csr_matrix) -> tuple[np.ndarray, int]:
    """Round-based twin of ``greedy_aggregation``, BIT-IDENTICAL to it on
    any symmetric strength graph — the serial oracle for the blocked
    (process-local) aggregation in setup/blocked.py.

    The sequential greedy is an order-dependent scan, but its outcome is
    reproducible from independent rounds because each decision depends
    only on SMALLER-id decisions:

    * pass-1 roots: node i roots iff no earlier root within graph
      distance <= 2 — i.e. the LEXICOGRAPHIC MIS on ``dist2_graph(S)``
      (computable as PMIS rounds with weight = -global id, which is how
      the blocked twin evaluates it from row blocks);
    * pass-1 members: the unique root among each node's neighbors (two
      roots are >= distance 3 apart, so at most one exists);
    * pass 2: attach to the aggregate of the smallest-id pass-<=1
      assigned neighbor, read from the POST-pass-1 snapshot (the serial
      code's agg2 copy);
    * pass-3 roots: the lexicographic MIS on the leftover-restricted
      distance-1 graph, numbered after the pass-1 roots; members attach
      to their smallest-id adjacent pass-3 root.
    """
    n = S.shape[0]
    deg = np.diff(S.indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = S.indices.astype(np.int64)

    S2 = dist2_graph(S)
    root1 = _lex_mis(S2)
    agg = np.full(n, -1, dtype=np.int32)
    r1 = np.flatnonzero(root1)
    agg[r1] = np.arange(len(r1), dtype=np.int32)
    m1 = root1[cols] & ~root1[rows]        # unique root per non-root row
    agg[rows[m1]] = agg[cols[m1]]
    # pass 2 (snapshot semantics)
    assigned = agg != -1
    m2 = ~assigned[rows] & assigned[cols]
    k2 = np.flatnonzero(m2)
    r_u, first = np.unique(rows[k2], return_index=True)
    agg[r_u] = agg[cols[k2[first]]]        # sorted cols => smallest id
    # pass 3 on the leftover subgraph
    left = agg == -1
    if left.any():
        mL = left[rows] & left[cols]
        SL = sp.csr_matrix(
            (np.ones(int(mL.sum()), dtype=np.float32), cols[mL],
             np.concatenate([[0], np.cumsum(
                 np.bincount(rows[mL], minlength=n))]).astype(np.int64)),
            shape=S.shape)
        root3 = _lex_mis(SL) & left
        r3 = np.flatnonzero(root3)
        agg[r3] = len(r1) + np.arange(len(r3), dtype=np.int32)
        # members: smallest-id adjacent pass-3 root
        m3 = left[rows] & ~root3[rows] & root3[cols]
        k3 = np.flatnonzero(m3)
        r_u3, first3 = np.unique(rows[k3], return_index=True)
        agg[r_u3] = agg[cols[k3[first3]]]
        n_agg = len(r1) + len(r3)
    else:
        n_agg = len(r1)
    assert (agg != -1).all(), "rounds aggregation left unassigned nodes"
    return agg, int(n_agg)


def _lex_mis(G: sp.csr_matrix) -> np.ndarray:
    """Lexicographic (smallest-id-first greedy) maximal independent set
    of a symmetric graph, by rounds: i joins when every smaller-id
    neighbor is decided and none is in the set."""
    n = G.shape[0]
    state = np.zeros(n, dtype=np.int8)          # 0 undec, 1 in, -1 out
    Sp, Si = G.indptr, G.indices
    deg = np.diff(Sp)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = Si.astype(np.int64)
    smaller = cols < rows
    while True:
        und = state == 0
        if not und.any():
            break
        # blocked[i]: some smaller-id neighbor is undecided or in-set
        bad = np.zeros(n, dtype=bool)
        m = und[rows] & smaller & (state[cols] >= 0)
        np.logical_or.at(bad, rows[m], und[cols[m]] | (state[cols[m]] == 1))
        new_in = und & ~bad
        if not new_in.any():
            break
        state[new_in] = 1
        # exclude neighbors of new set members
        excl = np.zeros(n, dtype=bool)
        np.logical_or.at(excl, rows, new_in[cols])
        state[excl & (state == 0)] = -1
    return state == 1


def amalgamate(A: sp.csr_matrix, blocksize: int) -> sp.csr_matrix:
    """Node-amalgamated matrix for systems with `blocksize` dofs per node
    (pyamg's blocksize / ML's PDE-equations convention): entry (p, q) is
    the Frobenius norm of the blocksize x blocksize dof block.  Aggregating
    NODES instead of scalar dofs keeps the x/y(/z) dofs of a node in one
    aggregate — for Q1 elasticity this cut operator complexity 1.86 ->
    1.32 at identical iteration counts (RESULTS.md round 3)."""
    n = A.shape[0]
    assert n % blocksize == 0
    coo = A.tocoo()
    nn = n // blocksize
    N = sp.coo_matrix(
        (coo.data * coo.data, (coo.row // blocksize, coo.col // blocksize)),
        shape=(nn, nn)).tocsr()
    N.sum_duplicates()
    np.sqrt(N.data, out=N.data)
    return N


def tentative_prolongator(agg: np.ndarray, n_agg: int) -> sp.csr_matrix:
    """Piecewise-constant tentative P: P[i, agg[i]] = 1."""
    n = len(agg)
    return sp.csr_matrix(
        (np.ones(n), (np.arange(n), agg.astype(np.int64))),
        shape=(n, n_agg))


def tentative_prolongator_nullspace(
        agg: np.ndarray, n_agg: int,
        B: np.ndarray) -> tuple[sp.csr_matrix, np.ndarray]:
    """Tentative P from a near-nullspace basis (Vanek/Mandel/Brezina SA).

    B is (n, k) — e.g. the three 2-D rigid-body modes for elasticity.
    Per aggregate the rows of B are QR-factorized: the orthonormal Q block
    becomes P's column block for that aggregate, and R becomes the coarse
    near-nullspace (so the hierarchy reproduces B exactly: P @ B_c = B).
    Returns (P of shape (n, n_agg*k), B_coarse of shape (n_agg*k, k)).

    Batched over aggregates: rows are packed into an (n_agg, m_max, k)
    table and factorized with one vectorized np.linalg.qr call.
    """
    n, k = B.shape
    counts = np.bincount(agg, minlength=n_agg)
    m_max = max(int(counts.max()), 1)
    order = np.argsort(agg, kind="stable")
    slot = np.arange(n, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(counts[:-1])]), counts)
    table = np.zeros((n_agg, m_max, k))
    table[agg[order], slot, :] = B[order]
    Q, R = np.linalg.qr(table)                # (n_agg, m_max, k), (n_agg, k, k)
    # rank guard: aggregates smaller than k produce ~0 diagonals in R;
    # zero those columns of Q (and rows of R) so no noise basis enters P
    rdiag = np.abs(np.einsum("aii->ai", R))
    scale = np.abs(B).max() + 1e-300
    bad = rdiag <= 1e-10 * scale              # (n_agg, k)
    Q = np.where(bad[:, None, :], 0.0, Q)
    R = np.where(bad[:, :, None], 0.0, R)
    rows = order                               # table row (agg,slot) -> point
    cols = (agg[order][:, None] * k + np.arange(k)[None, :]).ravel()
    vals = Q[agg[order], slot, :].ravel()
    P = sp.csr_matrix(
        (vals, (np.repeat(rows, k), cols)), shape=(n, n_agg * k))
    P.eliminate_zeros()
    B_c = R.reshape(n_agg * k, k)
    # rank-deficient aggregates left all-zero columns; drop those coarse
    # dofs entirely (a zero P column would make the Galerkin operator
    # singular)
    keep = ~bad.ravel()
    if not keep.all():
        P = P[:, keep].tocsr()
        B_c = B_c[keep]
    return P, B_c


def smooth_prolongator(A: sp.csr_matrix, P_tent: sp.csr_matrix,
                       omega: float = 2.0 / 3.0,
                       strong_mask: np.ndarray | None = None,
                       compensation: str = "lump",
                       spectral: bool = False) -> sp.csr_matrix:
    """One damped-Jacobi smoothing step: P = (I - omega D_f^-1 A_f) P_tent.

    When `strong_mask` is given, A is FILTERED first: weak off-diagonal
    entries are dropped with `compensation` handling of the diagonal —
    "lump" adds the dropped entries to it (row-sum preserving, ML-style),
    "subtract" removes them (Vanek/Mandel/Brezina's filtered matrix A^F,
    which keeps D^-1 A^F's spectrum tight for systems like elasticity),
    "none" leaves the diagonal alone.  Smoothing with the unfiltered
    operator lets each level's P inherit the coarse operator's growing
    stencil and Galerkin complexity explodes (observed opC 10.5 on 64^3
    Poisson without filtering, 1.5 with).

    `spectral=True` rescales omega by a power-iteration estimate of
    rho(D^-1 A_f) (pyamg's jacobi_prolongation_smoother convention,
    omega_eff = omega / rho) — the fixed-omega form under-smooths P when
    rho(D^-1 A) is far from 1 (elasticity: rho ~ 2.9)."""
    if strong_mask is not None:
        n = A.shape[0]
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
        dmask = A.indices == rows
        keep = strong_mask | dmask
        data_f = np.where(keep, A.data, 0.0)
        if compensation != "none":
            lump = np.zeros(n)
            np.add.at(lump, rows, np.where(~keep, A.data, 0.0))
            sign = 1.0 if compensation == "lump" else -1.0
            data_f = np.where(dmask, data_f + sign * lump[rows], data_f)
        # copy index arrays: eliminate_zeros() mutates them in place and
        # they must not be shared with the caller's matrix
        A = sp.csr_matrix((data_f, A.indices.copy(), A.indptr.copy()),
                          shape=A.shape)
        A.eliminate_zeros()
    d = A.diagonal()
    with np.errstate(divide="ignore"):
        dinv = np.where(d != 0, 1.0 / d, 0.0)
    # direct row scaling, NOT sp.diags(dinv) @ A: the scipy matmul emits
    # rows in insertion order (unsorted), which perturbs the accumulation
    # order of the P product at ulp level — the blocked twin
    # (setup/blocked_sa.py smooth_p_rows) mirrors this exact form so
    # smoothed rows are bit-identical across the two paths
    Dinv_A = sp.csr_matrix(
        (A.data * np.repeat(dinv, np.diff(A.indptr)), A.indices,
         A.indptr), shape=A.shape)
    if spectral:
        rng = np.random.default_rng(7)
        v = rng.standard_normal(A.shape[0])
        rho = 1.0
        for _ in range(15):
            v = Dinv_A @ v
            nrm = np.linalg.norm(v)
            if nrm == 0:
                break
            rho, v = nrm, v / nrm
        omega = omega / max(rho, 1e-12)
    P = (P_tent - omega * (Dinv_A @ P_tent)).tocsr()
    P.sum_duplicates()
    return P
