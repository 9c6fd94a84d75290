"""Unstructured test problems (VERDICT r4 missing #3: every on-chip
artifact so far was a regular-grid stencil, while the reference's
SuiteSparse config targets G3_circuit/thermal2-class matrices with
genuinely irregular structure — unfetchable here (zero egress), so these
generators produce the same MATRIX CLASS locally).

`delaunay_laplacian` builds the weighted graph Laplacian of a Delaunay
triangulation over jittered points: node degrees vary (5-9 typical, tail
to ~12+), the sparsity pattern has no stencil bands, and after RCM the
column profile is banded-ish but ragged — exactly the locality regime
the GELL window packer has never been measured on (its stream-slope
layout argument is derived from grid locality, ops/gell.py).

SPD: L = D - W with W > 0 (M-matrix), grounded at the hull points by a
Dirichlet diagonal shift — the standard "SuiteSparse surrogate" used in
AMG papers when the real matrices are unavailable.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def delaunay_laplacian(n_points: int, seed: int = 0, jitter: float = 0.45,
                       rcm: bool = True,
                       dtype=np.float64) -> sp.csr_matrix:
    """Weighted graph Laplacian of a 2-D Delaunay triangulation.

    Points are a jittered sqrt(n) x sqrt(n) lattice (jitter in units of
    the spacing, 0.45 ~ strongly irregular but non-degenerate
    triangles), edges get inverse-distance weights, boundary (hull)
    points are grounded.  With ``rcm`` the matrix is returned in
    reverse-Cuthill-McKee order — the natural ordering a careful user
    would feed any solver, and the one BASELINE's SuiteSparse configs
    imply; pass False to stress the packer with raw locality.
    """
    from scipy.spatial import Delaunay
    m = int(round(np.sqrt(n_points)))
    n = m * m
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    pts = np.stack([ii.ravel(), jj.ravel()], axis=1).astype(np.float64)
    pts += rng.uniform(-jitter, jitter, size=pts.shape)
    tri = Delaunay(pts)
    # undirected edge list from the simplices
    s = tri.simplices
    e = np.concatenate([s[:, [0, 1]], s[:, [1, 2]], s[:, [2, 0]]])
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    d = np.linalg.norm(pts[e[:, 0]] - pts[e[:, 1]], axis=1)
    w = 1.0 / np.maximum(d, 1e-6)
    rows = np.concatenate([e[:, 0], e[:, 1]])
    cols = np.concatenate([e[:, 1], e[:, 0]])
    vals = np.concatenate([w, w])
    W = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    deg = np.asarray(W.sum(axis=1)).ravel()
    # ground the hull points (Dirichlet): adds their mean edge weight to
    # the diagonal, making L strictly SPD
    hull = np.unique(tri.convex_hull.ravel())
    shift = np.zeros(n)
    shift[hull] = deg[hull] / np.maximum(
        np.diff(W.indptr)[hull], 1)
    L = sp.diags(deg + shift) - W
    L = L.tocsr()
    L.sum_duplicates()
    if rcm:
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        perm = np.asarray(reverse_cuthill_mckee(L, symmetric_mode=True))
        L = L[perm][:, perm].tocsr()
        L.sum_duplicates()
    return L.astype(dtype)
