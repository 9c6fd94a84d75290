"""Discontinuous-coefficient ("jump") diffusion problems — the classical
AMG stressor (SURVEY.md §2 C3 problem families; hypre/pyamg test staple):
-div(k(x) grad u) with k jumping by orders of magnitude across material
interfaces.  Geometric methods lose h-independence here; algebraic
strength-of-connection is exactly what recovers it, so this family is
the canary for the strength/coarsening pipeline.

FD 5-point with HARMONIC-mean face coefficients (the conservative flux
discretization — an arithmetic mean smears the interface and produces a
qualitatively wrong operator): for cells i,j sharing a face,
a_ij = -2 k_i k_j / (k_i + k_j).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _cell_coeffs(nx: int, ny: int, pattern: str, contrast: float,
                 seed: int) -> np.ndarray:
    iy, ix = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    if pattern == "checkerboard":
        # 4x4 tiles of alternating k = 1 / contrast
        tile = 4
        k = np.where(((ix // tile) + (iy // tile)) % 2 == 0, 1.0, contrast)
    elif pattern == "island":
        # high-k square inclusion in the center (the textbook interface)
        k = np.ones((ny, nx))
        k[ny // 4: 3 * ny // 4, nx // 4: 3 * nx // 4] = contrast
    elif pattern == "random":
        rng = np.random.default_rng(seed)
        # log-uniform per 4x4 block
        nbx, nby = -(-nx // 4), -(-ny // 4)
        blk = np.exp(rng.uniform(0.0, np.log(contrast), (nby, nbx)))
        k = blk[iy // 4, ix // 4]
    else:
        raise ValueError(f"unknown pattern {pattern!r}")
    return k.astype(np.float64)


def jump2d(nx: int, ny: int | None = None, contrast: float = 1e4,
           pattern: str = "checkerboard", seed: int = 0,
           dtype=np.float64) -> sp.csr_matrix:
    """2-D jump-coefficient diffusion on an nx-by-ny interior grid
    (Dirichlet), 5-point FD with harmonic face averaging.  Returns SPD
    CSR; row-major index = iy*nx + ix."""
    ny = nx if ny is None else ny
    k = _cell_coeffs(nx, ny, pattern, contrast, seed)

    def harm(a, b):
        return 2.0 * a * b / (a + b)

    # face coefficients between horizontally / vertically adjacent cells
    fx = harm(k[:, :-1], k[:, 1:])          # (ny, nx-1)
    fy = harm(k[:-1, :], k[1:, :])          # (ny-1, nx)

    n = nx * ny
    idx = (np.arange(ny)[:, None] * nx + np.arange(nx)[None, :])
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(v.ravel())

    add(idx[:, :-1], idx[:, 1:], -fx)       # east
    add(idx[:, 1:], idx[:, :-1], -fx)       # west
    add(idx[:-1, :], idx[1:, :], -fy)       # north
    add(idx[1:, :], idx[:-1, :], -fy)       # south
    # diagonal: Dirichlet boundary faces use the cell's own k (ghost
    # coefficient = k_i, harmonic mean with itself)
    diag = np.zeros((ny, nx))
    diag[:, :-1] += fx
    diag[:, 1:] += fx
    diag[:-1, :] += fy
    diag[1:, :] += fy
    diag[:, 0] += k[:, 0]
    diag[:, -1] += k[:, -1]
    diag[0, :] += k[0, :]
    diag[-1, :] += k[-1, :]
    add(idx, idx, diag)

    A = sp.coo_matrix(
        (np.concatenate(vals).astype(dtype),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A
