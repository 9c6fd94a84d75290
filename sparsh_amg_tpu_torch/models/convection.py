"""Convection-diffusion model problem (nonsymmetric).

The reference pairs BiCGStab with AMG for convective/nonsymmetric systems
(SURVEY.md §2 C20; its FEM client produces convection-diffusion operators).
Standard test: -eps*Laplace(u) + b . grad(u) on the unit square, first-order
upwind convection (keeps the matrix an M-matrix, AMG-friendly), Dirichlet
boundaries.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def convection2d(nx: int, ny: int | None = None, epsilon: float = 1e-2,
                 bx: float = 1.0, by: float = 0.5,
                 dtype=np.float64) -> sp.csr_matrix:
    """-eps*Lap(u) + (bx,by).grad(u), 5-point upwind FD on an nx-by-ny
    interior grid with h = 1/(nx+1).  Nonsymmetric for (bx,by) != 0."""
    ny = nx if ny is None else ny
    h = 1.0 / (nx + 1)
    n = nx * ny
    # diffusion part: eps/h^2 * standard 5-point
    cd = epsilon / (h * h)
    # upwind convection: for b > 0, du/dx ~ (u_i - u_{i-1})/h
    cwx_m = -bx / h if bx > 0 else 0.0        # coefficient of u_{i-1,j}
    cwx_p = bx / h if bx < 0 else 0.0         # u_{i+1,j}
    cwx_d = abs(bx) / h
    cwy_m = -by / h if by > 0 else 0.0
    cwy_p = by / h if by < 0 else 0.0
    cwy_d = abs(by) / h

    stencil = {
        (0, 0): 4 * cd + cwx_d + cwy_d,
        (-1, 0): -cd + cwx_m, (1, 0): -cd + cwx_p,
        (0, -1): -cd + cwy_m, (0, 1): -cd + cwy_p,
    }
    ix = np.arange(nx)
    iy = np.arange(ny)
    IX, IY = np.meshgrid(ix, iy)
    idx = (IY * nx + IX).ravel()
    IXf, IYf = IX.ravel(), IY.ravel()
    rows, cols, vals = [], [], []
    for (dx, dy), v in stencil.items():
        if v == 0.0:
            continue
        jx, jy = IXf + dx, IYf + dy
        m = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
        rows.append(idx[m])
        cols.append(jy[m] * nx + jx[m])
        vals.append(np.full(int(m.sum()), v, dtype=dtype))
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def convection3d(nx: int, ny: int | None = None, nz: int | None = None,
                 epsilon: float = 1e-2,
                 b: tuple = (1.0, 0.5, 0.25),
                 dtype=np.float64) -> sp.csr_matrix:
    """-eps*Lap(u) + b.grad(u), 7-point upwind FD on an interior
    nx*ny*nz grid with h = 1/(nx+1) — the 3-D CDR operator shape of the
    reference's FEM client (SURVEY.md §1 ParMooN; §2 C20 pairs BiCGStab
    with AMG for these).  First-order upwinding keeps the M-matrix
    property; nonsymmetric for b != 0."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    h = 1.0 / (nx + 1)
    n = nx * ny * nz
    cd = epsilon / (h * h)
    bx, by, bz = b

    def up(bc):
        # (coeff of u_{-1}, coeff of u_{+1}, diagonal contribution)
        return ((-bc / h if bc > 0 else 0.0),
                (bc / h if bc < 0 else 0.0),
                abs(bc) / h)

    (cxm, cxp, cxd), (cym, cyp, cyd), (czm, czp, czd) = up(bx), up(by), up(bz)
    stencil = {
        (0, 0, 0): 6 * cd + cxd + cyd + czd,
        (-1, 0, 0): -cd + cxm, (1, 0, 0): -cd + cxp,
        (0, -1, 0): -cd + cym, (0, 1, 0): -cd + cyp,
        (0, 0, -1): -cd + czm, (0, 0, 1): -cd + czp,
    }
    from ._stencil import stencil_to_csr_3d
    return stencil_to_csr_3d(nx, ny, nz, stencil, dtype)
