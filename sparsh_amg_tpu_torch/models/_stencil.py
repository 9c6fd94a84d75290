"""Shared COO stencil assembly for the FD model generators.

Every constant-coefficient family (convection3d, anisotropic3d, ...)
needs the same scaffolding: interior-grid index maps, per-offset
bounds-masked scatter, COO->CSR.  One copy here keeps the index-ordering
convention ((iz*ny + iy)*nx + ix, x fastest) in one place.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def stencil_to_csr_3d(nx: int, ny: int, nz: int, stencil: dict,
                      dtype=np.float64) -> sp.csr_matrix:
    """CSR operator from {(dx, dy, dz): coeff} on an interior
    nx*ny*nz grid (eliminated Dirichlet boundaries)."""
    n = nx * ny * nz
    ix, iy, iz = np.arange(nx), np.arange(ny), np.arange(nz)
    IZ, IY, IX = np.meshgrid(iz, iy, ix, indexing="ij")
    IXf, IYf, IZf = IX.ravel(), IY.ravel(), IZ.ravel()
    idx = (IZf * ny + IYf) * nx + IXf
    rows, cols, vals = [], [], []
    for (dx, dy, dz), v in stencil.items():
        if v == 0.0:
            continue
        jx, jy, jz = IXf + dx, IYf + dy, IZf + dz
        m = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
             & (jz >= 0) & (jz < nz))
        rows.append(idx[m])
        cols.append((jz[m] * ny + jy[m]) * nx + jx[m])
        vals.append(np.full(int(m.sum()), v, dtype=dtype))
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A
