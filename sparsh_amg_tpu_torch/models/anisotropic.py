"""Rotated anisotropic diffusion (BASELINE.json config 2: eps=1e-3 rotated).

-div(K grad u) with K = R(angle)^T diag(1, eps) R(angle), discretized with
the standard 9-point FD stencil on a uniform grid (the classic AMG stress
test; see Briggs/Henson/McCormick and the BoomerAMG papers, SURVEY.md [L]).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def anisotropic2d(nx: int, ny: int | None = None, epsilon: float = 1e-3,
                  angle_deg: float = 45.0, dtype=np.float64) -> sp.csr_matrix:
    """9-point rotated-anisotropy stencil on nx-by-ny interior grid."""
    ny = nx if ny is None else ny
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    # Diffusion tensor entries.
    a = c * c + epsilon * s * s        # u_xx coefficient
    b = epsilon * c * c + s * s        # u_yy coefficient
    d = (1.0 - epsilon) * c * s        # cross-term u_xy coefficient
    # FD stencil (second order): u_xx, u_yy central; u_xy via the standard
    # 4-corner stencil.  Stencil entries at offsets (dx, dy):
    stencil = {
        (0, 0): 2 * a + 2 * b,
        (-1, 0): -a, (1, 0): -a,
        (0, -1): -b, (0, 1): -b,
        (-1, -1): -d / 2, (1, 1): -d / 2,
        (-1, 1): d / 2, (1, -1): d / 2,
    }
    n = nx * ny
    rows, cols, vals = [], [], []
    ix = np.arange(nx)
    iy = np.arange(ny)
    IX, IY = np.meshgrid(ix, iy)               # IY slowest: index = iy*nx+ix
    idx = (IY * nx + IX).ravel()
    IXf, IYf = IX.ravel(), IY.ravel()
    for (dx, dy), v in stencil.items():
        if v == 0.0:
            continue
        jx, jy = IXf + dx, IYf + dy
        m = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
        rows.append(idx[m])
        cols.append((jy[m] * nx + jx[m]))
        vals.append(np.full(m.sum(), v, dtype=dtype))
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    ).tocsr()
    A.sum_duplicates()
    A.eliminate_zeros()
    return A


def anisotropic3d(nx: int, ny: int | None = None, nz: int | None = None,
                  eps_y: float = 1e-3, eps_z: float = 1e-3,
                  angle_deg: float = 45.0,
                  dtype=np.float64) -> sp.csr_matrix:
    """3-D anisotropic diffusion: K = R_z(angle)^T diag(1, eps_y, eps_z)
    R_z(angle) (rotation in the x-y plane; z stays an axis), standard
    second-order FD — 7-point when the rotation is axis-aligned,
    11-point with the x-y cross-term otherwise.  Default angle 45° (the
    rotated stressor, matching anisotropic2d — an unrotated default
    would make the CLI/get_problem surface silently build the much
    easier axis-aligned operator)."""
    from ._stencil import stencil_to_csr_3d
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    # snap axis-aligned rotations exactly: cos(pi/2) is ~6e-17, which
    # would otherwise emit four spurious ~1e-17 cross-term bands
    c = 0.0 if abs(c) < 1e-14 else c
    s = 0.0 if abs(s) < 1e-14 else s
    a = c * c + eps_y * s * s           # u_xx
    b = eps_y * c * c + s * s           # u_yy
    d = (1.0 - eps_y) * c * s           # u_xy
    e = eps_z                           # u_zz
    stencil = {
        (0, 0, 0): 2 * a + 2 * b + 2 * e,
        (-1, 0, 0): -a, (1, 0, 0): -a,
        (0, -1, 0): -b, (0, 1, 0): -b,
        (0, 0, -1): -e, (0, 0, 1): -e,
    }
    if d != 0.0:
        stencil.update({(-1, -1, 0): -d / 2, (1, 1, 0): -d / 2,
                        (-1, 1, 0): d / 2, (1, -1, 0): d / 2})
    return stencil_to_csr_3d(nx, ny, nz, stencil, dtype)
