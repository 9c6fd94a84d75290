"""Hex Q1 linear elasticity, 3 dofs a node, x == 0 face clamped, and its
six rigid-body modes: the benchmark's frozen copy of
``sparsh_amg_tpu_torch/models/elasticity.py`` (``elasticity3d``,
``elasticity3d_nullspace`` and the helpers they call), unchanged but for
``build``."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# reference-cube node order: (0,0,0),(1,0,0),(1,1,0),(0,1,0),
#                            (0,0,1),(1,0,1),(1,1,1),(0,1,1)
_HEX_SIGNS = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                       [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                      dtype=np.float64)


def _hex8_elasticity_element(E: float, nu: float) -> np.ndarray:
    """24x24 element stiffness for a unit cube trilinear hex, isotropic
    3-D elasticity, 2x2x2 Gauss quadrature.  Dof order: (ux0, uy0, uz0,
    ux1, ...) for the 8 nodes above."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] = lam + 2 * mu
    D[np.arange(3, 6), np.arange(3, 6)] = mu
    g = 1.0 / np.sqrt(3.0)
    Ke = np.zeros((24, 24))
    for gx in (-g, g):
        for gy in (-g, g):
            for gz in (-g, g):
                xi = np.array([gx, gy, gz])
                s = _HEX_SIGNS
                # dN_k/dxi_a on [-1,1]^3; unit cube element -> J = I/2,
                # dN/dx = 2 dN/dxi, detJ = 1/8
                f = 0.125 * np.stack(
                    [(1 + s[:, 1] * xi[1]) * (1 + s[:, 2] * xi[2]) * s[:, 0],
                     (1 + s[:, 0] * xi[0]) * (1 + s[:, 2] * xi[2]) * s[:, 1],
                     (1 + s[:, 0] * xi[0]) * (1 + s[:, 1] * xi[1]) * s[:, 2]])
                dN = 2.0 * f                     # (3, 8) spatial gradients
                B = np.zeros((6, 24))
                B[0, 0::3] = dN[0]
                B[1, 1::3] = dN[1]
                B[2, 2::3] = dN[2]
                B[3, 0::3] = dN[1]; B[3, 1::3] = dN[0]   # gamma_xy
                B[4, 1::3] = dN[2]; B[4, 2::3] = dN[1]   # gamma_yz
                B[5, 0::3] = dN[2]; B[5, 2::3] = dN[0]   # gamma_zx
                Ke += B.T @ D @ B * 0.125
    return Ke


def _grid3d_clamped(nx: int, ny: int, nz: int):
    """Free-dof bookkeeping shared by the 3-D operator and nullspace:
    returns (n_nodes, clamped_dof_mask) with the x == 0 face clamped."""
    nnx, nny, nnz_ = nx + 1, ny + 1, nz + 1
    n_nodes = nnx * nny * nnz_
    clamped = np.zeros(3 * n_nodes, dtype=bool)
    face = (np.arange(n_nodes) % nnx) == 0
    for d in range(3):
        clamped[3 * np.where(face)[0] + d] = True
    return n_nodes, clamped


def elasticity3d(nx: int, ny: int | None = None, nz: int | None = None,
                 E: float = 1e5, nu: float = 0.3,
                 dtype=np.float64) -> sp.csr_matrix:
    """Assemble isotropic 3-D elasticity on an nx*ny*nz trilinear-hex
    element grid, x == 0 face clamped (Dirichlet rows/cols eliminated).
    Node index = (iz*nny + iy)*nnx + ix; 3 dofs per node.  Assembly is
    fully vectorized (every element shares one Ke): nel*576 COO entries."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    nnx, nny = nx + 1, ny + 1
    Ke = _hex8_elasticity_element(E, nu)
    ex, ey, ez = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    n0 = ((ez * nny + ey) * nnx + ex).ravel()
    off = np.array([0, 1, 1 + nnx, nnx,
                    nnx * nny, 1 + nnx * nny,
                    1 + nnx + nnx * nny, nnx + nnx * nny], dtype=np.int64)
    nodes = n0[:, None] + off[None, :]                   # (nel, 8)
    dofs = (3 * nodes[:, :, None]
            + np.arange(3, dtype=np.int64)).reshape(-1, 24)  # (nel, 24)
    rows = np.broadcast_to(dofs[:, :, None], dofs.shape + (24,)).ravel()
    cols = np.broadcast_to(dofs[:, None, :], (dofs.shape[0], 24, 24)).ravel()
    vals = np.broadcast_to(Ke, (dofs.shape[0], 24, 24)).ravel()
    n_nodes, clamped = _grid3d_clamped(nx, ny, nz)
    A = sp.coo_matrix((vals.astype(dtype), (rows, cols)),
                      shape=(3 * n_nodes, 3 * n_nodes)).tocsr()
    keep = np.where(~clamped)[0]
    A = A[keep][:, keep].tocsr()
    A.sum_duplicates()
    A.eliminate_zeros()
    return A


def elasticity3d_nullspace(nx: int, ny: int | None = None,
                           nz: int | None = None) -> np.ndarray:
    """The six 3-D rigid-body modes — translations e_x/e_y/e_z and the
    rotations (-y,x,0), (z,0,-x), (0,-z,y) — at the free dofs of
    :func:`elasticity3d` (same clamping).  Near-nullspace basis for
    smoothed aggregation on 3-D elasticity (Vanek/Mandel/Brezina 1996)."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    nnx, nny, nnz_ = nx + 1, ny + 1, nz + 1
    iz, iy, ix = np.meshgrid(np.arange(nnz_), np.arange(nny),
                             np.arange(nnx), indexing="ij")
    x = ix.ravel() / nx
    y = iy.ravel() / ny
    z = iz.ravel() / nz
    n_nodes, clamped = _grid3d_clamped(nx, ny, nz)
    B = np.zeros((3 * n_nodes, 6))
    B[0::3, 0] = 1.0
    B[1::3, 1] = 1.0
    B[2::3, 2] = 1.0
    B[0::3, 3] = -y      # rotation about z
    B[1::3, 3] = x
    B[0::3, 4] = z       # rotation about y
    B[2::3, 4] = -x
    B[1::3, 5] = -z      # rotation about x
    B[2::3, 5] = y
    return B[~clamped]


def build(size: dict):
    """(A, near-nullspace) of elasticity3d(m) on an m x m x m element
    grid."""
    m = int(size["m"])
    return elasticity3d(m), elasticity3d_nullspace(m)
