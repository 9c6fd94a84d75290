"""2-D rotated anisotropic diffusion on an m x ny interior grid, eliminated
Dirichlet boundaries: the benchmark's frozen copy of
``sparsh_amg_tpu_torch/models/anisotropic.py::anisotropic2d``, vectorised
in NumPy.

-div(K grad u) with K = R(angle)^T diag(1, epsilon) R(angle), the standard
second-order 9-point stencil.  Row k = iy*m + ix holds the stencil points
whose neighbour lies inside the grid, columns in ascending order, float64
values (computed as that function computes them), int32 column indices.
A stencil point whose value is zero (no cross term at 0 or 90 degrees)
is not stored."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def stencil(epsilon: float, angle_deg: float) -> dict:
    """{(dx, dy): value} of the 9-point stencil."""
    th = np.deg2rad(angle_deg)
    c, s = np.cos(th), np.sin(th)
    a = c * c + epsilon * s * s        # u_xx
    b = epsilon * c * c + s * s        # u_yy
    d = (1.0 - epsilon) * c * s        # u_xy
    return {(-1, -1): -d / 2, (0, -1): -b, (1, -1): d / 2,
            (-1, 0): -a, (0, 0): 2 * a + 2 * b, (1, 0): -a,
            (-1, 1): d / 2, (0, 1): -b, (1, 1): -d / 2}


def build(size: dict):
    """(A, None): the operator and no near-nullspace.  size: ``m`` (grid
    points along x), ``ny`` (along y; default m), ``epsilon``,
    ``angle_deg``."""
    nx = int(size["m"])
    ny = int(size.get("ny", nx))
    rows = nx * ny
    if rows + nx + 1 >= 2 ** 31:
        raise ValueError(f"anisotropic2d({nx}, {ny}) does not fit int32 "
                         f"indices")
    # in ascending column order: dy slowest, then dx
    points = [(pt, v) for pt, v in sorted(
        stencil(float(size["epsilon"]), float(size["angle_deg"])).items(),
        key=lambda kv: (kv[0][1], kv[0][0])) if v != 0.0]
    k = np.arange(rows, dtype=np.int32)
    ix = k % nx
    iy = k // nx
    offsets = np.array([dy * nx + dx for (dx, dy), _ in points],
                       dtype=np.int32)
    present = np.stack([(ix + dx >= 0) & (ix + dx < nx)
                        & (iy + dy >= 0) & (iy + dy < ny)
                        for (dx, dy), _ in points], axis=1)
    del ix, iy
    indptr = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(present.sum(axis=1), out=indptr[1:])
    indices = (k[:, None] + offsets[None, :])[present]
    values = np.array([v for _, v in points], dtype=np.float64)
    data = np.broadcast_to(values, present.shape)[present]
    A = sp.csr_matrix((data, indices, indptr), shape=(rows, rows))
    A.has_sorted_indices = True
    A.has_canonical_format = True
    return A, None
