"""3-D 7-point Poisson on an n x n x n interior grid, eliminated Dirichlet
boundaries: the benchmark's frozen copy of
``sparsh_amg_tpu_torch/models/poisson.py::poisson3d`` (its native fill,
``_native/amg_core.cpp::poisson3d_fill``), vectorised in NumPy.

Row k = (iz*n + iy)*n + ix holds 6 on the diagonal and -1 at each
neighbour inside the grid, columns in ascending order, float64 values,
int32 column indices."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def build(size: dict):
    """(A, None): the operator and no near-nullspace."""
    n = int(size["n"])
    rows = n ** 3
    if rows + n * n >= 2 ** 31:
        raise ValueError(f"poisson3d({n}) does not fit int32 indices")
    k = np.arange(rows, dtype=np.int32)
    ix = k % n
    iy = (k // n) % n
    iz = k // (n * n)
    # the seven stencil points in ascending column order, each present
    # where its neighbour lies inside the grid
    offsets = np.array([-n * n, -n, -1, 0, 1, n, n * n], dtype=np.int32)
    present = np.stack([iz > 0, iy > 0, ix > 0, np.ones(rows, dtype=bool),
                        ix < n - 1, iy < n - 1, iz < n - 1], axis=1)
    del ix, iy, iz
    indptr = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(present.sum(axis=1), out=indptr[1:])
    indices = (k[:, None] + offsets[None, :])[present]
    values = np.where(offsets == 0, 6.0, -1.0)
    data = np.broadcast_to(values, present.shape)[present]
    A = sp.csr_matrix((data, indices, indptr), shape=(rows, rows))
    A.has_sorted_indices = True
    A.has_canonical_format = True
    return A, None
