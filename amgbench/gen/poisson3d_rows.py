"""Rows r0:r1 of ``gen/poisson3d.py``'s operator alone, for a rank
process that holds a block of rows and never the whole matrix: the same
formula evaluated on those rows, global column ids, columns in ascending
order, float64 values and int32 column indices, so the block equals the
whole matrix's row slice bit for bit."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def rows(size: dict, r0: int, r1: int) -> sp.csr_matrix:
    """The (r1 - r0, n^3) block of rows r0:r1."""
    n = int(size["n"])
    total = n ** 3
    if total + n * n >= 2 ** 31:
        raise ValueError(f"poisson3d({n}) does not fit int32 indices")
    if not 0 <= r0 <= r1 <= total:
        raise ValueError(f"rows {r0}:{r1} outside 0:{total}")
    k = np.arange(r0, r1, dtype=np.int32)
    ix = k % n
    iy = (k // n) % n
    iz = k // (n * n)
    offsets = np.array([-n * n, -n, -1, 0, 1, n, n * n], dtype=np.int32)
    present = np.stack([iz > 0, iy > 0, ix > 0, np.ones(k.size, dtype=bool),
                        ix < n - 1, iy < n - 1, iz < n - 1], axis=1)
    del ix, iy, iz
    indptr = np.zeros(k.size + 1, dtype=np.int64)
    np.cumsum(present.sum(axis=1), out=indptr[1:])
    indices = (k[:, None] + offsets[None, :])[present]
    values = np.where(offsets == 0, 6.0, -1.0)
    data = np.broadcast_to(values, present.shape)[present]
    A = sp.csr_matrix((data, indices, indptr), shape=(k.size, total))
    A.has_sorted_indices = True
    A.has_canonical_format = True
    return A
