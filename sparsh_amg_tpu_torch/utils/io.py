"""Matrix / right-hand-side file I/O (SURVEY.md §2 C2).

The reference ingests MatrixMarket ``.mtx`` system matrices and plain
right-hand-side vector files in its example drivers; this module is the
equivalent surface: MatrixMarket for matrices (dense or coordinate) and
either MatrixMarket arrays or whitespace-separated text for vectors.
"""
from __future__ import annotations

import numpy as np
import scipy.io
import scipy.sparse as sp


def read_matrix(path: str) -> sp.csr_matrix:
    """Read a MatrixMarket matrix file into CSR (float64)."""
    A = scipy.io.mmread(path)
    return sp.csr_matrix(A, dtype=np.float64)


def write_matrix(path: str, A: sp.spmatrix, comment: str = "") -> None:
    """Write a sparse matrix as MatrixMarket coordinate format."""
    scipy.io.mmwrite(path, sp.coo_matrix(A), comment=comment)


def read_rhs(path: str, n: int | None = None) -> np.ndarray:
    """Read a right-hand-side vector.

    ``.mtx`` files are parsed as MatrixMarket (dense array or a single
    coordinate column); anything else is whitespace/newline-separated
    floats (the common academic-driver format).  If ``n`` is given the
    length is validated.
    """
    if path.endswith((".mtx", ".mm")):
        b = scipy.io.mmread(path)
        b = np.asarray(b.todense() if sp.issparse(b) else b,
                       dtype=np.float64).ravel()
    else:
        b = np.loadtxt(path, dtype=np.float64).ravel()
    if n is not None and b.shape[0] != n:
        raise ValueError(
            f"rhs length {b.shape[0]} does not match matrix size {n}")
    return b


def write_rhs(path: str, b: np.ndarray) -> None:
    """Write a vector: MatrixMarket array for .mtx paths, text otherwise."""
    b = np.asarray(b, dtype=np.float64)
    if path.endswith((".mtx", ".mm")):
        scipy.io.mmwrite(path, b.reshape(-1, 1))
    else:
        np.savetxt(path, b)
