"""The plain reference: the relative residual of a solution, worked out in
float64 with NumPy and SciPy from the benchmark's own matrix and
right-hand side.  It imports nothing of the program and takes nothing
the program made but the solution it judges."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def relres(A: sp.csr_matrix, x: np.ndarray, b: np.ndarray,
           shift: float = 0.0) -> float:
    """||b - (A + shift I) x|| / ||b|| in float64."""
    x = np.asarray(x, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if x.shape != b.shape:
        raise ValueError(f"solution of shape {x.shape} for a right-hand "
                         f"side of shape {b.shape}")
    r = b - A @ x
    if shift:
        r -= shift * x
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def mean_diagonal(A: sp.csr_matrix) -> float:
    return float(A.diagonal().mean())
