"""The systems (linear elasticity) configurations of
``scripts/run_configs_tpu.py`` (lines 79-90): smoothed aggregation with a
rigid-body near-nullspace and node-blocked aggregation, unfiltered
prolongator smoothing, Chebyshev V-cycle, CG to 1e-8 with iterative
refinement, fp32 matrix data.

* ``elasticity2d(512)``: 525,312 unknowns, 2 dofs per node, 3 rigid-body
  modes;
* ``elasticity3d(40)``: 201,720 unknowns (hex Q1, 81-entry rows), 3 dofs
  per node, 6 rigid-body modes.

``REFERENCE`` holds the JAX package's counts for these runs: a priming
solve at tol 1e-2, then a solve to 1e-8 (``run_configs_tpu.py:167-168``).
The CPU counts are the ones to match; the TPU's (``CONFIGS_r5.json``)
differ by numerics, not by algorithm, and are context only.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .models.elasticity import (elasticity2d, elasticity2d_nullspace,
                                elasticity3d, elasticity3d_nullspace)
from .params import AMGParams, KrylovParams

SIZES = {2: 512, 3: 40}

REFERENCE = {
    "elasticity3d(40)": {"n": 201_720, "nnz": 12_689_145,
                         "cpu": {"iterations": 15, "refine_passes": 2,
                                 "relres": 4.90e-10},
                         "tpu": {"iterations": 16, "refine_passes": 2}},
    "elasticity2d(512)": {"n": 525_312, "nnz": 8_382_460,
                          "cpu": {"iterations": 36, "refine_passes": 4,
                                  "relres": 1.36e-9},
                          "tpu": {"iterations": 39, "refine_passes": 4}},
}


def problem(dim: int, m: int | None = None):
    """(A, near-nullspace) of elasticity{dim}d(m), m defaulting to the
    configuration's size."""
    m = SIZES[dim] if m is None else m
    if dim == 2:
        return elasticity2d(m), elasticity2d_nullspace(m)
    return elasticity3d(m), elasticity3d_nullspace(m)


def random_blocks(nb: int, bs: int, seed: int, density: float = 0.02):
    """A random symmetric-pattern matrix of nb x nb blocks of bs x bs, with
    about 30% of the entries inside each block missing: the block kernel's
    check case for holes that the node pattern fills with zeros."""
    rng = np.random.default_rng(seed)
    P = sp.random(nb, nb, density=density, random_state=seed) > 0
    P = (P + P.T + sp.eye(nb)).tocsr()
    A = sp.kron(P, np.ones((bs, bs))).tocsr()
    A.data = rng.standard_normal(A.nnz) * (rng.random(A.nnz) > 0.3)
    A.eliminate_zeros()
    return A


def random_long_rows(rows: int, cols: int, max_len: int, seed: int,
                     bs: int = 1):
    """A random matrix of rows x cols entries (bs x bs dense blocks where
    bs > 1) whose rows hold 0 to max_len entries (blocks) each at distinct
    columns, lengths uniform, one row at max_len: the check case of the
    split-row launch, with empty rows and rows far shorter than K."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, rows)
    lens[rng.integers(rows)] = max_len
    indices = np.concatenate(
        [np.sort(rng.permutation(cols)[:n]) for n in lens]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    P = sp.csr_matrix((np.ones(indices.size), indices, indptr),
                      shape=(rows, cols))
    A = sp.kron(P, np.ones((bs, bs))).tocsr() if bs > 1 else P
    A.data = rng.standard_normal(A.nnz)
    return A


def params(dim: int, dense_size: int = 2048) -> AMGParams:
    """Smoothed aggregation on dim-dof nodes (agg_blocksize = dim)."""
    return AMGParams(coarsening="aggregation", interpolation="smoothed",
                     smoother="chebyshev", coarse_size=200,
                     agg_blocksize=dim, p_smooth_filter=False,
                     dense_size=dense_size)


def krylov(tol: float = 1e-8) -> KrylovParams:
    """PCG; REFERENCE's counts were taken in the JAX package's device loop
    mode, the port's one placement."""
    return KrylovParams(method="cg", tol=tol, maxiter=300)
