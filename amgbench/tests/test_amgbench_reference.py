"""The plain reference's residual on known solutions."""
from __future__ import annotations

import os

import numpy as np
import pytest
import scipy.sparse as sp
from conftest import ROOT

from amgbench import harness
from amgbench.reference.residual import mean_diagonal, relres


def _poisson(n):
    gen = harness.load_module(os.path.join(ROOT, "amgbench", "gen",
                                           "poisson3d.py"), "g_ref")
    return gen.build({"n": n})[0]


def test_exact_solution_reads_rounding():
    A = _poisson(8)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    assert relres(A, x, A @ x) < 1e-15


def test_known_residual():
    """x = 0 leaves all of b; a solution off by e_0 leaves A e_0."""
    A = _poisson(6)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    assert relres(A, np.zeros_like(b), b) == pytest.approx(1.0)
    x = sp.linalg.spsolve(A.tocsc(), b)
    e = np.zeros_like(b)
    e[0] = 1.0
    want = np.linalg.norm(A @ e) / np.linalg.norm(b)
    assert relres(A, x + e, b) == pytest.approx(want, rel=1e-9)


def test_shift_is_the_shifted_operator():
    A = _poisson(5)
    c = 0.37
    x = np.random.default_rng(2).standard_normal(A.shape[0])
    b = (A + c * sp.identity(A.shape[0])) @ x
    assert relres(A, x, b, c) < 1e-15
    assert relres(A, x, b) > 1e-3
    assert mean_diagonal(A) == 6.0


def test_shape_mismatch_raises():
    A = _poisson(3)
    with pytest.raises(ValueError):
        relres(A, np.zeros(5), np.ones(A.shape[0]))
