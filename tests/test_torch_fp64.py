"""The port's fp64 refinement operator and BLAS-1 against the JAX
package's df64 operator (``residual_df64``) and df64 dot.

The port's fp64 entries are exactly the JAX pair's hi + lo, so the two
residuals agree to df64 accuracy: 1e-12 of ||b||."""
import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch

from sparsh_amg_tpu.models.poisson import poisson2d, poisson3d
from sparsh_amg_tpu.ops import df64
from sparsh_amg_tpu.ops.df64_ops import csr_to_df64, residual_df64
from sparsh_amg_tpu_torch.ops import blas
from sparsh_amg_tpu_torch.ops.formats import DiaMatrix, EllMatrix
from sparsh_amg_tpu_torch.ops.fp64 import csr_to_fp64, residual64, to_fp32


def _inexact(A):
    A = A.tocsr().copy()
    A.data = A.data * np.pi / 3          # entries not exact in fp32
    return A


def _irregular(n=500, seed=5):
    """Square, symmetric, too many diagonals for DIA: the ELL branch."""
    M = sp.random(n, n, density=0.01, random_state=seed, format="csr")
    M = M + M.T
    return (M + sp.diags(np.asarray(abs(M).sum(axis=1)).ravel() + 1.0)
            ).tocsr()


MATRICES = {"poisson2d(24) exact": lambda: poisson2d(24).tocsr(),
            "poisson3d(7) inexact": lambda: _inexact(poisson3d(7)),
            "irregular 500 (ELL)": _irregular}


@pytest.mark.parametrize("mat", MATRICES)
@pytest.mark.parametrize("rhs", ["consistent", "random"])
def test_residual64_matches_residual_df64(mat, rhs):
    A = MATRICES[mat]()
    n = A.shape[0]
    rng = np.random.default_rng(2)
    x64 = rng.standard_normal(n)
    b64 = A @ x64 if rhs == "consistent" else rng.standard_normal(n)
    A64 = csr_to_fp64(A, device="cpu")
    Adf = csr_to_df64(A)
    assert isinstance(A64, DiaMatrix) == (mat != "irregular 500 (ELL)")
    n_pad = A64.n_pad
    assert n_pad == Adf.A_hi.n_pad
    xp, bp = np.pad(x64, (0, n_pad - n)), np.pad(b64, (0, n_pad - n))
    r = residual64(A64, torch.from_numpy(bp), torch.from_numpy(xp)).numpy()
    xh, xl = df64.from_f64_np(xp)
    bh, bl = df64.from_f64_np(bp)
    rh, rl = residual_df64(Adf, jnp.asarray(bh), jnp.asarray(bl),
                           jnp.asarray(xh), jnp.asarray(xl))
    want = df64.to_f64_np(np.asarray(rh), np.asarray(rl))
    assert np.abs(r - want).max() <= 1e-12 * np.linalg.norm(b64)
    # and the port's residual is the fp64 residual of the hi+lo entries
    assert np.abs(r[:n] - (b64 - A @ x64)).max() <= \
        1e-12 * np.linalg.norm(b64)


@pytest.mark.parametrize("mat", MATRICES)
def test_fp64_entries_are_df64_hi_plus_lo(mat):
    A = MATRICES[mat]()
    A64 = csr_to_fp64(A, device="cpu")
    Adf = csr_to_df64(A)
    if isinstance(A64, DiaMatrix):
        assert A64.offsets == Adf.A_hi.offsets
        hi, got = np.asarray(Adf.A_hi.bands, np.float64), A64.bands.numpy()
    else:
        assert isinstance(A64, EllMatrix)
        np.testing.assert_array_equal(A64.cols.numpy(),
                                      np.asarray(Adf.A_hi.cols))
        hi, got = np.asarray(Adf.A_hi.vals, np.float64), A64.vals.numpy()
    lo = 0.0 if Adf.lo is None else np.asarray(Adf.lo, np.float64)
    np.testing.assert_array_equal(got, hi + lo)
    # the fp32 Krylov operator is the JAX A_hi, cast on the device
    A32 = to_fp32(A64)
    got32 = A32.bands if isinstance(A32, DiaMatrix) else A32.vals
    np.testing.assert_array_equal(got32.numpy(), hi.astype(np.float32))


def test_dot_compensated_and_plain():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(10_000).astype(np.float32)
    y = rng.standard_normal(10_000).astype(np.float32)
    want = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    hi, lo = df64.dot(jnp.asarray(x), jnp.asarray(y))
    got = blas.dot(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32
    # fp64 accumulation, then one rounding to fp32, like df64 hi + lo
    assert abs(got.item() - want) <= 1e-7 * abs(want)
    assert got.item() == float(np.float32(float(hi) + float(lo)))
    plain = blas.dot(torch.from_numpy(x), torch.from_numpy(y),
                     compensated=False).item()
    np.testing.assert_allclose(plain, float(jnp.dot(x, y)), rtol=1e-5)
    assert blas.norm_sq(torch.from_numpy(x)).item() == pytest.approx(
        float(np.dot(x.astype(np.float64), x)), rel=1e-7)
