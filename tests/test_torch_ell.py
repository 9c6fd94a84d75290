"""The port's ELL-T SpMV (plain version on the CPU) against the JAX
package's classical ELL SpMV and its Pallas GELL window-gather kernel in
interpret mode, row-reduced.

The matrices are those of test_gell.py: a square operator, P and R of a
real hierarchy, empty and padded rows, and an irregular random matrix.
Tolerance: rtol 1e-5 with an absolute floor of 1e-5 * max|reference| (the
order of the fp32 sums differs)."""
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch

from sparsh_amg_tpu.models.poisson import poisson2d, poisson3d
from sparsh_amg_tpu.ops import formats as jf
from sparsh_amg_tpu.ops.gell import csr_to_gell, gell_gather_pallas
from sparsh_amg_tpu.params import AMGParams
from sparsh_amg_tpu.setup.hierarchy import amg_setup
from sparsh_amg_tpu_torch.ops.ell_spmv import ell_plain, ell_spmv
from sparsh_amg_tpu_torch.ops.formats import EllMatrix, csr_to_ell

RTOL = 1e-5


@functools.lru_cache(maxsize=1)
def _transfers():
    hier = amg_setup(poisson3d(16), AMGParams(
        coarsening="pmis", interpolation="extpi", interp_max=4))
    return hier.levels[0].P.tocsr(), hier.levels[0].R.tocsr()


MATRICES = {
    "square poisson2d(40)": lambda: poisson2d(40).tocsr(),
    "P poisson3d(16)": lambda: _transfers()[0],
    "R poisson3d(16)": lambda: _transfers()[1],
    "empty rows 9x11": lambda: sp.csr_matrix(
        (np.array([2.0, 3.0, 4.0]),
         (np.array([0, 0, 5]), np.array([1, 7, 3]))), shape=(9, 11)),
    "random 300x450": lambda: sp.random(300, 450, density=0.02,
                                        random_state=4, format="csr"),
}
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


def _x(A, length, seed=0):
    x = np.zeros(length, np.float32)
    x[: A.shape[1]] = np.random.default_rng(seed).standard_normal(A.shape[1])
    return x


@pytest.mark.parametrize("mat", MATRICES)
def test_csr_to_ell_matches_jax(mat):
    A = MATRICES[mat]()
    E = csr_to_ell(A, device="cpu")
    J = jf.csr_to_ell(A)
    np.testing.assert_array_equal(E.cols.numpy(), np.asarray(J.cols))
    np.testing.assert_array_equal(E.vals.numpy(), np.asarray(J.vals))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mat", MATRICES)
def test_ell_matches_jax_ell(mat, dt):
    A = MATRICES[mat]()
    tdt, jdt = DTYPES[dt]
    E = csr_to_ell(A, tdt, device="cpu")
    x = _x(A, A.shape[1])
    got = E.spmv(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (E.n_pad,)
    J = jf.EllMatrix(jnp.asarray(E.cols.numpy()),
                     jnp.asarray(E.vals.float().numpy()).astype(jdt),
                     E.n_rows, E.n_cols)
    _close(got, J.spmv(jnp.asarray(x)))
    if dt == "fp32":
        _close(got[: A.shape[0]], A @ x.astype(np.float64))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mat", [m for m in MATRICES if m != "random 300x450"])
def test_ell_matches_gell_pallas(mat, dt):
    """The TPU kernel's gather, reduced per row, gives the port's y."""
    A = MATRICES[mat]()
    tdt, jdt = DTYPES[dt]
    G = csr_to_gell(A, dtype=jdt)
    assert G is not None
    stream = gell_gather_pallas(G.wwords, G.counts, G.packed, G.vals,
                                jnp.asarray(_x(A, G.src_pad)), s=G.s,
                                tr=G.tr, wmode=G.wmode, interpret=True)
    want = np.asarray(stream).reshape(G.stream_rows, G.k).sum(axis=1)
    E = csr_to_ell(A, tdt, device="cpu")
    got = E.spmv(torch.from_numpy(_x(A, A.shape[1])))
    n = A.shape[0]
    _close(got[:n], want[:n])


def test_ell_wrapper_on_cpu_counts_nothing_and_checks():
    A = MATRICES["R poisson3d(16)"]()
    E = csr_to_ell(A, device="cpu")
    x = torch.from_numpy(_x(A, A.shape[1]))
    before = ell_spmv.launches
    torch.testing.assert_close(ell_spmv(E.cols, E.vals, x),
                               ell_plain(E.cols, E.vals, x), rtol=0, atol=0)
    assert ell_spmv.launches == before
    with pytest.raises(ValueError):
        ell_spmv(E.cols.long(), E.vals, x)
    with pytest.raises(ValueError):
        ell_spmv(E.cols, E.vals.double(), x)
    with pytest.raises(ValueError):
        EllMatrix(E.cols, E.vals, E.n_rows, E.n_cols).spmv(x[:-1])
