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
from sparsh_amg_tpu_torch.ops.split_rows import choose
from sparsh_amg_tpu_torch.solve import device

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
    torch.testing.assert_close(ell_spmv(E.cols, E.vals, E.lens, x, E.n_rows),
                               ell_plain(E.cols, E.vals, x, E.lens),
                               rtol=0, atol=0)
    assert ell_spmv.launches == before
    with pytest.raises(ValueError):
        ell_spmv(E.cols.long(), E.vals, E.lens, x, E.n_rows)
    with pytest.raises(ValueError):
        ell_spmv(E.cols, E.vals.double(), E.lens, x, E.n_rows)
    with pytest.raises(ValueError):
        ell_spmv(E.cols, E.vals, E.lens.long(), x, E.n_rows)
    with pytest.raises(ValueError):
        ell_spmv(E.cols, E.vals, E.lens[:-1], x, E.n_rows)
    with pytest.raises(ValueError):
        ell_spmv(E.cols, E.vals, E.lens, x, E.n_pad + 1)
    with pytest.raises(ValueError):
        EllMatrix(E.cols, E.vals, E.lens, E.n_rows, E.n_cols).spmv(x[:-1])


def _check_lens(E, want):
    """lens equals `want` on the real rows and 0 on padding rows, and no
    slot past a row's length holds anything."""
    lens = E.lens.numpy()
    assert lens.dtype == np.int32 and lens.shape == (E.n_pad,)
    np.testing.assert_array_equal(lens[: E.n_rows], want)
    assert not lens[E.n_rows:].any()
    past = np.arange(E.k)[:, None] >= lens[None, :]
    assert not E.vals.float().numpy()[past].any()
    assert not E.cols.numpy()[past].any()


@pytest.mark.parametrize("mat", MATRICES)
def test_csr_to_ell_row_lengths(mat):
    """lens from the CSR row pointers, 0 on empty and padding rows."""
    A = MATRICES[mat]()
    E = csr_to_ell(A, device="cpu")
    _check_lens(E, np.diff(A.indptr))
    if mat == "empty rows 9x11":
        assert E.lens.tolist()[:9] == [2, 0, 0, 0, 0, 1, 0, 0, 0]


@pytest.mark.parametrize("mat", MATRICES)
def test_ell_lengths_from_jax_layout(mat):
    """hierarchy_from_jax's decoder sets lens from the JAX EllMatrix (the
    last nonzero slot + 1), equal to the CSR's row lengths here."""
    A = MATRICES[mat]()
    E = device._layout_from_jax(jf.csr_to_ell(A), "cpu")
    _check_lens(E, np.diff(A.indptr))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mat", MATRICES)
def test_plain_with_lens_equals_plain(mat, dt):
    """Stopping each row at its length changes no sum (its padding slots
    hold 0 * x[0])."""
    A = MATRICES[mat]()
    E = csr_to_ell(A, DTYPES[dt][0], device="cpu")
    x = torch.from_numpy(_x(A, A.shape[1]))
    assert torch.equal(ell_plain(E.cols, E.vals, x, E.lens),
                       ell_plain(E.cols, E.vals, x))


# (rows, K) of levels the solves run: the flagship poisson3d(192)'s P0, R0
# and A1 (BENCH_r05.json level sizes), elasticity3d(40)'s fine block
# operator and SA transfers, elasticity2d(512)'s block levels (PERF.md)
FILLS_THE_CARD = {"p3d P0": (7_077_888, 5), "p3d R0": (421_449, 64),
                  "p3d A1": (421_449, 64), "e3d L0 block": (201_720, 27),
                  "e2d L1 block": (90_000, 9), "e2d L2 block": (10_000, 10)}
LONG_ROWS = {"e3d R0": (16_464, 483), "e3d R1": (4_620, 756),
             "e3d R2": (606, 2_970), "e3d L2 block": (4_620, 431)}
# an H100 SXM: 132 SMs of 2,048 resident threads; the kernels' limits of
# 32 lanes and 8 cluster blocks (csrc/split_rows.cuh)
H100 = dict(resident_threads=132 * 2048, max_lanes=32, max_cluster=8)


@pytest.mark.parametrize("case", FILLS_THE_CARD)
def test_launch_shape_keeps_one_thread_per_row(case):
    assert choose(*FILLS_THE_CARD[case], **H100) == (1, 1)


@pytest.mark.parametrize("case", LONG_ROWS)
def test_launch_shape_splits_long_rows(case):
    rows, k = LONG_ROWS[case]
    g, s = choose(rows, k, **H100)
    assert g * s > 1
    assert g in (1, 2, 4, 8, 16, 32) and s in (1, 2, 4, 8)
    assert s == 1 or g == 32                  # lanes fill first
    # the card holds every thread
    assert rows * g * s <= H100["resident_threads"]
    assert k >= 8 * g * s                     # ~8 slots a thread at least
    if case == "e3d R2":
        assert (g, s) == (32, 8)              # 19 row blocks, clustered
