"""The port's sliced ELL layout and SpMV (plain version on the CPU) against
the JAX package's ELL-T tables, its classical ELL SpMV and its Pallas GELL
window-gather kernel in interpret mode, row-reduced; the layout's
invariants; and the choosers of lanes per row and of split rows.

The matrices are those of test_gell.py: a square operator, P and R of a
real hierarchy, empty and padded rows, and an irregular random matrix.
The packed tables are compared through ``ell_unpack`` (the ELL-T tables
in the original row order).  Tolerance: rtol 1e-5 with an absolute floor
of 1e-5 * max|reference| (the order of the fp32 sums differs)."""
import dataclasses
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
from sparsh_amg_tpu_torch.ops.ell_spmv import (LANES, VECS, ell_plain,
                                               ell_spmv, ell_unpack)
from sparsh_amg_tpu_torch.ops.formats import (EllMatrix, csr_to_ell,
                                              ell_tables, pack_ell)
from sparsh_amg_tpu_torch.ops.split_rows import choose, choose_lanes
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
    cols, vals, _ = ell_unpack(E, k=J.cols.shape[0])
    np.testing.assert_array_equal(cols.numpy(), np.asarray(J.cols))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(J.vals))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mat", MATRICES)
def test_ell_matches_jax_ell(mat, dt):
    A = MATRICES[mat]()
    tdt, jdt = DTYPES[dt]
    E = csr_to_ell(A, tdt, device="cpu")
    x = _x(A, A.shape[1])
    got = E.spmv(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (E.n_pad,)
    cols, vals, _ = ell_unpack(E)
    J = jf.EllMatrix(jnp.asarray(cols.numpy()),
                     jnp.asarray(vals.float().numpy()).astype(jdt),
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
    E = csr_to_ell(A, device="cpu", sigma=256)
    U = csr_to_ell(A, device="cpu", sigma=1)
    x = torch.from_numpy(_x(A, A.shape[1]))
    before = ell_spmv.launches
    torch.testing.assert_close(ell_spmv(E, x), ell_plain(E, x),
                               rtol=0, atol=0)
    torch.testing.assert_close(ell_spmv(U, x), ell_plain(U, x),
                               rtol=0, atol=0)
    assert ell_spmv.launches == before
    swap = lambda **kw: dataclasses.replace(E, **kw)
    longer = torch.cat([E.lens, E.lens[:32]])
    for bad in (swap(cols=E.cols.long()), swap(vals=E.vals.double()),
                swap(perm=E.perm.long()), swap(lens=longer),
                swap(slice_off=E.slice_off[:-1]), swap(lanes=3),
                swap(vec=8), swap(n_rows=E.n_pad + 1),
                swap(perm=E.perm[:-1]), swap(perm=U.perm),
                dataclasses.replace(U, perm=E.perm)):
        with pytest.raises(ValueError):
            ell_spmv(bad, x)
    with pytest.raises(ValueError):
        ell_spmv(E, x.double())
    with pytest.raises(ValueError):
        E.spmv(x[:-1])


def _check_lens(E, want):
    """The unpacked lengths equal `want` on the real rows and 0 on padding
    rows, and no slot past a row's length holds anything."""
    cols, vals, lens = (t.float().numpy() if t.is_floating_point()
                        else t.numpy() for t in ell_unpack(E))
    assert lens.dtype == np.int32 and lens.shape == (E.n_pad,)
    np.testing.assert_array_equal(lens[: E.n_rows], want)
    assert not lens[E.n_rows:].any()
    assert E.nnz == int(lens.sum()) and E.k == int(lens.max())
    past = np.arange(cols.shape[0])[:, None] >= lens[None, :]
    assert not vals[past].any()
    assert not cols[past].any()


@pytest.mark.parametrize("mat", MATRICES)
def test_csr_to_ell_row_lengths(mat):
    """lens from the CSR row pointers, 0 on empty and padding rows."""
    A = MATRICES[mat]()
    E = csr_to_ell(A, device="cpu")
    _check_lens(E, np.diff(A.indptr))
    if mat == "empty rows 9x11":
        assert ell_unpack(E)[2].tolist()[:9] == [2, 0, 0, 0, 0, 1, 0, 0, 0]


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
    """The padding of the slices changes no sum: the plain version over
    the packed layout (every stored slot) equals each row's sum over its
    real slots of the unpacked tables, in fp64."""
    A = MATRICES[mat]()
    E = csr_to_ell(A, DTYPES[dt][0], device="cpu")
    x = _x(A, A.shape[1])
    cols, vals, lens = ell_unpack(E)
    cols, vals, lens = cols.numpy(), vals.double().numpy(), lens.numpy()
    live = np.arange(cols.shape[0])[:, None] < lens[None, :]
    want = (np.where(live, vals, 0)
            * x.astype(np.float64)[cols]).sum(axis=0)
    _close(ell_plain(E, torch.from_numpy(x)), want)


# every packing of one matrix: lanes per row, slots per load, windows
PACKINGS = [(t, v, s) for t in LANES for v in VECS for s in (32, 256)]


@pytest.mark.parametrize("mat", ["R poisson3d(16)", "random 300x450",
                                 "empty rows 9x11"])
@pytest.mark.parametrize("lanes,vec,sigma", PACKINGS,
                         ids=[f"T{t}V{v}s{s}" for t, v, s in PACKINGS])
def test_packing_invariants_and_product(mat, lanes, vec, sigma):
    """perm is a permutation that sorts rows by descending length within
    windows of sigma rows and moves none across a window; every slice is
    a multiple of T * V slots wide and holds its rows' lengths; slice
    offsets add up; the unpacked tables and the product do not depend on
    the packing."""
    A = MATRICES[mat]()
    E = csr_to_ell(A, device="cpu", lanes=lanes, vec=vec, sigma=sigma)
    assert (E.lanes, E.vec, E.sigma) == (lanes, vec, sigma)
    perm, plen = E.perm.numpy(), E.lens.numpy()
    n_pad, c = E.n_pad, 32 // lanes
    np.testing.assert_array_equal(np.sort(perm), np.arange(n_pad))
    r = np.arange(n_pad)
    np.testing.assert_array_equal(perm // sigma, r // sigma)
    lens = np.zeros(n_pad, np.int64)
    lens[: A.shape[0]] = np.diff(A.indptr)
    np.testing.assert_array_equal(plen, lens[perm])
    same_win = (r[1:] // sigma) == (r[:-1] // sigma)
    assert (plen[1:][same_win] <= plen[:-1][same_win]).all()
    width, off = E.slice_width.numpy(), E.slice_off.numpy()
    assert E.n_slices == -(-n_pad // c)
    assert not (width % (lanes * vec)).any()
    full = np.zeros(E.n_slices * c, np.int64)
    full[:n_pad] = plen
    assert (width >= full.reshape(-1, c).max(axis=1)).all()
    assert (width < full.reshape(-1, c).max(axis=1) + lanes * vec).all()
    np.testing.assert_array_equal(off, np.concatenate(
        [[0], np.cumsum(width * c)[:-1]]))
    assert E.cols.shape[0] == int((width * c).sum())
    # packed rows [0, n_rows) are the real rows, perm the identity past
    # them (the kernels zero y there without reading perm)
    assert (perm[: A.shape[0]] < A.shape[0]).all()
    np.testing.assert_array_equal(perm[A.shape[0]:], r[A.shape[0]:])
    ref = csr_to_ell(A, device="cpu", lanes=1, vec=1)
    for a, b in zip(ell_unpack(E), ell_unpack(ref)):
        assert torch.equal(a, b)
    x = _x(A, A.shape[1])
    _close(E.spmv(torch.from_numpy(x)), ref.spmv(torch.from_numpy(x)))


@pytest.mark.parametrize("min_bytes", [0, None], ids=["any size", "16 MiB"])
@pytest.mark.parametrize("mat", MATRICES)
def test_rows_keep_their_order_where_sorting_saves_nothing(
        mat, min_bytes, monkeypatch):
    """A chosen window falls to 1 (no perm stored, rows in their own
    order) when sorting would save no more slot bytes than perm's 4 bytes
    a row, or the sorted slots fill less than SORT_MIN_BYTES (all of these
    small matrices); either way the product is the same."""
    from sparsh_amg_tpu_torch.ops import formats
    if min_bytes is not None:
        monkeypatch.setattr(formats, "SORT_MIN_BYTES", min_bytes)
    A = MATRICES[mat]()
    E = csr_to_ell(A, device="cpu")
    T, V, sigma = choose_lanes(A.shape[0], E.k, E.nnz / A.shape[0])
    S = csr_to_ell(A, device="cpu", sigma=sigma)
    U = csr_to_ell(A, device="cpu", sigma=1)
    assert (E.lanes, E.vec) == (S.lanes, S.vec) == (U.lanes, U.vec) == (T, V)
    assert U.perm.numel() == 0
    assert S.perm.numel() == (S.n_pad if sigma > 1 else 0)
    saved = (U.cols.numel() - S.cols.numel()) * 8
    sort = saved > 4 * E.n_pad and S.cols.numel() * 8 >= \
        formats.SORT_MIN_BYTES
    assert E.sigma == (sigma if sort else 1)
    assert E.perm.numel() == (E.n_pad if E.sigma > 1 else 0)
    x = torch.from_numpy(_x(A, A.shape[1]))
    _close(E.spmv(x), U.spmv(x))
    _close(E.spmv(x), S.spmv(x))


@pytest.mark.parametrize("mat", ["R poisson3d(16)", "empty rows 9x11"])
@pytest.mark.parametrize("lanes,vec,sigma", [(None, None, None), (1, 1, 1),
                                             (4, 4, 64), (32, 1, 256)])
def test_native_packing_equals_numpy(mat, lanes, vec, sigma, monkeypatch):
    """The native window sort and slot fill give the numpy path's tables,
    fp32 and fp64."""
    from sparsh_amg_tpu_torch.ops import formats
    A = MATRICES[mat]()
    cols, vals, lens = ell_tables(A, 128, vals_dtype=np.float64)
    kw = dict(lanes=lanes, vec=vec, sigma=sigma, fill=3, device="cpu")
    for dt in (torch.float32, torch.float64):
        native = pack_ell(cols, vals, lens, *A.shape, dt, **kw)
        with monkeypatch.context() as m:
            m.setattr(formats, "get_lib", lambda: None)
            plain = pack_ell(cols, vals, lens, *A.shape, dt, **kw)
        for f in dataclasses.fields(EllMatrix):
            a, b = getattr(native, f.name), getattr(plain, f.name)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), f.name
            else:
                assert a == b, f.name


def test_one_packing_function_builds_every_ell_layout():
    """csr_to_ell, the fp64 operator (its values cast to fp32: hi of the
    df64 split) and the decoded JAX layout are pack_ell of the same ELL-T
    tables."""
    from sparsh_amg_tpu_torch.ops.fp64 import csr_to_fp64
    A = MATRICES["P poisson3d(16)"]()
    cols, vals, lens = ell_tables(A, 128)
    E = pack_ell(cols, vals, lens, *A.shape, device="cpu")
    for other in (csr_to_ell(A, device="cpu"),
                  csr_to_fp64(A, pad_multiple=128,
                              device="cpu").astype(torch.float32),
                  device._layout_from_jax(jf.csr_to_ell(A), "cpu")):
        assert isinstance(other, EllMatrix)
        for a, b in zip(ell_unpack(E), ell_unpack(other)):
            np.testing.assert_array_equal(a.double().numpy(),
                                          b.double().numpy())


# (rows, K) of levels the solves run: the flagship poisson3d(192)'s P0, R0
# and A1, elasticity3d(40)'s fine block operator and SA transfers,
# elasticity2d(512)'s block levels (PERF.md)
FILLS_THE_CARD = {"p3d P0": (7_077_888, 5), "p3d R0": (421_449, 113),
                  "p3d A1": (421_449, 34), "e3d L0 block": (201_720, 27),
                  "e2d L1 block": (90_000, 9), "e2d L2 block": (10_000, 10)}
LONG_ROWS = {"e3d R0": (16_464, 483), "e3d R1": (4_620, 756),
             "e3d R2": (606, 2_970), "e3d L2 block": (4_620, 431)}
# an H100 SXM: 132 SMs of 2,048 resident threads; the kernels' limits of
# 32 lanes and 8 cluster blocks (csrc/split_rows.cuh)
H100 = dict(resident_threads=132 * 2048, max_lanes=32, max_cluster=8)
# (rows, K, mean row) of the ELL operators of the solves (the frozen
# hierarchies' row lengths) and the (T, V, sigma) their packing takes
LANE_CASES = {
    "delaunay A0": ((1_048_576, 21, 7.0), (1, 1, 4096)),
    "p3d P0": ((7_077_888, 5, 4.0), (1, 1, 4096)),
    "p3d R0": ((421_449, 113, 66.6), (4, 4, 64)),
    "p3d A1": ((421_449, 34, 22.4), (1, 4, 256)),
    "p3d R1": ((50_548, 58, 30.3), (1, 1, 1)),
    "c3d R0": ((274_808, 23, 9.9), (1, 1, 256)),
    "e3d R0": ((16_464, 483, 390.9), (1, 1, 1)),
    "e3d R2": ((606, 2_970, 1_700.8), (1, 1, 1)),
}


@pytest.mark.parametrize("case", FILLS_THE_CARD)
def test_launch_shape_keeps_one_thread_per_row(case):
    """Rows that fill the card alone are not split over lanes and
    clusters; the flagship's R0 and A1 take T lanes a row from the lanes
    chooser instead (4 and 1)."""
    rows, k = FILLS_THE_CARD[case]
    assert choose(rows, k, **H100) == (1, 1)
    if case in LANE_CASES:
        assert choose_lanes(*LANE_CASES[case][0])[0] == \
            LANE_CASES[case][1][0]


@pytest.mark.parametrize("case", LANE_CASES)
def test_choose_lanes(case):
    """T lanes a row while each keeps 32 slots of a mean row (rows of
    tens of slots: T = 4 on R0), V = 4 where each keeps 16, sigma = 256 /
    T or 4096 for rows under 8 slots; rows the split-row launch takes
    (few and long, and R1's 50,548) keep (1, 1, 1), unsorted."""
    shape, want = LANE_CASES[case]
    assert choose_lanes(*shape) == want
    t, v, sigma = want
    assert t in LANES and v in VECS and 1 <= sigma * t <= 4096
    split = choose(*shape[:2], **H100) != (1, 1)
    assert split == (case in ("p3d R1", "e3d R0", "e3d R2"))
    assert not split or (t, v, sigma) == (1, 1, 1)


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
