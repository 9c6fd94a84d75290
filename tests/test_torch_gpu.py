"""CUDA kernels of the port against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one; on the GPU machine
(no jax there, and tests/conftest.py imports it) run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

This file imports no jax.  chip_smoke.py runs the same comparisons at the
flagship's shapes."""
import copy

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _vec(rng, n, dev):
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dia_kernel_tails_match_plain(cuda, dtype):
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    from sparsh_amg_tpu_torch.ops.formats import csr_to_dia
    D = csr_to_dia(poisson3d(20), dtype, 2048, device=cuda)
    rng = np.random.default_rng(0)
    x, b, d, r = (_vec(rng, D.n_pad, cuda) for _ in range(4))
    dinv = torch.full((D.n_pad,), 1 / 6, device=cuda)
    bands, offs = D.bands, D.offsets
    before = K.dia_cheb_step.launches
    pairs = [
        (K.dia_spmv(bands, x, offs), K.dia_fused_plain(K.SPMV, bands, offs, x)),
        (K.dia_residual(bands, x, b, offs),
         K.dia_fused_plain(K.RESIDUAL, bands, offs, x, b=b)),
        (K.dia_jacobi_sweep(bands, x, b, dinv, 0.7, offs),
         K.dia_fused_plain(K.JACOBI, bands, offs, x, b=b, dinv=dinv, x=x,
                           s0=0.7)),
    ]
    got3 = K.dia_cheb_step(bands, x, d, r, dinv, 0.3, 0.9, offs)
    want3 = K.dia_fused_plain(K.CHEB, bands, offs, d, b=r, dinv=dinv, x=x,
                              s0=0.3, s1=0.9)
    pairs += list(zip(got3, want3))
    pairs += list(zip(K.dia_cheb_start(bands, x, b, dinv, 1.7, offs),
                      K.dia_fused_plain(K.CHEB_START, bands, offs, x, b=b,
                                        dinv=dinv, s0=1.7)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert _rel(got, want) <= 1e-5
    assert K.dia_cheb_step.launches == before + 1


# offset sets: 3-D Poisson at 192^3 (+-1, +-192 inside the staged halo,
# +-36864 beyond it), 2-D elasticity's fine level at 512^2 and at 32^2 (21
# bands, none but 0 and +-1024 a multiple of 4), wide bands (some beyond
# the halo, not multiples of 8), one band, and the most the kernel takes
# (32, near and far, both signs)
DIA_OFFSETS = {
    "p3d": (-36864, -192, -1, 0, 1, 192, 36864),
    "e2d": (*range(-1027, -1020), *range(-3, 4), *range(1021, 1028)),
    "e2d(32)": (*range(-67, -60), *range(-3, 4), *range(61, 68)),
    "wide": (-300, -129, -127, -5, 0, 3, 127, 128, 301),
    "one": (5,),
    "32": (-4099, -2050, -1024, -513, -300, -257, -256, -255, -129, -64,
           -12, -8, -7, -3, -2, -1, 0, 1, 2, 3, 7, 8, 12, 64, 129, 255,
           256, 257, 300, 513, 1024, 2050),
}
# n_pad in tiles of the kernel (128 threads x 16 bytes of band each):
# 128 rows, exactly one tile, one tile + 128, three tiles + 640
DIA_NPAD = {"128": (0, 128), "tile": (1, 0), "tile+128": (1, 128),
            "3tiles+640": (3, 640)}
# the Chebyshev start, step and last tails; a trailing 0: the zero start
# (x not read; the start without a product)
DIA_TAILS = ("spmv", "residual", "jacobi", "cheb",
             "cheb_start", "cheb_start0", "cheb0", "cheb_last", "cheb_last0")


@pytest.mark.parametrize("tail", DIA_TAILS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("npad", DIA_NPAD)
@pytest.mark.parametrize("offs", DIA_OFFSETS)
def test_dia_kernel_shapes(cuda, offs, npad, dtype, tail):
    """Every instantiation (compiled band counts and the run-time one),
    near and far offsets, whole and partial tiles: within 1e-5 of the
    plain version (random bands, nonzero where a column leaves the
    matrix), and a second launch gives the same bits."""
    tiles, extra = DIA_NPAD[npad]
    n = tiles * 128 * 16 // torch.tensor([], dtype=dtype).element_size() \
        + extra
    _dia_case(cuda, DIA_OFFSETS[offs], n, dtype, tail)


# the strict triangles of two-stage Gauss-Seidel (one-sided offsets: the
# staged halo is symmetric, so half of it goes unread) and the 5- and
# 9-band 2-D stencils, at 1024^2's offsets
ONE_SIDED = {
    "-1": (-1,),
    "+1": (1,),
    "tril 9-band": (-1025, -1024, -1023, -1),
    "triu 9-band": (1, 1023, 1024, 1025),
    "tril 5-band": (-1024, -1),
    "5-band": (-1024, -1, 0, 1, 1024),
    "9-band": (-1025, -1024, -1023, -1, 0, 1, 1023, 1024, 1025),
}


@pytest.mark.parametrize("tail", DIA_TAILS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2176, 12928])
@pytest.mark.parametrize("offs", ONE_SIDED)
def test_dia_kernel_one_sided_and_2d_stencils(cuda, offs, n, dtype, tail):
    _dia_case(cuda, ONE_SIDED[offs], n, dtype, tail)


def _dia_case(cuda, offsets, n, dtype, tail):
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    rng = np.random.default_rng(len(offsets) * 1000 + n)
    bands = torch.from_numpy(rng.standard_normal(
        (len(offsets), n)).astype(np.float32)).to(cuda, dtype)
    x, b, d, r = (_vec(rng, n, cuda) for _ in range(4))
    dinv = torch.from_numpy(rng.uniform(0.1, 0.2, n).astype(
        np.float32)).to(cuda)
    run, want = {
        "spmv": (lambda: K.dia_spmv(bands, x, offsets),
                 lambda: K.dia_fused_plain(K.SPMV, bands, offsets, x)),
        "residual": (lambda: K.dia_residual(bands, x, b, offsets),
                     lambda: K.dia_fused_plain(K.RESIDUAL, bands, offsets,
                                               x, b=b)),
        "jacobi": (
            lambda: K.dia_jacobi_sweep(bands, x, b, dinv, 0.7, offsets),
            lambda: K.dia_fused_plain(K.JACOBI, bands, offsets, x, b=b,
                                      dinv=dinv, x=x, s0=0.7)),
        "cheb": (
            lambda: K.dia_cheb_step(bands, x, d, r, dinv, 0.3, 0.9, offsets),
            lambda: K.dia_fused_plain(K.CHEB, bands, offsets, d, b=r,
                                      dinv=dinv, x=x, s0=0.3, s1=0.9)),
        "cheb_start": (
            lambda: K.dia_cheb_start(bands, x, b, dinv, 1.7, offsets),
            lambda: K.dia_fused_plain(K.CHEB_START, bands, offsets, x, b=b,
                                      dinv=dinv, s0=1.7)),
        "cheb_start0": (
            lambda: K.dia_cheb_start(bands, None, b, dinv, 1.7, offsets),
            lambda: K.dia_fused_plain(K.CHEB_START, bands, offsets, None,
                                      b=b, dinv=dinv, s0=1.7)),
        "cheb0": (
            lambda: K.dia_cheb_step(bands, None, d, r, dinv, 0.3, 0.9,
                                    offsets),
            lambda: K.dia_fused_plain(K.CHEB, bands, offsets, d, b=r,
                                      dinv=dinv, s0=0.3, s1=0.9)),
        "cheb_last": (
            lambda: K.dia_cheb_last(bands, x, d, r, dinv, 0.3, 0.9, offsets),
            lambda: K.dia_fused_plain(K.CHEB_LAST, bands, offsets, d, b=r,
                                      dinv=dinv, x=x, s0=0.3, s1=0.9)),
        "cheb_last0": (
            lambda: K.dia_cheb_last(bands, None, d, r, dinv, 0.3, 0.9,
                                    offsets),
            lambda: K.dia_fused_plain(K.CHEB_LAST, bands, offsets, d, b=r,
                                      dinv=dinv, s0=0.3, s1=0.9)),
    }[tail]
    got, again, ref = run(), run(), want()
    torch.cuda.synchronize()
    got, again, ref = ((t,) if torch.is_tensor(t) else t
                       for t in (got, again, ref))
    for g, a, w in zip(got, again, ref):
        assert _rel(g, w) <= 1e-5
        assert torch.equal(g, a)


def test_dia_instantiations_and_alignment(cuda):
    """The compiled band counts (7 both dtypes, 21 fp32) and the staged
    halos (3-D Poisson's near offsets, 2-D elasticity's all, a lone band's
    rounded up to 4), and a misaligned vector refused."""
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    got = {(dt, name): K.instantiation(torch.zeros(len(offs), 128, dtype=dt),
                                       offs)
           for dt in (torch.float32, torch.bfloat16)
           for name, offs in DIA_OFFSETS.items()}
    f32, b16 = torch.float32, torch.bfloat16
    assert got == {(f32, "p3d"): "NB=7 halo=192",
                   (f32, "e2d"): "NB=21 halo=1028",
                   (f32, "e2d(32)"): "NB=21 halo=68",
                   (f32, "wide"): "runtime halo=304",
                   (f32, "one"): "runtime halo=8",
                   (f32, "32"): "runtime halo=1024",
                   (b16, "p3d"): "NB=7 halo=192",
                   (b16, "e2d"): "runtime halo=1028",
                   (b16, "e2d(32)"): "runtime halo=68",
                   (b16, "wide"): "runtime halo=304",
                   (b16, "one"): "runtime halo=8",
                   (b16, "32"): "runtime halo=1024"}
    bands = torch.ones(1, 128, device=cuda)
    v = torch.ones(129, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        K.dia_spmv(bands, v, (0,))


# the DIA tables a Chebyshev smooth runs on: 3-D Poisson (7 bands, both
# band types) and 2-D elasticity (21 bands), at a few tiles
CHEB_TABLES = {"p3d-bf16": ("poisson3d", 40, torch.bfloat16),
               "p3d-fp32": ("poisson3d", 40, torch.float32),
               "e2d21-fp32": ("elasticity2d", 96, torch.float32)}


@pytest.mark.parametrize("zero_start", [False, True], ids=["x", "zero"])
@pytest.mark.parametrize("degree", [1, 2, 3, 4])
@pytest.mark.parametrize("table", CHEB_TABLES)
def test_cheb_smooth_has_the_parent_composition_bits(cuda, table, degree,
                                                     zero_start):
    """smoothers.chebyshev on a DiaMatrix on the card (start tail, steps,
    last tail) gives the bits of the composition it replaces, run on the
    same card from the older tails and plain adds."""
    from test_torch_cheb_tails import _parent_chebyshev
    from sparsh_amg_tpu_torch import models
    from sparsh_amg_tpu_torch.ops.formats import csr_to_dia
    from sparsh_amg_tpu_torch.solve import smoothers
    from sparsh_amg_tpu_torch.solve.device import DeviceLevel
    name, m, dtype = CHEB_TABLES[table]
    D = csr_to_dia(getattr(models, name)(m).tocsr(), dtype, device=cuda)
    rng = np.random.default_rng(degree)
    x, b = (_vec(rng, D.n_pad, cuda) for _ in range(2))
    dinv = torch.from_numpy(rng.uniform(0.1, 0.2, D.n_pad).astype(
        np.float32)).to(cuda)
    lev = DeviceLevel(A=D, dinv=dinv, l1_dinv=dinv, lam_max=1.93, P=None,
                      R=None, coarse_inv=None)
    got = smoothers.chebyshev(lev, b, None if zero_start else x, degree,
                              1 / 30, zero_start=zero_start)
    want = _parent_chebyshev(lev, b, x, degree, 1 / 30, zero_start)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_captured_step_smooths_through_kernel_launches(cuda, monkeypatch):
    """The flagship recipe's captured Krylov step (one V-cycle): each
    smooth of a DIA level is one start tail, one step and one last tail
    a replay, and the step graph holds 6 kernels fewer a DIA level visit
    than the same step captured with the composition the smoother ran
    before (a zero made, dinv * b, r / theta, x + d twice; 5 kernels),
    rebuilt here with the fused residual and a plain product where the
    parent's DINV_RESIDUAL tail was one launch (1 more)."""
    from test_torch_cheb_tails import _parent_chebyshev
    from sparsh_amg_tpu_torch.ops.formats import FusedDia
    from sparsh_amg_tpu_torch.solve import smoothers

    def step_of_a_warm_solver():
        _, _, s, _ = _flagship_small(cuda)
        s.warm()
        levels = s.device.levels
        fused = sum(isinstance(lv.A, FusedDia) for lv in levels[:-1])
        step = s._loop().step
        per = {w.__name__: n for w, n in step.per_replay.items()}
        kinds = step.node_kinds()
        s.release_graphs()
        return per, kinds, fused

    per, kinds, fused = step_of_a_warm_solver()
    assert fused >= 1
    assert per["dia_cheb_start"] == per["dia_cheb_last"] == 2 * fused
    assert per["dia_cheb_step"] == 2 * fused          # degree 3
    real = smoothers.chebyshev
    monkeypatch.setattr(
        smoothers, "chebyshev",
        lambda lev, b, x, *a, **k: (_parent_chebyshev if isinstance(
            lev.A, FusedDia) else real)(lev, b, x, *a, **k))
    per0, kinds0, fused0 = step_of_a_warm_solver()
    assert fused0 == fused and "dia_cheb_start" not in per0
    assert per0["dia_cheb_step"] == 4 * fused
    assert kinds0["kernel"] - kinds["kernel"] == 6 * fused


# the fp64 pass finish (csrc/dia_finish64.cu): 2-D 5- and 9-point
# stencils at 1024^2, 3-D Poisson at 192^3 (its +-n^2 planes beyond the
# staged halo), 2-D elasticity's fine level at 512^2 (+-1027 inside it),
# 32 bands near and far, a lone odd offset
FINISH_OFFSETS = {
    "5 p2d": (-1024, -1, 0, 1, 1024),
    "7 p3d": (-36864, -192, -1, 0, 1, 192, 36864),
    "9 aniso": (-1025, -1024, -1023, -1, 0, 1, 1023, 1024, 1025),
    "21 e2d": (*range(-1027, -1020), *range(-3, 4), *range(1021, 1028)),
    "32": DIA_OFFSETS["32"],
    "one odd": (5,),
}
# n_pad in the kernel's tiles of 512 rows: 2 rows, one tile, a tile and
# 2 rows, 25 tiles and 6 rows, 160 tiles (the p3d planes inside)
FINISH_NPAD = (2, 512, 514, 12_806, 81_920)


def _finish_inputs(cuda, offsets, n, seed=0):
    from sparsh_amg_tpu_torch.ops.formats import DiaMatrix
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((len(offsets), n)) * np.pi
    rows = np.arange(n)
    for k, off in enumerate(offsets):
        bands[k, (rows + off < 0) | (rows + off >= n)] = 0.0
    A64 = DiaMatrix(bands=torch.from_numpy(bands).to(cuda),
                    offsets=tuple(offsets), n_rows=n, n_cols=n)
    x64, b64 = (torch.from_numpy(rng.standard_normal(n)).to(cuda)
                for _ in range(2))
    d = torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                         * 1e-3).to(cuda)
    return A64, x64, d, b64


def _finish_kernel(A64, x64, d, b64):
    """(x, b, rr) of one kernel finish on a copy of x64."""
    from sparsh_amg_tpu_torch.ops.fp64 import dia_finish64
    x = x64.clone()
    b = torch.full((A64.n_pad,), float("nan"), device=x64.device)
    rr = torch.full((1,), float("nan"), dtype=torch.float64,
                    device=x64.device)
    return dia_finish64(A64, x, d, b64, b, rr)


def _assert_finish(got, want):
    x, b, rr = got
    px, pr, prr = want
    assert torch.equal(x, px)
    assert torch.equal(b, pr.float())
    assert abs(rr.item() - prr.item()) <= 1e-13 * prr.item()


@pytest.mark.parametrize("n", FINISH_NPAD)
@pytest.mark.parametrize("offs", FINISH_OFFSETS)
def test_finish_kernel_matches_plain(cuda, offs, n):
    """x64 and the fp32 right-hand side with finish64_plain's bits on the
    card, ||r||^2 within 1e-13 relative (its own order of sums), two
    launches with the same bits, each counted twice (update, residual)."""
    from sparsh_amg_tpu_torch.ops.fp64 import dia_finish64, finish64_plain
    A64, x64, d, b64 = _finish_inputs(cuda, FINISH_OFFSETS[offs], n)
    want = finish64_plain(A64, x64, d, b64, torch.dot)
    before = dia_finish64.launches
    got, again = (_finish_kernel(A64, x64, d, b64) for _ in range(2))
    torch.cuda.synchronize()
    assert dia_finish64.launches == before + 4
    _assert_finish(got, want)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_finish_kernel_captured_matches_eager(cuda):
    """The finish captured in a CUDA graph gives the eager launch's bits,
    replay after replay (the reduction's ticket reset by the update
    launch), and the halos it stages; misaligned vectors refused."""
    from sparsh_amg_tpu_torch.ops.fp64 import dia_finish64, finish_halo
    A64, x64, d, b64 = _finish_inputs(cuda, FINISH_OFFSETS["7 p3d"],
                                      81_920, seed=3)
    eager = _finish_kernel(A64, x64, d, b64)
    x = x64.clone()
    b = torch.zeros(A64.n_pad, device=cuda)
    rr = torch.zeros(1, dtype=torch.float64, device=cuda)
    dia_finish64(A64, x, d, b64, b, rr)          # first launch outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dia_finish64(A64, x, d, b64, b, rr)
    for _ in range(3):
        x.copy_(x64)
        b.zero_()
        rr.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(x, eager[0]) and torch.equal(b, eager[1])
        assert torch.equal(rr, eager[2])
    assert {k: finish_halo(FINISH_OFFSETS[k])
            for k in ("7 p3d", "21 e2d", "one odd")} == \
        {"7 p3d": 192, "21 e2d": 1028, "one odd": 6}
    bad = torch.zeros(A64.n_pad + 1, dtype=torch.float64, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        dia_finish64(A64, bad, d, b64, b, rr)


def _plain_finish(A64, x64, d, b64, b, rr, dot):
    """The loop's finish through the plain composition."""
    from sparsh_amg_tpu_torch.ops.fp64 import finish64_plain
    return finish64_plain(A64, x64, d, b64, dot)


def test_flagship_solve_with_the_finish_kernel(cuda, monkeypatch):
    """poisson3d(192) with the flagship's parameters: 12 iterations in 2
    passes, the finish kernel launched twice a pass, x with the bits of
    the same solve with the plain finish and relres within 1e-12
    relative of it."""
    from sparsh_amg_tpu_torch import AMGSolver, flagship
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.ops import counted
    from sparsh_amg_tpu_torch.solve import solver as tsolver
    A = poisson3d(192)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    s = AMGSolver(A, flagship.params(), flagship.krylov(), device=cuda)
    rhs = s.prepare_rhs(b)
    s.solve(rhs, tol=1e-2)
    got, launches = counted(lambda: s.solve(rhs))
    plain = copy.copy(s)
    plain._reset_loop_state()
    monkeypatch.setattr(tsolver, "finish64", _plain_finish)
    plain.solve(rhs, tol=1e-2)
    want, plain_launches = counted(lambda: plain.solve(rhs))
    assert (got.iterations, got.refine_passes) == (12, 2)
    assert (want.iterations, want.refine_passes, [h[0] for h in
            want.history]) == (got.iterations, got.refine_passes,
                               [h[0] for h in got.history])
    assert launches["dia_finish64"] == 2 * got.refine_passes
    assert plain_launches["dia_finish64"] == 0
    assert abs(got.relres - want.relres) <= 1e-12 * want.relres
    np.testing.assert_array_equal(got.x, want.x)
    assert got.converged and got.relres <= 1e-8


def test_finish_kernel_not_launched_on_elasticity3d(cuda):
    """elasticity3d's fp64 fine operator is sliced ELL: its finish is the
    plain composition, and the kernel never launches."""
    from sparsh_amg_tpu_torch import AMGSolver, systems
    from sparsh_amg_tpu_torch.ops import counted
    from sparsh_amg_tpu_torch.ops.formats import EllMatrix
    A, ns = systems.problem(3, 8)
    s = AMGSolver(A, systems.params(3, dense_size=256), systems.krylov(),
                  nullspace=ns, device=cuda)
    assert isinstance(s.A64, EllMatrix)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    res, launches = counted(lambda: s.solve(b))
    assert res.converged and launches["dia_finish64"] == 0
    assert launches["block_ell_spmv"] > 0


def _rows_of_lengths(n, lo, hi, mean, seed):
    """An n x n matrix whose rows hold lo + Poisson(mean - lo) entries, cut
    at hi, one row hi long, at distinct columns around the diagonal, as a
    level's rows are."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    lens = np.clip(lo + rng.poisson(mean - lo, n), lo, hi)
    lens[n // 2] = hi
    rows = np.repeat(np.arange(n), lens)
    first = np.repeat(np.cumsum(lens) - lens, lens)
    cols = rows - lens[rows] // 2 + np.arange(rows.size) - first
    A = sp.csr_matrix((rng.standard_normal(rows.size),
                       (rows, np.clip(cols, 0, n - 1))), shape=(n, n))
    A.sum_duplicates()
    return A


# (rows, shortest, longest, mean row): a random matrix, then delaunay's
# fine level (K 21, mean 7) and the flagship's R0 (K 113, mean 67) in shape
ELL_SHAPES = {"random": None, "delaunay-like": (300_000, 4, 21, 7),
              "R0-like": (150_000, 25, 113, 67)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ELL_SHAPES)
@pytest.mark.parametrize("packing", [None, (1, 1, 1), (4, 4, 256),
                                     (32, 1, 4096)],
                         ids=["rule", "T1V1unsorted", "T4V4", "T32V1"])
def test_ell_kernel_matches_plain(cuda, dtype, shape, packing):
    """The sliced kernel against its plain version (the packing the rule
    picks, and others), each launch counted, two launches with the same
    bits, 0 on padding rows."""
    import scipy.sparse as sp
    from sparsh_amg_tpu_torch.ops.ell_spmv import ell_plain, ell_spmv
    from sparsh_amg_tpu_torch.ops.formats import csr_to_ell
    A = sp.random(3000, 4500, density=0.01, random_state=4, format="csr") \
        if ELL_SHAPES[shape] is None else _rows_of_lengths(
            *ELL_SHAPES[shape], seed=3)
    pack = {} if packing is None else dict(zip(("lanes", "vec", "sigma"),
                                               packing))
    E = csr_to_ell(A, dtype, 2048, device=cuda, **pack)
    x = _vec(np.random.default_rng(1), A.shape[1], cuda)
    before = ell_spmv.launches
    got = ell_spmv(E, x)
    assert ell_spmv.launches == before + 1
    again = ell_spmv(E, x)
    torch.cuda.synchronize()
    assert _rel(got, ell_plain(E, x)) <= 1e-5
    assert torch.equal(got, again)
    assert not got[E.n_rows:].any()


@pytest.mark.parametrize("shape", ["delaunay-like", "R0-like"])
def test_plain_fp64_product_is_deterministic(cuda, shape):
    """The fp64 refinement residual's plain product on a packed operator
    gives the same bits twice on the card, within fp64 rounding of the
    host's."""
    from sparsh_amg_tpu_torch.ops.fp64 import csr_to_fp64, spmv64
    A = _rows_of_lengths(*ELL_SHAPES[shape], seed=4)
    A64 = csr_to_fp64(A, prefer_dia=False, device=cuda)
    x = np.random.default_rng(5).standard_normal(A.shape[1])
    xd = torch.from_numpy(x).to(cuda)
    got, again = spmv64(A64, xd), spmv64(A64, xd)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = torch.from_numpy(A @ x)
    assert _rel(got[: A.shape[0]].cpu(), want) <= 1e-13


# launch shapes (W, T, G, S) of the block kernel: dof rows (one thread a
# row, or split over G lanes and S cluster blocks) and node groups of 16
# bytes of values ("wide": 4 fp32, 8 bf16 nodes) over T lanes; None is
# the chooser's
BLOCK_SHAPES = [None, (1, 1, 1, 1), (1, 1, 2, 1), (1, 1, 16, 1),
                (1, 1, 32, 2), ("wide", 1, 1, 1), ("wide", 4, 1, 1),
                ("wide", 32, 1, 1)]


def _block_spmv(cols, vals, lens, x, shape):
    """The wrapper (shape None) or a launch forced to `shape`."""
    from sparsh_amg_tpu_torch.ops.block_ell import _launch, block_ell_spmv
    if shape is None:
        return block_ell_spmv(cols, vals, lens, x)
    if shape[0] == "wide":
        shape = (16 // vals.element_size(), *shape[1:])
    return _launch(cols, vals, lens, x, shape)


def _holed_blocks(nb, bs, seed, density):
    """random_blocks with node rows 0 and 3 and the last one emptied."""
    from sparsh_amg_tpu_torch.systems import random_blocks
    A = random_blocks(nb, bs, seed, density).tolil()
    for node in (0, 3, nb - 1):
        A[node * bs:(node + 1) * bs, :] = 0
    A = A.tocsr()
    A.eliminate_zeros()
    return A


# node rows not a multiple of 4 or 8 (a last, part group), K above the
# kernel's 16-slot head (rows stop at their lengths), K within it, and
# empty node rows
BLOCK_FAMILIES = {
    "701 nodes K>16": lambda bs: _holed_blocks(701, bs, 1, 0.02),
    "703 nodes K<=16": lambda bs: _holed_blocks(703, bs, 2, 0.004),
    "13 nodes": lambda bs: _holed_blocks(13, bs, 3, 0.3),
}


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
@pytest.mark.parametrize("family", BLOCK_FAMILIES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [2, 3, 4, 5, 6])
def test_block_kernel_launch_shapes(cuda, bs, dtype, family, shape):
    """Every launch shape against the plain version, the same bits twice,
    y = 0 on the padding rows and on empty node rows."""
    from sparsh_amg_tpu_torch.ops.block_ell import (block_ell_plain,
                                                    block_ell_spmv,
                                                    csr_to_block_ell)
    A = BLOCK_FAMILIES[family](bs)
    M = csr_to_block_ell(A, bs, dtype, device=cuda)
    if family == "703 nodes K<=16":
        assert M.k <= 16
    elif family == "701 nodes K>16":
        assert M.k > 16
    x = _vec(np.random.default_rng(1), M.n_pad, cuda)
    before = block_ell_spmv.launches
    got = _block_spmv(M.cols, M.vals, M.lens, x, shape)
    again = _block_spmv(M.cols, M.vals, M.lens, x, shape)
    torch.cuda.synchronize()
    assert block_ell_spmv.launches == before + 2
    assert _rel(got, block_ell_plain(M.cols, M.vals, x, M.lens)) <= 1e-5
    assert torch.equal(got, again)
    assert not got[M.n_rows:].any() and not got[:bs].any()
    assert not got[3 * bs:4 * bs].any() and not got[M.n_rows - bs:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_node_groups_stream_tables_larger_than_l2(cuda, dtype):
    """Random tables of K = 27 slots, bs 3, larger than the card's L2 (as
    the fine elasticity level's, which the node groups stream; node rows
    of random lengths), against the plain version, the same bits twice,
    in node-group shapes of 1, 4 and 32 lanes."""
    from sparsh_amg_tpu_torch.ops.block_ell import block_ell_plain
    k, bs = 27, 3
    esize = torch.finfo(dtype).bits // 8
    l2 = torch.cuda.get_device_properties(cuda).L2_cache_size
    nb = l2 // (k * bs * bs * esize) * 5 // 4 + 3
    n_pad = -(-nb * bs // 2048) * 2048
    gen = torch.Generator(device=cuda).manual_seed(7)
    cols = torch.randint(0, nb, (k, nb), generator=gen, device=cuda,
                         dtype=torch.int32)
    lens = torch.randint(1, k + 1, (nb,), generator=gen, device=cuda,
                         dtype=torch.int32)
    vals = torch.randn(k, bs, n_pad, generator=gen, device=cuda).to(dtype)
    # the layout's padding: slots past a node row's length hold col 0 and
    # a zero block, and so do the rows past n
    pad = torch.arange(k, device=cuda)[:, None] >= lens[None, :]
    cols[pad] = 0
    vals[:, :, : nb * bs] *= ~pad.repeat_interleave(bs, dim=1)[:, None, :]
    vals[:, :, nb * bs:] = 0
    assert vals.nbytes + cols.nbytes > l2
    x = torch.randn(n_pad, generator=gen, device=cuda)
    want = block_ell_plain(cols, vals, x, lens)
    for t in (1, 4, 32):
        got = _block_spmv(cols, vals, lens, x, ("wide", t, 1, 1))
        again = _block_spmv(cols, vals, lens, x, ("wide", t, 1, 1))
        torch.cuda.synchronize()
        assert _rel(got, want) <= 1e-5, t
        assert torch.equal(got, again) and not got[nb * bs:].any()


def test_block_chooser_on_the_card(cuda):
    """The wrapper's default shape is choose_block's with this card's
    limits, cached, and holds under graph capture."""
    from sparsh_amg_tpu_torch.ops.block_ell import (block_ell_spmv,
                                                    block_shape,
                                                    csr_to_block_ell)
    from sparsh_amg_tpu_torch.ops.split_rows import choose_block, limits
    M = csr_to_block_ell(_holed_blocks(701, 3, 1, 0.02), 3, device=cuda)
    assert block_shape(M.cols, M.vals) == choose_block(
        M.cols.shape[1], 3, M.k, 4, limits(cuda))
    x = _vec(np.random.default_rng(1), M.n_pad, cuda)
    want = block_ell_spmv(M.cols, M.vals, M.lens, x)
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        block_ell_spmv(M.cols, M.vals, M.lens, x)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(g):
        y = block_ell_spmv(M.cols, M.vals, M.lens, x)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want)


def test_block_graph_ms_times_the_card(cuda):
    from sparsh_amg_tpu_torch.ops.block_ell import csr_to_block_ell
    from sparsh_amg_tpu_torch.utils.timing import graph_ms
    M = csr_to_block_ell(_holed_blocks(701, 3, 1, 0.02), 3, device=cuda)
    x = _vec(np.random.default_rng(1), M.n_pad, cuda)
    ms = graph_ms(lambda: M.spmv(x), launches=4, runs=3)
    assert 0 < ms < 10


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [2, 3, 6])
def test_block_kernel_matches_plain(cuda, bs, dtype):
    from sparsh_amg_tpu_torch.ops.block_ell import (block_ell_plain,
                                                    block_ell_spmv,
                                                    csr_to_block_ell)
    from sparsh_amg_tpu_torch.systems import random_blocks
    M = csr_to_block_ell(random_blocks(700, bs, bs), bs, dtype, device=cuda)
    x = _vec(np.random.default_rng(1), M.n_pad, cuda)
    before = block_ell_spmv.launches
    got = block_ell_spmv(M.cols, M.vals, M.lens, x)
    torch.cuda.synchronize()
    assert _rel(got, block_ell_plain(M.cols, M.vals, x)) <= 1e-5
    assert not got[M.n_rows:].any()
    assert block_ell_spmv.launches == before + 1


def test_wrappers_raise_on_mixed_devices(cuda):
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    from sparsh_amg_tpu_torch.ops.block_ell import block_ell_spmv
    bands = torch.ones(1, 2048, device=cuda)
    with pytest.raises(ValueError):
        K.dia_spmv(bands, torch.ones(2048), (0,))
    with pytest.raises(ValueError):
        K.dia_spmv(bands, torch.ones(2048, device=cuda).double(), (0,))
    cols = torch.zeros(2, 682, dtype=torch.int32, device=cuda)
    vals = torch.ones(2, 3, 2048, device=cuda)
    lens = torch.full((682,), 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        block_ell_spmv(cols, vals, lens, torch.ones(2048))
    with pytest.raises(ValueError):
        block_ell_spmv(cols.cpu(), vals, lens, torch.ones(2048, device=cuda))
    with pytest.raises(ValueError):
        block_ell_spmv(cols, vals, lens.cpu(), torch.ones(2048, device=cuda))
    import dataclasses
    import scipy.sparse as sp
    from sparsh_amg_tpu_torch.ops.ell_spmv import ell_spmv
    from sparsh_amg_tpu_torch.ops.formats import csr_to_ell
    E = csr_to_ell(sp.random(300, 400, density=0.05, random_state=1,
                             format="csr"), device=cuda)
    with pytest.raises(ValueError):
        ell_spmv(E, torch.ones(400))
    with pytest.raises(ValueError):
        ell_spmv(dataclasses.replace(E, perm=E.perm.cpu()),
                 torch.ones(400, device=cuda))


# (rows, columns, longest row): fewer than 32 rows, rows not a multiple of
# 32, and launches of (32, 8), (32, 8), (32, 4), (16, 1), (2, 1), (4, 1)
# and (8, 1) lanes x cluster blocks from the chooser on an H100
LONG_ELL = [(20, 4000, 3000), (77, 5000, 3000), (2000, 3500, 1500),
            (10000, 12000, 250), (1000, 1500, 20), (1000, 1500, 40),
            (1000, 1500, 100)]
# (node rows, node columns, longest node row) per block size: (32, 1),
# (32, 4), (16, 1), (2, 1), (4, 1) and (8, 1)-shaped launches
LONG_BLOCK = [(10, 600, 450), (15, 2500, 2000), (700, 900, 200),
              (100, 150, 20), (100, 150, 40), (100, 150, 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LONG_ELL)
def test_ell_kernel_long_rows(cuda, shape, dtype):
    """Split rows (lanes and clusters) against the plain version; two
    launches give identical bits."""
    from sparsh_amg_tpu_torch.ops.ell_spmv import ell_plain, ell_spmv
    from sparsh_amg_tpu_torch.ops.formats import csr_to_ell
    from sparsh_amg_tpu_torch.ops.split_rows import launch_shape
    from sparsh_amg_tpu_torch.systems import random_long_rows
    A = random_long_rows(*shape, seed=5)
    E = csr_to_ell(A, dtype, 2048, device=cuda)
    assert E.k == shape[2] and (E.lanes, E.vec) == (1, 1)
    assert launch_shape(E.n_rows, E.k, cuda) != (1, 1)
    x = _vec(np.random.default_rng(2), A.shape[1], cuda)
    before = ell_spmv.launches
    got = ell_spmv(E, x)
    assert ell_spmv.launches == before + 1
    again = ell_spmv(E, x)
    torch.cuda.synchronize()
    assert _rel(got, ell_plain(E, x)) <= 1e-5
    assert torch.equal(got, again)
    assert not got[E.n_rows:].any()


@pytest.mark.parametrize("launch", [None, (1, 1, 1, 1), ("wide", 8, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LONG_BLOCK)
@pytest.mark.parametrize("bs", [2, 3, 6])
def test_block_kernel_long_rows(cuda, bs, shape, dtype, launch):
    """The chooser's launch (split rows: these rows leave most of the
    card idle), one thread per dof row and node groups of long rows,
    against the plain version."""
    from sparsh_amg_tpu_torch.ops.block_ell import (block_ell_plain,
                                                    block_shape,
                                                    csr_to_block_ell)
    from sparsh_amg_tpu_torch.systems import random_long_rows
    A = random_long_rows(*shape, seed=6, bs=bs)
    M = csr_to_block_ell(A, bs, dtype, device=cuda)
    assert M.k == shape[2]
    if launch is None:
        w, t, g, s = block_shape(M.cols, M.vals)
        assert (w, t) == (1, 1) and g * s > 1
    x = _vec(np.random.default_rng(3), max(M.n_pad, M.n_cols), cuda)
    got = _block_spmv(M.cols, M.vals, M.lens, x, launch)
    again = _block_spmv(M.cols, M.vals, M.lens, x, launch)
    torch.cuda.synchronize()
    assert _rel(got, block_ell_plain(M.cols, M.vals, x)) <= 1e-5
    assert torch.equal(got, again)
    assert not got[M.n_rows:].any()


def test_gs2_bicgstab_solve_matches_cpu(cuda):
    """A small nonsymmetric gs2-BiCGStab solve (DIA triangles on the fine
    level, ELL-T ones below) on the card against the same solve on the
    CPU."""
    from sparsh_amg_tpu_torch import AMGSolver, configs
    name = "convection3d_96_pmis_extpi_V_bicgstab"
    A, _ = configs.problem(name, 12)
    b = configs.rhs(A.shape[0])
    p, kr = configs.params(name, dense_size=256), configs.krylov(name)
    solver = AMGSolver(A, p, kr, device=cuda)
    assert type(solver.device.levels[0].L).__name__ == "DiaMatrix"
    on_gpu = solver.solve(b)
    on_cpu = AMGSolver(A, p, kr, device="cpu").solve(b)
    assert on_gpu.converged and on_cpu.converged
    assert abs(on_gpu.iterations - on_cpu.iterations) <= 2
    assert on_gpu.refine_passes == on_cpu.refine_passes
    for r in (on_gpu, on_cpu):
        assert np.linalg.norm(b - A @ r.x) / np.linalg.norm(b) <= 1e-8


def test_benchmark_op_times_the_card(cuda):
    """utils/timing.benchmark_op times a CUDA op between events."""
    from sparsh_amg_tpu_torch.utils.timing import benchmark_op
    x = torch.ones(1 << 24, device=cuda)
    s = benchmark_op(lambda v: v * 2, x, iters=5)
    assert 0.0 < s < 0.1


def test_bench_on_the_card(cuda):
    """bench_torch.py at 48^3 on the card: its checks pass, the copy rate
    is measured below the data sheet's, and the solves launched the
    flagship's kernels."""
    import bench_torch
    out = bench_torch.main(["--n", "48"])
    assert out["ok"] and out["backend"] == "cuda", out["checks"]
    assert out["device_name"] == torch.cuda.get_device_name(0)
    assert 0.0 < out["hbm_bw_GBs"] <= out["hbm_bw_spec_GBs"]
    assert 0.0 < out["hbm_fraction"] <= 1.0
    assert out["solve_peak_bytes"] > 0 and out["bytes_limit"] > 0
    for name in ("dia_spmv", "dia_cheb_step", "dia_residual", "ell_spmv"):
        assert out["launches"][name] > 0, name


def test_kernel_bench_on_the_card(cuda):
    """kernel_bench_torch.py at 48^3 on the card: every row under the
    measured copy rate."""
    import kernel_bench_torch
    out = kernel_bench_torch.main(["--n", "48"])
    assert out["ok"] and out["copy_bw"]["GBs"] > 0
    assert {"spmv_l0", "P_l0", "R_l0", "vcycle"} <= {
        r["kernel"] for r in out["rows"]}
    assert all(0.0 < r["hbm_frac"] <= 1.0 for r in out["rows"])


def _dist_flagship_block(rank, ranks, m, dev):
    """Rank `rank`'s block of the flagship hierarchy of poisson3d(m) over
    `ranks` ranks (no process group: the kernels alone)."""
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.parallel.hierarchy import to_dist
    from sparsh_amg_tpu_torch.parallel.multihost import _flagship_params
    from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
    p = _flagship_params()
    return to_dist(amg_setup(poisson3d(m), p), rank, ranks, p, device=dev)


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_dist_block_kernels_match_plain(cuda, rank):
    """The DIA interior and the ELL kernel on rank blocks of the flagship
    hierarchy (poisson3d(48) over 4 ranks) against their plain versions,
    each launch counted."""
    from sparsh_amg_tpu_torch.ops.dia_spmv import dia_plain, dia_spmv
    from sparsh_amg_tpu_torch.ops.ell_spmv import ell_plain, ell_spmv
    from sparsh_amg_tpu_torch.parallel.dist import DistDia, DistEll
    dh = _dist_flagship_block(rank, 4, 48, cuda)
    rng = np.random.default_rng(rank)
    ops = [getattr(getattr(l, f), "op", getattr(l, f)) for l in dh.levels
           for f in ("A", "P", "R")]
    dia = [M for M in ops if isinstance(M, DistDia)]
    ell = [M for M in ops if isinstance(M, DistEll)]
    assert dia and ell
    for M in dia:
        x = _vec(rng, M.n_loc, cuda)
        before = dia_spmv.launches
        got = dia_spmv(M.bands, x, M.offsets)
        assert dia_spmv.launches == before + 1
        torch.cuda.synchronize()
        assert _rel(got, dia_plain(M.bands, M.offsets, x)) <= 1e-5
    for M in ell:
        L = M.as_local()
        x = _vec(rng, L.n_cols, cuda)
        before = ell_spmv.launches
        got = ell_spmv(L, x)
        assert ell_spmv.launches == before + 1
        torch.cuda.synchronize()
        assert _rel(got, ell_plain(L, x)) <= 1e-5
        assert not got[L.n_rows:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_dist_block_fused_products_match_the_serial_kernel(cuda, rank,
                                                           dtype):
    """Every fused product on rank blocks of poisson3d(48) over 4 ranks
    (halos cut from the whole vector, NaN at the domain's ends), the
    Chebyshev start, step and last tails from a zero start too: the
    local launch of the tail and the boundary launch give the rank's rows
    of one serial launch on the whole DiaMatrix of the same CSR, bit for
    bit, with one launch of each (the zero start's start, which has no
    product, alone) and no halo read at an end the rank lacks."""
    import dataclasses
    from test_torch_dist_dia import CutHalos
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.ops import counted
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    from sparsh_amg_tpu_torch.ops.formats import csr_to_dia
    from sparsh_amg_tpu_torch.parallel.dist import (DistDia, RankGroup,
                                                    csr_to_dist)
    from sparsh_amg_tpu_torch.parallel.partition import Partition
    A, ranks = poisson3d(48), 4
    part = Partition.make(A.shape[0], ranks)
    whole = csr_to_dia(A, dtype, part.n_pad, device=cuda)
    op = csr_to_dist(A, part, part, RankGroup(rank, ranks), dtype=dtype,
                     device=cuda)
    assert isinstance(op, DistDia) and op.offsets == whole.offsets
    rng = np.random.default_rng(rank)
    v, b, x = (_vec(rng, part.n_pad, cuda) for _ in range(3))
    dinv = torch.from_numpy(rng.uniform(0.1, 0.2, part.n_pad).astype(
        np.float32)).to(cuda)
    op = dataclasses.replace(op, ranks=CutHalos(rank, ranks, glob=v))
    rows = slice(rank * op.n_loc, (rank + 1) * op.n_loc)
    vl, bl, dl, xl = v[rows], b[rows], dinv[rows], x[rows]
    W, offs = whole.bands, whole.offsets
    cases = [
        ("dia_spmv", lambda: op.spmv(vl), lambda: K.dia_spmv(W, v, offs)),
        ("dia_residual", lambda: op.residual(vl, bl),
         lambda: K.dia_residual(W, v, b, offs)),
        ("dia_jacobi_sweep", lambda: op.jacobi_sweep(vl, bl, dl, 0.7),
         lambda: K.dia_jacobi_sweep(W, v, b, dinv, 0.7, offs)),
        ("dia_cheb_step", lambda: op.cheb_step(xl, vl, bl, dl, 0.3, 0.9),
         lambda: K.dia_cheb_step(W, x, v, b, dinv, 0.3, 0.9, offs)),
        ("dia_cheb_start", lambda: op.cheb_start(vl, bl, dl, 1.7),
         lambda: K.dia_cheb_start(W, v, b, dinv, 1.7, offs)),
        ("dia_cheb_start", lambda: op.cheb_start(None, bl, dl, 1.7),
         lambda: K.dia_cheb_start(W, None, b, dinv, 1.7, offs)),
        ("dia_cheb_step", lambda: op.cheb_step(None, vl, bl, dl, 0.3, 0.9),
         lambda: K.dia_cheb_step(W, None, v, b, dinv, 0.3, 0.9, offs)),
        ("dia_cheb_last", lambda: op.cheb_last(xl, vl, bl, dl, 0.3, 0.9),
         lambda: K.dia_cheb_last(W, x, v, b, dinv, 0.3, 0.9, offs)),
        ("dia_cheb_last", lambda: op.cheb_last(None, vl, bl, dl, 0.3, 0.9),
         lambda: K.dia_cheb_last(W, None, v, b, dinv, 0.3, 0.9, offs)),
    ]
    for i, (name, block, serial) in enumerate(cases):
        got, launches = counted(block)
        want = serial()
        torch.cuda.synchronize()
        boundary = {} if i == 5 else {"dia_fused_boundary": 1}  # no product
        assert {w: c for w, c in launches.items() if c} == \
            {name: 1, **boundary}, (name, launches)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want, strict=True):
            assert torch.isfinite(g).all(), name
            assert torch.equal(g, w[rows]), name


def test_dist_one_rank_on_the_card_matches_cpu(cuda):
    """A one-rank DistAMGSolver on the card against the same solve on the
    CPU: the same counts, both to 1e-8 on the host."""
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.ops import counted
    from sparsh_amg_tpu_torch.params import KrylovParams
    from sparsh_amg_tpu_torch.parallel import DistAMGSolver
    from sparsh_amg_tpu_torch.parallel.multihost import _flagship_params
    A = poisson3d(32)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    p, kr = _flagship_params().replace(dense_size=256), \
        KrylovParams(tol=1e-8, maxiter=60)
    on_gpu, launches = counted(
        lambda: DistAMGSolver(A, params=p, krylov=kr, device=cuda).solve(b))
    on_cpu = DistAMGSolver(A, params=p, krylov=kr, device="cpu").solve(b)
    assert launches["dia_spmv"] > 0 and launches["ell_spmv"] > 0
    assert abs(on_gpu.iterations - on_cpu.iterations) <= 1
    assert on_gpu.refine_passes == on_cpu.refine_passes
    for r in (on_gpu, on_cpu):
        assert np.linalg.norm(b - A @ r.x) / np.linalg.norm(b) <= 1e-8


@pytest.mark.parametrize("setup", ["blocked", "global"])
def test_dist_two_ranks_share_the_card_through_gloo(cuda, setup):
    """Two ranks on one card with the gloo backend (halos, dots and
    gathers staged through pinned host buffers): both converge with one
    count, launch the DIA and ELL kernels, and their rows tile the
    domain."""
    from sparsh_amg_tpu_torch.parallel.multihost import launch_processes
    res = launch_processes(2, "poisson3d", 24, setup=setup, device="cuda",
                           backend="gloo", timeout=300)
    assert len({(r["iterations"], r["passes"]) for r in res}) == 1
    for r in res:
        assert r["converged"] and r["true_relres"] <= 1e-8, r
        assert r["backend"] == "gloo" and r["device"].startswith("cuda"), r
        assert r["launches"]["dia_spmv"] > 0, r
        assert r["launches"]["ell_spmv"] > 0, r
    if setup == "blocked":
        assert res[0]["row_range"][1] == res[1]["row_range"][0]
        assert res[1]["row_range"][1] == res[0]["n"]


def test_dist_two_nccl_ranks_capture_their_loop(cuda):
    """Two NCCL ranks, one card each, run the process-local solve from
    captured graphs with the halos and all-reduces inside them: the same
    counts on both ranks (and the JAX record's 12 / 2 +-1), x with the same
    bits as the same solve run eagerly from the same state, one host read
    per pass (its pass graphs built), and no event node in the captured
    step (a WHILE body holds none)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards: NCCL ranks take one card each")
    from sparsh_amg_tpu_torch.parallel.multihost import launch_processes
    res = launch_processes(2, "poisson3d", 48, setup="blocked",
                           device="cuda", backend="nccl",
                           compare_eager=True, timeout=300)
    assert len({(r["iterations"], r["passes"]) for r in res}) == 1
    for r in res:
        assert r["backend"] == "nccl" and r["capture"], r
        assert r["converged"] and r["true_relres"] <= 1e-8, r
        assert abs(r["iterations"] - 12) <= 1 and r["passes"] == 2, r
        assert (r["eager"]["iterations"], r["eager"]["passes"]) == \
            (r["iterations"], r["passes"]), r
        assert r["same_bits"], r
        kinds = r["step_node_kinds"]
        assert kinds["kernel"] > 0, kinds
        assert not {"wait_event", "event_record"} & set(kinds), kinds
        assert r["launches"]["dia_spmv"] > 0, r
        assert r["launches"]["ell_spmv"] > 0, r
        assert r["host_reads"] == r["passes"], r
        assert r["pass_graph_s"] > 0, r
        assert len(r["pass_ms"]) == r["passes"], r
        assert 0 < r["pass_share"] < 1, r
        assert r["launches"]["loop_guard"] > 0, r


def test_nccl_ranks_that_raise_after_a_captured_solve_exit(cuda):
    """Two NCCL ranks whose pass graphs captured collectives raise after
    their solve: the teardown at exit releases the graphs before it
    destroys the group, so the rank exits with its error instead of
    waiting at the time limit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards: NCCL ranks take one card each")
    from test_torch_capture_decision import raising_ranks
    text = raising_ranks("nccl", "cuda")
    assert '"capture": true' in text, text


def test_dist_nccl_collectives_replay_as_their_eager_twin(cuda):
    """NCCL ranks (four where there are four cards, else two) at
    poisson3d(96), process-local set-up, device loop: the collectives a
    captured solve counts (the tally ``dist.collectives``, which each
    replay adds again, a WHILE body's once an iteration) equal those its
    eager twin issues one by one, and x has the same bits."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs 2 CUDA cards: NCCL ranks take one card each")
    from sparsh_amg_tpu_torch.parallel.multihost import launch_processes
    res = launch_processes(4 if cards >= 4 else 2, "poisson3d", 96,
                           setup="blocked", device="cuda", backend="nccl",
                           compare_eager=True, timeout=600)
    assert len({(r["iterations"], r["passes"], r["collectives"])
                for r in res}) == 1
    for r in res:
        assert r["capture"] and r["same_bits"], r
        assert r["host_reads"] == r["passes"], r
        assert r["collectives"] == r["eager"]["collectives"], r
        assert r["collectives"] > 3 * r["iterations"], r


def test_rank_cell_at_96_reports_four_cards(cuda):
    """The four-rank cell's traffic kind at poisson3d(96) through
    ``run_cell`` on four NCCL ranks: correct, four cards counted, and the
    per-layer metrics of its ``--trace 1`` line read."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: the cell's ranks take one each")
    from ranks_cell import load_bench
    from amgbench import harness
    spec = harness.load_cell(load_bench(), "p3d304x4.rhs")
    spec["config"] = dict(spec["config"], size={"n": 96}, cache=False)
    result, record = harness.run_cell(spec, 2 ** 33 + 1, 3.0, True, "cuda")
    assert result["correct"] and result["failed"] == 0, result
    assert result["device"]["count"] == 4, result["device"]
    assert "H100" in result["device"]["kind"]
    m = result["metrics"]
    for name in ("iterations_per_solve", "host_reads_per_solve",
                 "blocked_setup_s", "collectives_per_solve",
                 "device_idle_pct"):
        assert name in m, (name, m)
    assert 0 < m["solve_roofline_pct"]["value"] <= 100, m
    assert all(r["host_reads"] == r["passes"] for r in record["requests"])


def _flagship_small(cuda, **kw):
    """The flagship's parameters on poisson3d(24), its rhs on the card."""
    import dataclasses
    from sparsh_amg_tpu_torch import AMGSolver, flagship
    from sparsh_amg_tpu_torch.models import poisson3d
    A = poisson3d(24)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    kr = dataclasses.replace(flagship.krylov(), **kw)
    s = AMGSolver(A, flagship.params(dense_size=256), kr, device=cuda)
    return A, b, s, s.prepare_rhs(b)


def test_captured_device_mode_matches_eager(cuda):
    """Each pass as one WHILE-node graph launch against the same passes
    run eagerly (the loop in Python, the guard kernel asked before every
    step), both from the same estimates: equal counts and history, x with
    the same bits, one host read per pass."""
    import copy
    A, b, s, rhs = _flagship_small(cuda)
    s.warm()
    s.solve(rhs, tol=1e-2)
    eager = copy.copy(s)
    eager.capture = False
    got, want = copy.copy(s).solve(rhs), eager.solve(rhs)
    loop = s._loop()
    assert all(g.graph is not None for g in loop.all_graphs())
    assert len(loop.passes) == 2 and all(
        p.exec is not None for p in loop.passes.values())
    assert (got.iterations, got.refine_passes, got.history) == \
        (want.iterations, want.refine_passes, want.history)
    assert abs(got.relres - want.relres) <= 1e-12 * want.relres
    np.testing.assert_array_equal(got.x, want.x)
    assert got.host_reads == got.refine_passes
    assert want.host_reads == want.iterations + 2 * want.refine_passes
    assert np.linalg.norm(b - A @ got.x) / np.linalg.norm(b) <= 1e-8


def _profiled_wrappers(fn):
    """(counted() launches of fn, {wrapper: kernels the profiler saw})."""
    import re
    from torch.profiler import ProfilerActivity, profile
    from sparsh_amg_tpu_torch.ops import counted, ell_spmv
    from sparsh_amg_tpu_torch.ops.dia_spmv import WRAPPERS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, counts = counted(fn)
        torch.cuda.synchronize()
    seen = {}
    for e in prof.events():
        m = re.search(r"::dia_tile<[^,]+, (\d+),", e.name)
        m_ell = re.search(r"::ell_spmv(?:_split)?<[^>]*, (\d+)>", e.name)
        name = WRAPPERS[int(m.group(1))].__name__ if m else \
            ell_spmv.WRAPPERS[int(m_ell.group(1))].__name__ if m_ell else \
            "dia_fused_boundary" if "::dia_boundary<" in e.name else next(
                (w for w in ("block_ell_spmv", "ell_spmv", "dia_finish64",
                             "loop_guard")
                 if f"::{w}" in e.name or e.name.startswith(w)), None)
        if name and getattr(e.device_type, "name", "") == "CUDA":
            seen[name] = seen.get(name, 0) + 1
    return out, {k: v for k, v in counts.items() if v}, seen


def test_replay_launches_match_the_profiler(cuda):
    """counted() over one pass-graph launch adds the start's and finish's
    launches, k times the step's and k + 1 guard launches, k read from the
    device; the profiler sees every one of those kernels (it reports a
    WHILE body's kernels once per launch, not once per iteration).  Over
    one replay of the step graph, counted() reports by wrapper the
    kernels the profiler sees."""
    _, _, s, rhs = _flagship_small(cuda)
    s.warm()
    loop = s._loop()
    loop.b64.copy_(rhs.b)
    loop.set_limits(1e-3, 50)
    (prog, reads), counts, seen = _profiled_wrappers(
        loop.pass_graph(True).run)
    k = int(prog[1])
    assert reads == 1 and k > 1 and counts["dia_cheb_step"] > 0 and counts["ell_spmv"] > 0
    want = {}
    for g, times in ((loop.cast, 1), (loop.init, 1), (loop.step, k),
                     (loop.finish, 1)):
        for w, n in g.per_replay.items():
            want[w.__name__] = want.get(w.__name__, 0) + n * times
    want["loop_guard"] = k + 1
    assert counts == want
    assert set(seen) == set(counts) and all(
        1 <= seen[w] <= counts[w] for w in counts), (counts, seen)
    _, counts, seen = _profiled_wrappers(loop.step.run)
    assert counts == seen
    assert {w.__name__: n for w, n in loop.step.per_replay.items()} == seen


@pytest.mark.parametrize("method,case", [
    (m, c) for m in ("cg", "bicgstab", "amg")
    for c in ("active", "met", "zero_rhs", "budget", "inf", "nan",
              "breakdown") if c != "breakdown" or m == "bicgstab"])
def test_loop_guard_matches_loop_continue(cuda, method, case):
    """The guard kernel launched on its own against its plain version on
    the same state: the same decision and the same record in prog[:3]."""
    from sparsh_amg_tpu_torch.solve import krylov as tk
    from sparsh_amg_tpu_torch.solve.graphs import loop_guard
    n = {"cg": 7, "bicgstab": 10, "amg": 4}[method]
    i_rr, i_k, i_brk = tk.READS[method]
    state = [torch.zeros(8, device=cuda) for _ in range(n)]
    state[i_rr] = torch.tensor(
        {"inf": float("inf"), "nan": float("nan"), "zero_rhs": 0.0}.get(
            case, 2.5), device=cuda)
    state[i_k] = torch.tensor(50 if case == "budget" else 3,
                              dtype=torch.int32, device=cuda)
    if i_brk is not None:
        state[i_brk] = torch.tensor(case == "breakdown", device=cuda)
    target = torch.tensor(3.0 if case == "met" else 0.0,
                          dtype=torch.float64, device=cuda)
    guard = (target, torch.tensor(50.0, dtype=torch.float64, device=cuda))
    prog = torch.zeros(5, dtype=torch.float64, device=cuda)
    before = loop_guard.launches
    go = bool(loop_guard(method, state, guard, prog))
    assert loop_guard.launches == before + 1
    want = tk.loop_continue(method, state, guard)
    assert go == want == (case == "active")
    np.testing.assert_array_equal(
        prog[:3].cpu().numpy(), tk.loop_record(method, state).cpu().numpy())


def test_pass_of_zero_iterations(cuda):
    """A pass whose right-hand side already meets its target runs no step
    in the WHILE node, as lax.while_loop runs none: k = 0, x unchanged,
    one guard launch and the start's and finish's kernels only."""
    _, _, s, rhs = _flagship_small(cuda)
    s.warm()
    loop = s._loop()
    loop.b64.copy_(rhs.b)
    loop.set_limits(2.0, 50)         # target 4 ||r0||^2 > ||r0||^2
    (prog, reads), counts, _ = _profiled_wrappers(
        loop.pass_graph(True).run)
    assert reads == 1 and prog[1] == 0.0 and prog[3] > 0.0
    assert counts["loop_guard"] == 1
    assert torch.count_nonzero(loop.x64).item() == 0
    np.testing.assert_allclose(prog[4], prog[3], rtol=1e-5)


def test_copied_solver_replays_the_same_graphs(cuda):
    """A shallow copy shares the solver's graphs and buffers: a copy's
    solve of another rhs in between leaves the solver's next solve as it
    was, and no new graph is captured."""
    import copy
    A, b, s, rhs = _flagship_small(cuda)
    s.warm()
    first = copy.copy(s).solve(rhs)
    graphs = {k: [lp.step.graph, *(p.exec for p in lp.passes.values())]
              for k, lp in s._loops.items()}
    other = copy.copy(s)
    b2 = np.random.default_rng(1).standard_normal(A.shape[0])
    r2 = other.solve(b2)
    again = copy.copy(s).solve(rhs)
    assert other._loops is s._loops
    assert {k: [lp.step.graph, *(p.exec for p in lp.passes.values())]
            for k, lp in s._loops.items()} == graphs
    assert r2.converged and np.linalg.norm(b2 - A @ r2.x) \
        <= 1e-8 * np.linalg.norm(b2)
    assert (again.iterations, again.history) == \
        (first.iterations, first.history)
    np.testing.assert_array_equal(again.x, first.x)


def test_capture_runs_with_the_collector_off(cuda):
    """A graph's capture runs with Python's cyclic collector off (a
    collection destroying a dropped solver's graphs mid-capture would
    invalidate it) and leaves the collector as it found it."""
    import gc
    from sparsh_amg_tpu_torch.solve.graphs import ChunkGraph
    buf = torch.zeros(8, device=cuda)
    seen = []

    def fn(bufs):
        seen.append(gc.isenabled())
        return (bufs[0] + 1,)
    assert gc.isenabled()
    g = ChunkGraph(fn, (buf,), True)
    g.run()
    torch.cuda.synchronize()
    assert seen == [False] and gc.isenabled()
    assert torch.equal(buf, torch.ones(8, device=cuda))
    gc.disable()
    try:
        ChunkGraph(fn, (buf,), True)
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_cli_on_the_card(capsys):
    """The flagship's coarsening through the CLI on the card."""
    import json
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from sparsh_amg_tpu_torch import cli
    out = cli.run(["--problem", "poisson3d", "--n", "32768",
                   "--coarsening", "pmis", "--interpolation", "extpi",
                   "--smoother", "chebyshev", "--dense-size", "256",
                   "--json"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert out["converged"] and out["relres"] <= 1e-8 and \
        out["refine_passes"] >= 1


# --------------------------------------------------------------------------
# the tracer (utils/trace.py): stamps in captured graphs, anchors
# --------------------------------------------------------------------------

def _trace_solver(cuda):
    from sparsh_amg_tpu_torch.models import poisson2d
    from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
    from sparsh_amg_tpu_torch.solve.solver import AMGSolver
    A = poisson2d(32)
    s = AMGSolver(A, AMGParams(coarse_size=40), KrylovParams(), device=cuda)
    return s, np.random.default_rng(0).standard_normal(A.shape[0])


def _step_kinds(cuda):
    s, _ = _trace_solver(cuda)
    s.warm()
    kinds = s._loop().step.node_kinds()
    s.release_graphs()
    return kinds, len(s.device.levels)


def test_trace_graphs_captured_off_hold_no_stamp(cuda):
    """A step graph captured with tracing off has the same nodes whether
    or not tracing was on earlier in the process; captured with it on it
    holds 2 L + 2 more kernel nodes, the stamps."""
    from sparsh_amg_tpu_torch.utils import trace
    trace.disable()
    off, L = _step_kinds(cuda)
    trace.enable()
    try:
        on, _ = _step_kinds(cuda)
    finally:
        trace.disable()
        trace.reset()
    again, _ = _step_kinds(cuda)
    assert again == off
    assert on["kernel"] == off["kernel"] + 2 * L + 2
    assert {k: v for k, v in on.items() if k != "kernel"} \
        == {k: v for k, v in off.items() if k != "kernel"}


def test_trace_stamps_run_in_the_while_body(cuda):
    """Captured with tracing on, a solve's pass graphs run the stamps once
    an iteration: each level slot counts the iterations, the stamped time
    is at most the passes' device time, and solve()'s device operations
    outside the pass graphs are timed."""
    from sparsh_amg_tpu_torch.utils import trace
    trace.reset()
    trace.enable()
    try:
        s, b = _trace_solver(cuda)
        s.warm()
        rhs = s.prepare_rhs(b)
        trace.reset()
        res = s.solve(rhs)
        e = trace.export()
    finally:
        trace.disable()
        trace.reset()
    assert res.converged and len(res.pass_ms) == res.refine_passes
    L = len(s.device.levels)
    assert {k: v["count"] for k, v in e["stamps"].items()} == {
        "step.end": res.iterations,
        **{f"{w}[{l}]": res.iterations for l in range(L)
           for w in ("enter", "leave")}}
    stamped = sum(v["ns"] for v in e["stamps"].values())
    assert 0 < stamped <= sum(res.pass_ms) * 1e6
    assert {d["name"] for d in e["device"]} == {
        "pass_graph", "solve.rhs_copy", "solve.limits", "solve.x_clone"}
    s.release_graphs()


def test_trace_anchors_map_a_sleep_into_its_host_span(cuda):
    """A device sleep between two anchors maps onto the host clock inside
    the host span that issued and waited for it, within the anchors'
    brackets."""
    from sparsh_amg_tpu_torch.utils import trace
    trace.reset()
    trace.enable()
    try:
        trace.anchor()
        with trace.span("sleep"):
            with trace.device_op("sleep", cuda):
                torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
        trace.anchor()
        e = trace.export()
    finally:
        trace.disable()
        trace.reset()
    host, dev = e["spans"][0], e["device"][0]
    slack = max(a["bracket_ns"] for a in e["anchors"])
    assert dev["ms"] > 1.0
    assert host["start_ns"] - slack <= dev["start_ns"] < dev["end_ns"] \
        <= host["end_ns"] + slack


# the kernels the captured graphs ran (tally graph.kernels) and the
# benchmark's rotated-anisotropy cell, aniso2048.rhs

ANISO = "aniso2d_2048_eps1e-3_rot45_aggW_bicgstab"


def _aniso_small(cuda, m=128, **amg):
    """The aniso cell's recipe (W-cycle, l1-Jacobi, BiCGStab) on
    aniso2d(m), dense levels below 64 rows (and `amg`), its rhs on the
    card."""
    from sparsh_amg_tpu_torch import AMGSolver, configs
    A, _ = configs.problem(ANISO, m)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    s = AMGSolver(A, configs.params(ANISO, dense_size=64, **amg),
                  configs.krylov(ANISO), device=cuda)
    return A, b, s, s.prepare_rhs(b)


@pytest.mark.parametrize("case", ["aniso_w_bicgstab", "flagship_v_cg"])
def test_graph_kernels_count_the_pass_graphs_kernel_nodes(cuda, case):
    """graph.kernels over one solve is the kernel nodes of what its pass
    graphs ran: the first pass's cast, each pass's init and finish once,
    its step's nodes once an iteration, and the guard kernel iterations
    + 1 times; each part's nodes read from its captured graph."""
    from sparsh_amg_tpu_torch.solve.graphs import GRAPH_KERNELS
    A, b, s, rhs = (_aniso_small if case.startswith("aniso")
                    else _flagship_small)(cuda)
    s.warm()
    s.solve(rhs, tol=1e-2)
    loop = s._loop()
    nodes = {name: getattr(loop, name).node_kinds()["kernel"]
             for name in ("cast", "init", "step", "finish")}
    assert {name: getattr(loop, name).kernel_nodes for name in nodes} \
        == nodes
    before = GRAPH_KERNELS.launches
    res = s.solve(rhs)
    got = GRAPH_KERNELS.launches - before
    iters = [k for k, _ in res.history]
    want = nodes["cast"] + sum(nodes["init"] + nodes["finish"]
                               + (nodes["step"] + 1) * k + 1
                               for k in iters)
    assert res.converged and res.refine_passes == len(iters) >= 2
    assert got == want, (got, want, nodes, iters)
    s.release_graphs()


def test_aniso2048_w_cycle_matches_the_reference(cuda):
    """One W-cycle of the set-up and frozen aniso2d(2048) solver on the
    card against the benchmark's plain float64 reference
    (amgbench/reference/wcycle.py) on the card over the same host
    hierarchy, to the CPU test's tolerance in the residual space
    (test_torch_aniso_cell.py)."""
    from test_torch_aniso_cell import CYCLE_RTOL, residual_difference
    from amgbench import harness
    from sparsh_amg_tpu_torch import AMGSolver, configs
    import os
    wc = harness.load_module(
        os.path.join(harness.BENCH_DIR, "reference", "wcycle.py"),
        "amgbench_reference_wcycle")
    A, _ = configs.problem(ANISO)
    p = configs.params(ANISO)
    s = AMGSolver(A, p, configs.krylov(ANISO), device=cuda)
    levels = [(lev.A, lev.P, lev.R) for lev in s.hierarchy.levels]
    assert s.perm is None and len(levels) == \
        configs.REFERENCE[ANISO]["cpu"]["levels"]
    ref = wc.WCycle(levels, p.nu1, p.nu2, device=cuda)
    n = A.shape[0]
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(n)).to(
        cuda)
    bp = torch.zeros(s.n_pad, dtype=torch.float32, device=cuda)
    bp[:n] = b.float()
    got = s._cycle(s.device.levels, bp)[:n].double()
    want = ref(b)
    err = residual_difference(wc, A, got, want)
    plain = float(torch.linalg.vector_norm(got - want)
                  / torch.linalg.vector_norm(want))
    print(f"aniso2d(2048) W-cycle against the fp64 reference: {err:.3e} "
          f"in the residual space, {plain:.3e} plain")
    assert err <= CYCLE_RTOL, err
    s.release_graphs()


# the ELL kernel's tails (ops/ell_spmv.py): square levels in the sliced
# packings, split rows over lanes and over a cluster, and a short wide
# operator whose padding rows the split launch's tail writes
ELL_TAIL_MATRICES = {
    "rule": (lambda: _rows_of_lengths(*ELL_SHAPES["delaunay-like"], seed=3),
             None),
    "T1V1unsorted": (lambda: _rows_of_lengths(*ELL_SHAPES["delaunay-like"],
                                              seed=3), (1, 1, 1)),
    "T4V4": (lambda: _rows_of_lengths(*ELL_SHAPES["R0-like"], seed=3),
             (4, 4, 256)),
    "T32V1": (lambda: _rows_of_lengths(*ELL_SHAPES["R0-like"], seed=3),
              (32, 1, 4096)),
    "split": ((3000, 3000, 1500), None),
    "cluster": ((1000, 1000, 800), None),
    "split 20x4000": ((20, 4000, 3000), None),
}
ELL_TAIL_CASES = [(t, c) for t in ("residual", "jacobi", "jacobi1", "add")
                  for c in ELL_TAIL_MATRICES
                  if not (t.startswith("jacobi") and c == "split 20x4000")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("tail,case", ELL_TAIL_CASES)
def test_ell_tails_are_the_kernel_composition(cuda, dtype, tail, case):
    """Each ELL tail in one launch against the kernel's SpMV and the
    elementwise PyTorch it replaces, bit for bit, padding rows included;
    each launch counted, two launches with the same bits."""
    from sparsh_amg_tpu_torch.ops import ell_spmv as K
    from sparsh_amg_tpu_torch.ops.formats import csr_to_ell
    from sparsh_amg_tpu_torch.ops.split_rows import launch_shape
    from sparsh_amg_tpu_torch.systems import random_long_rows
    make, packing = ELL_TAIL_MATRICES[case]
    A = random_long_rows(*make, seed=5) if isinstance(make, tuple) \
        else make()
    pack = {} if packing is None else dict(zip(("lanes", "vec", "sigma"),
                                               packing))
    E = csr_to_ell(A, dtype, 2048, device=cuda, **pack)
    g, s = launch_shape(E.n_rows, E.k, cuda)
    assert (g * s > 1) == isinstance(make, tuple)
    assert s > 1 or case != "cluster"
    rng = np.random.default_rng(6)
    x, b = _vec(rng, E.n_pad, cuda), _vec(rng, E.n_pad, cuda)
    e = _vec(rng, E.n_cols, cuda)
    dinv = torch.from_numpy(rng.uniform(0.1, 0.2, E.n_pad).astype(
        np.float32)).to(cuda)
    src = x if E.n_rows == E.n_cols else e
    omega = 0.7 if tail == "jacobi" else 1.0
    wrapper, fused, composed = {
        "residual": (K.ell_residual, lambda: K.ell_residual(E, src, b),
                     lambda: b - K.ell_spmv(E, src)),
        "add": (K.ell_spmv_add, lambda: K.ell_spmv_add(E, e, x),
                lambda: x + K.ell_spmv(E, e)),
    }.get(tail, (K.ell_jacobi_sweep,
                 lambda: K.ell_jacobi_sweep(E, x, b, dinv, omega),
                 lambda: x + omega * dinv * (b - K.ell_spmv(E, x))))
    before = wrapper.launches
    got = fused()
    assert wrapper.launches == before + 1
    again, want = fused(), composed()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)


def test_w_cycle_step_runs_the_ell_tails(cuda, monkeypatch):
    """The aniso cell's captured BiCGStab step (two W-cycles) gives the
    bits of the cycle before the ELL tails
    (test_torch_ell_tails._parent_cycle) and holds fewer kernel nodes: a
    residual, each sweep and each correction on an ELL level are one
    launch, a zero start's sweeps make no zero, and the coarse solve
    under an ELL prolongation is not padded."""
    from test_torch_ell_tails import _parent_cycle, _visits
    from sparsh_amg_tpu_torch.ops.formats import EllMatrix
    from sparsh_amg_tpu_torch.solve import cycles

    def warm_step():
        # coarsened to 64 rows: ELL levels below the DIA ones
        A, _, s, rhs = _aniso_small(cuda, coarse_size=64)
        s.warm()
        levels = s.device.levels
        step = s._loop().step
        per = {w.__name__: n for w, n in step.per_replay.items()}
        kinds = step.node_kinds()
        res = s.solve(rhs)
        s.release_graphs()
        return levels, per, kinds, res

    levels, per, kinds, res = warm_step()
    inner = range(len(levels) - 1)
    visits = _visits(len(levels), "W")
    ell_a = sum(visits[l] for l in inner if isinstance(levels[l].A,
                                                       EllMatrix))
    ell_p = sum(visits[l] for l in inner if isinstance(levels[l].P,
                                                       EllMatrix))
    assert isinstance(levels[-2].P, EllMatrix) and ell_a > 0
    assert per["ell_residual"] == 2 * ell_a
    assert per["ell_spmv_add"] == 2 * ell_p
    assert per["ell_jacobi_sweep"] > 0
    monkeypatch.setattr(cycles, "_cycle", _parent_cycle)
    _, per0, kinds0, res0 = warm_step()
    assert "ell_residual" not in per0 and "ell_spmv_add" not in per0
    # each ELL visit: a residual 2 -> 1, a sweep 5 -> 1, a correction
    # 2 -> 1; each zero start one zero fewer; the pad's kernels
    saved = kinds0["kernel"] - kinds["kernel"]
    print(f"W-BiCGStab step: {kinds['kernel']} kernel nodes, "
          f"{kinds0['kernel']} before the ELL tails")
    assert saved >= 2 * ell_a + 4 * per["ell_jacobi_sweep"] + 2 * ell_p
    assert (res.iterations, res.refine_passes) == \
        (res0.iterations, res0.refine_passes)
    assert np.array_equal(res.x, res0.x)
