"""CUDA kernels of the port against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one; on the GPU machine
(no jax there, and tests/conftest.py imports it) run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

This file imports no jax.  chip_smoke.py runs the same comparisons at the
flagship's shapes."""
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
        (K.dia_dinv_residual(bands, x, b, dinv, offs),
         K.dia_fused_plain(K.DINV_RESIDUAL, bands, offs, x, b=b, dinv=dinv)),
        (K.dia_jacobi_sweep(bands, x, b, dinv, 0.7, offs),
         K.dia_fused_plain(K.JACOBI, bands, offs, x, b=b, dinv=dinv, x=x,
                           s0=0.7)),
    ]
    got3 = K.dia_cheb_step(bands, x, d, r, dinv, 0.3, 0.9, offs)
    want3 = K.dia_fused_plain(K.CHEB, bands, offs, d, b=r, dinv=dinv, x=x,
                              s0=0.3, s1=0.9)
    pairs += list(zip(got3, want3))
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
DIA_TAILS = ("spmv", "residual", "dinv_residual", "jacobi", "cheb")


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
        "dinv_residual": (
            lambda: K.dia_dinv_residual(bands, x, b, dinv, offsets),
            lambda: K.dia_fused_plain(K.DINV_RESIDUAL, bands, offsets, x,
                                      b=b, dinv=dinv)),
        "jacobi": (
            lambda: K.dia_jacobi_sweep(bands, x, b, dinv, 0.7, offsets),
            lambda: K.dia_fused_plain(K.JACOBI, bands, offsets, x, b=b,
                                      dinv=dinv, x=x, s0=0.7)),
        "cheb": (
            lambda: K.dia_cheb_step(bands, x, d, r, dinv, 0.3, 0.9, offsets),
            lambda: K.dia_fused_plain(K.CHEB, bands, offsets, d, b=r,
                                      dinv=dinv, x=x, s0=0.3, s1=0.9)),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_kernel_matches_plain(cuda, dtype):
    import scipy.sparse as sp
    from sparsh_amg_tpu_torch.ops.ell_spmv import ell_plain, ell_spmv
    from sparsh_amg_tpu_torch.ops.formats import csr_to_ell
    A = sp.random(3000, 4500, density=0.01, random_state=4, format="csr")
    E = csr_to_ell(A, dtype, 2048, device=cuda)
    x = _vec(np.random.default_rng(1), A.shape[1], cuda)
    before = ell_spmv.launches
    got = ell_spmv(E.cols, E.vals, E.lens, x, E.n_rows)
    torch.cuda.synchronize()
    assert _rel(got, ell_plain(E.cols, E.vals, x)) <= 1e-5
    assert ell_spmv.launches == before + 1


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
    assert E.k == shape[2] and launch_shape(E.n_rows, E.k, cuda) != (1, 1)
    x = _vec(np.random.default_rng(2), A.shape[1], cuda)
    got = ell_spmv(E.cols, E.vals, E.lens, x, E.n_rows)
    again = ell_spmv(E.cols, E.vals, E.lens, x, E.n_rows)
    torch.cuda.synchronize()
    assert _rel(got, ell_plain(E.cols, E.vals, x)) <= 1e-5
    assert torch.equal(got, again)
    assert not got[E.n_rows:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LONG_BLOCK)
@pytest.mark.parametrize("bs", [2, 3, 6])
def test_block_kernel_long_rows(cuda, bs, shape, dtype):
    from sparsh_amg_tpu_torch.ops.block_ell import (block_ell_plain,
                                                    block_ell_spmv,
                                                    csr_to_block_ell)
    from sparsh_amg_tpu_torch.ops.split_rows import launch_shape
    from sparsh_amg_tpu_torch.systems import random_long_rows
    A = random_long_rows(*shape, seed=6, bs=bs)
    M = csr_to_block_ell(A, bs, dtype, device=cuda)
    assert M.k == shape[2] and launch_shape(M.n_rows, M.k, cuda) != (1, 1)
    x = _vec(np.random.default_rng(3), max(M.n_pad, M.n_cols), cuda)
    got = block_ell_spmv(M.cols, M.vals, M.lens, x)
    again = block_ell_spmv(M.cols, M.vals, M.lens, x)
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
        got = ell_spmv(L.cols, L.vals, L.lens, x, L.n_rows)
        assert ell_spmv.launches == before + 1
        torch.cuda.synchronize()
        assert _rel(got, ell_plain(L.cols, L.vals, x)) <= 1e-5
        assert not got[L.n_rows:].any()


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
