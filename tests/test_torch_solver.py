"""The port's device freeze, cycles and refinement solver (plain versions
on the CPU) against the JAX package.

* to_device builds the same layouts, diagonals, lambda_max, transfers and
  two-stage Gauss-Seidel triangles;
* one cycle on identical frozen data (hierarchy_from_jax) agrees with the
  JAX make_cycle at rtol 1e-5 (normwise floor; fp32 sums in another order);
* the full flagship solve (dense_size 256, so the small grids still reach
  the DIA and ELL code) takes the JAX iteration count +-1 and the same
  refinement passes, both to relres <= 1e-8."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparsh_amg_tpu.models.anisotropic import anisotropic2d
from sparsh_amg_tpu.models.poisson import poisson2d, poisson3d
from sparsh_amg_tpu import params as jparams
from sparsh_amg_tpu.setup.hierarchy import amg_setup
from sparsh_amg_tpu.solve import cycles as jcycles
from sparsh_amg_tpu.solve import device as jdevice
from sparsh_amg_tpu.solve.solver import AMGSolver as JaxSolver
from sparsh_amg_tpu_torch import AMGSolver, configs, flagship, to_device
from sparsh_amg_tpu_torch.ops.ell_spmv import ell_unpack
from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
from sparsh_amg_tpu_torch.solve import cycles, device
from sparsh_amg_tpu_torch.utils.meminfo import tree_device_bytes


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these sizes it is faster than the default
    pool, and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _jax(p):
    """The JAX package's AMGParams from the port's params' keywords."""
    return jparams.AMGParams(**dataclasses.asdict(p))


def _deep_params(**kw):
    """Flagship smoother and coarsening on a 4-level poisson3d(20): DIA L0
    (8000 rows), ELL L1-L2 (501 and 70 rows, smoothed in the cycle), dense
    coarsest (15 rows)."""
    return flagship.params(dense_size=64).replace(coarse_size=64, **kw)


def _table(M):
    kind = type(M).__name__
    if kind == "DiaMatrix":
        return kind, M.offsets, [np.asarray(M.bands, np.float32)]
    if kind == "EllMatrix":
        return kind, None, [np.asarray(M.cols), np.asarray(M.vals, np.float32)]
    return kind, None, [np.asarray(M.mat, np.float32), M.out_pad]


def _port_table(M, ref):
    """_table of a port layout, a packed ELL one through ell_unpack (to
    the JAX table's K slots)."""
    if type(M).__name__ == "EllMatrix":
        cols, vals, _ = ell_unpack(M, k=np.asarray(ref.cols).shape[0])
        return "EllMatrix", None, [cols.numpy(), vals.float().numpy()]
    return _table(dataclasses.replace(M, **{
        k: _np(v) for k, v in vars(M).items()
        if isinstance(v, torch.Tensor)}))


def _np(t):
    return None if t is None else (t.float().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t, np.float32))


_SA = "aniso2d_1024_eps1e-3_rot45_aggW_bicgstab"
_GS2 = "aniso2d_1024_pmis_extpi_W_gs2_bicgstab"
# (problem, params, levels): the flagship's smoother and coarsening in
# fp32 and bf16 and with two-stage GS (DIA triangles with one-sided
# offsets on L0, ELL-T triangles on L1-L2); the rotated anisotropic
# configurations at 48^2, smoothed aggregation (9-band DIA on every level
# above the dense ones) and PMIS with gs2
TO_DEVICE = {
    "float32": (lambda: poisson3d(20),
                lambda: _deep_params(band_dtype="float32"), 4),
    "bfloat16": (lambda: poisson3d(20),
                 lambda: _deep_params(band_dtype="bfloat16"), 4),
    "gs2": (lambda: poisson3d(20),
            lambda: _deep_params(band_dtype="float32", smoother="gs2"), 4),
    "aniso SA": (lambda: anisotropic2d(48, epsilon=1e-3, angle_deg=45),
                 lambda: configs.params(_SA, dense_size=64, coarse_size=64),
                 5),
    "aniso gs2": (lambda: anisotropic2d(48, epsilon=1e-3, angle_deg=45),
                  lambda: configs.params(_GS2, dense_size=256,
                                         coarse_size=64), 4),
}


@pytest.mark.parametrize("case", TO_DEVICE)
def test_to_device_matches_jax(case):
    make_A, make_p, n_levels = TO_DEVICE[case]
    p = make_p()
    hier = amg_setup(make_A().tocsr(), _jax(p))
    J = jdevice.to_device(hier, _jax(p))
    T = to_device(hier, p, device="cpu")
    assert T.n_levels == J.n_levels == n_levels
    kinds = [type(l.A).__name__ for l in T.levels]
    if case.startswith("aniso SA"):
        assert kinds[:3] == ["DiaMatrix"] * 3, kinds
        assert len(T.levels[1].A.offsets) >= 9
    tri = [(type(l.L).__name__, type(l.U).__name__) for l in T.levels]
    if "gs2" in case:
        assert tri[0] == ("DiaMatrix", "DiaMatrix"), tri
        assert all(o < 0 for o in T.levels[0].L.offsets)
        assert all(o > 0 for o in T.levels[0].U.offsets)
        assert "EllMatrix" in {t for pair in tri[1:] for t in pair}, tri
        assert tri[-1] == ("NoneType", "NoneType")       # dense inverse
    else:
        assert set(tri) == {("NoneType", "NoneType")}
    for lj, lt in zip(J.levels, T.levels):
        for f in ("A", "P", "R", "L", "U"):
            mj, mt = getattr(lj, f), getattr(lt, f)
            assert (mj is None) == (mt is None), f
            if mj is None:
                continue
            kj, oj, aj = _table(mj)
            kt, ot, at = _port_table(mt, mj)
            assert (kj, oj) == (kt, ot), f
            for a, b in zip(aj, at):
                np.testing.assert_array_equal(a, b)
        for f in ("dinv", "l1_dinv", "coarse_inv"):
            a, b = _np(getattr(lj, f)), _np(getattr(lt, f))
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert lt.lam_max == float(lj.lam_max)
        assert lt.n == lj.n


def test_dia_diag_stats_matches_jax():
    from sparsh_amg_tpu.ops.formats import csr_to_dia
    bands = np.array(csr_to_dia(poisson3d(12).tocsr(), pad_multiple=2048)
                     .bands)
    bands[3, :50] *= 1.7                  # a non-uniform diagonal
    want = jdevice._dia_diag_stats(jnp.asarray(bands), 3)
    got = device._dia_diag_stats(torch.from_numpy(bands), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("smoother,coarse_solver", [
    ("chebyshev", "lu"), ("jacobi", "lu"), ("l1jacobi", "lu"),
    ("chebyshev", "smooth"),         # smooth: l1-Jacobi coarse fallback
    ("gs2", "lu")])                  # triangles carried over from JAX
@pytest.mark.parametrize("shape", ["V", "W", "F"])
def test_cycle_matches_jax_on_identical_data(shape, smoother, coarse_solver):
    p = _deep_params(band_dtype="float32", cycle=shape, smoother=smoother,
                     coarse_solver=coarse_solver)
    jp = _jax(p)
    hier = amg_setup(poisson3d(20), jp)
    J = jdevice.to_device(hier, jp)
    T = device.hierarchy_from_jax(J, device="cpu")
    assert [type(l.A).__name__ for l in T.levels] == \
        ["DiaMatrix", "EllMatrix", "EllMatrix", "DenseMatrix"]
    if smoother == "gs2":
        assert [type(l.L).__name__ for l in T.levels] == \
            ["DiaMatrix", "EllMatrix", "EllMatrix", "NoneType"]
    n_pad = T.levels[0].n_pad
    b = np.zeros(n_pad, np.float32)
    b[: hier.levels[0].n] = np.random.default_rng(0).standard_normal(
        hier.levels[0].n)
    jp = _jax(p)
    jcyc = jax.jit(jcycles.make_cycle(jp))
    want = jcyc(J.levels, jnp.asarray(b))
    got = cycles.make_cycle(p)(T.levels, torch.from_numpy(b))
    _close(got, want)
    # from a nonzero start too (the pre-smoother's fused residual path)
    x0 = (0.1 * b).astype(np.float32)
    want = jax.jit(lambda lv, r, x: jcycles._cycle(lv, 0, r, x, jp, shape))(
        J.levels, jnp.asarray(b), jnp.asarray(x0))
    got = cycles._cycle(T.levels, 0, torch.from_numpy(b),
                        torch.from_numpy(x0), p, shape)
    _close(got, want)


def _permuted_poisson2d(n=40, seed=3):
    """A bandwidth-scrambled operator: both solvers RCM-reorder it."""
    A = poisson2d(n).tocsr()
    perm = np.random.default_rng(seed).permutation(A.shape[0])
    return A[perm][:, perm].tocsr()


PROBLEMS = {"poisson3d(24)": lambda: poisson3d(24),
            "poisson2d(96)": lambda: poisson2d(96),
            "permuted poisson2d(40)": _permuted_poisson2d}


@pytest.mark.parametrize("prob", PROBLEMS)
def test_flagship_solve_matches_jax(prob):
    A = PROBLEMS[prob]().tocsr()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    p = flagship.params(dense_size=256)
    ref = JaxSolver(A, _jax(p), jparams.KrylovParams(
        loop_mode="device")).solve(b)
    solver = AMGSolver(A, p, flagship.krylov(), device="cpu")
    res = solver.solve(b)
    assert (solver.perm is None) == (prob != "permuted poisson2d(40)")
    assert res.converged and ref.converged
    assert abs(res.iterations - ref.iterations) <= 1, (res, ref)
    assert res.refine_passes == ref.refine_passes, (res, ref)
    for r in (res, ref):
        assert np.linalg.norm(b - A @ r.x) / np.linalg.norm(b) <= 1e-8
    assert res.relres == pytest.approx(
        np.linalg.norm(b - A @ res.x) / np.linalg.norm(b), rel=1e-6)
    # a reused solver and a device-resident rhs give the same answer
    again = solver.solve(solver.prepare_rhs(b))
    assert again.iterations == res.iterations
    np.testing.assert_array_equal(again.x, res.x)


def test_solver_budget_and_floor_estimate():
    A = poisson3d(16)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    solver = AMGSolver(A, flagship.params(dense_size=256),
                       flagship.krylov(), device="cpu")
    res = solver.solve(b, maxiter=3)
    assert not res.converged and res.iterations <= 3
    # a budget-limited pass must not record an fp32 floor estimate
    assert solver._floor_est is None
    solver._note_pass_slack(1.0, 1e-2, 1e-5, budget_limited=True)
    assert solver._floor_est is None
    solver._note_pass_slack(1.0, 1e-2, 1e-5, budget_limited=False)
    assert solver._floor_est == pytest.approx(1e-2)
    assert solver._pass_tol(1e-8, 1e-4) == pytest.approx(3e-3)
    zero = solver.solve(np.zeros(A.shape[0]))
    assert zero.converged and zero.iterations == 0
    one_pass = AMGSolver(A, flagship.params(dense_size=256),
                         KrylovParams(refine=False, tol=1e-6),
                         device="cpu").solve(b)
    assert one_pass.converged and one_pass.refine_passes == 1


def test_device_bytes_counts_shared_bands_once():
    A = poisson3d(16)
    solver = AMGSolver(A, flagship.params(dense_size=256).replace(
        band_dtype="float32"), flagship.krylov(), device="cpu")
    L0 = solver.device.levels[0].A
    assert L0.bands is solver.A32.bands          # cast once, shared
    total = solver.device_bytes()
    assert total == tree_device_bytes(solver.device) + \
        solver.A64.bands.nbytes
    assert total > solver.A64.bands.nbytes + L0.bands.nbytes


def test_solver_needs_a_device_and_a_known_method():
    A = poisson2d(48)            # above coarse_size: a real cycle
    with pytest.raises(TypeError):
        AMGSolver(A, AMGParams())            # no device: no silent CPU
    with pytest.raises(ValueError, match="Krylov method"):
        AMGSolver(A, AMGParams(), KrylovParams(method="gmres"),
                  device="cpu")
