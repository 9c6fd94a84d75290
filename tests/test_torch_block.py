"""The port's block-ELL SpMV and the systems (elasticity) path against the
JAX package, on the CPU.

* block_ell_plain against the Pallas block-GELL kernel in interpret mode
  (its streams reduced as BlockGellMatrix.spmv reduces them) and against
  the XLA gather, on elasticity operators, an SA coarse level with 6 dofs
  per node and a random block matrix with intra-block holes;
* to_device picks the block layout on exactly the levels where the JAX
  package, with the TPU layouts forced (SPARSH_FORCE_GELL=1), picks
  BlockGellMatrix;
* hierarchy_from_jax decodes GellMatrix, SplitGell and BlockGellMatrix
  into the stored values, and one V-cycle on that identical data agrees
  with the JAX make_cycle;
* elasticity solves take the JAX iteration count +-1 and the same
  refinement passes, both to relres <= 1e-8, and the 3-D Krylov matvec
  runs on level 0's block operator.

Tolerance: normwise rtol 1e-5 (the same fp32 values, summed in another
order)."""
import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import jax
import jax.numpy as jnp
import torch

from sparsh_amg_tpu.models.elasticity import elasticity2d, elasticity3d
from sparsh_amg_tpu.ops.block_gell import (_block_gather_xla,
                                           block_gell_pallas,
                                           csr_to_block_gell)
from sparsh_amg_tpu import params as jparams
from sparsh_amg_tpu.setup.hierarchy import amg_setup
from sparsh_amg_tpu.solve import cycles as jcycles
from sparsh_amg_tpu.solve import device as jdevice
from sparsh_amg_tpu.solve.solver import AMGSolver as JaxSolver
from sparsh_amg_tpu_torch import AMGSolver, systems, to_device
from sparsh_amg_tpu_torch.ops.block_ell import (BlockEllMatrix,
                                                block_ell_plain,
                                                block_ell_spmv,
                                                csr_to_block_ell)
from sparsh_amg_tpu_torch.solve import cycles, device


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these sizes it is faster than the default
    pool, and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-5

# small problems, and the dense threshold that keeps their systems levels
# sparse (L0 and L1 of e3d(10) block; L0 and L1 of e2d(24) DIA and block)
PROBLEMS = {"elasticity3d(10)": (3, 10, 256), "elasticity2d(24)": (2, 24, 128)}


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _jax(p):
    """The JAX package's AMGParams from the port's params' keywords."""
    return jparams.AMGParams(**dataclasses.asdict(p))


@functools.lru_cache(maxsize=None)
def _hierarchy(dim, m, dense_size):
    """(A, nullspace, the port's params, the JAX package's hierarchy)."""
    A, ns = systems.problem(dim, m)
    A = A.tocsr()
    p = systems.params(dim, dense_size=dense_size)
    return A, ns, p, amg_setup(A, _jax(p), nullspace=ns)


MATRICES = {
    "elasticity3d(6) bs3": lambda: (elasticity3d(6).tocsr(), 3),
    "SA coarse level bs6": lambda: (
        _hierarchy(3, 10, 256)[3].levels[1].A.tocsr(), 6),
    "elasticity2d(12) bs2": lambda: (elasticity2d(12).tocsr(), 2),
    # missing intra-block entries, as tests/test_block_gell.py
    "random holes bs3": lambda: (systems.random_blocks(70, 3, 1, 0.08), 3),
}
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _pair(mat, dt):
    A, bs = MATRICES[mat]()
    tdt, jdt = DTYPES[dt]
    B = csr_to_block_gell(A, bs, dtype=jdt)
    assert B is not None and B.bs == bs
    M = csr_to_block_ell(A, bs, tdt, device="cpu")
    assert M.bs == bs and M.k == B.k and M.n_pad == B.n_pad
    x = np.random.default_rng(1).standard_normal(M.n_pad).astype(np.float32)
    x[A.shape[1]:] = 0.0
    return A, B, M, x


def _reduce(B, streams):
    """BlockGellMatrix.spmv's reduction of (bs, slots) streams."""
    y = np.asarray(streams).reshape(B.bs, B.stream_rows, B.k).sum(axis=2)
    return y.T.reshape(-1)[: B.n_rows]


def _planes(B, x):
    nsrc = B.n_cols // B.bs
    planes = np.zeros((B.bs, B.src_pad), np.float32)
    planes[:, :nsrc] = x[: nsrc * B.bs].reshape(nsrc, B.bs).T
    return jnp.asarray(planes)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mat", MATRICES)
def test_block_plain_matches_block_gell_pallas(mat, dt):
    """The TPU kernel (interpret mode), reduced per row, gives the port's y."""
    A, B, M, x = _pair(mat, dt)
    out = block_gell_pallas(B.wwords, B.counts, B.packed, B.bvals,
                            _planes(B, x), s=B.s, tr=B.tr, wmode=B.wmode,
                            bs=B.bs, interpret=True)
    want = _reduce(B, np.asarray(out).transpose(1, 0, 2, 3).reshape(B.bs, -1))
    got = block_ell_plain(M.cols, M.vals, torch.from_numpy(x), M.lens)
    assert got.dtype == torch.float32 and got.shape == (M.n_pad,)
    _close(got[: A.shape[0]], want)
    assert not got[A.shape[0]:].any()


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mat", MATRICES)
def test_block_plain_matches_block_gather_xla(mat, dt):
    A, B, M, x = _pair(mat, dt)
    want = _reduce(B, _block_gather_xla(B, _planes(B, x)))
    got = M.spmv(torch.from_numpy(x))
    _close(got[: A.shape[0]], want)
    if dt == "fp32":
        _close(got[: A.shape[0]], A @ x[: A.shape[1]].astype(np.float64))


def test_block_wrapper_on_cpu_counts_nothing_and_checks():
    A, bs = MATRICES["random holes bs3"]()
    M = csr_to_block_ell(A, bs, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        M.n_pad).astype(np.float32))
    before = block_ell_spmv.launches
    torch.testing.assert_close(block_ell_spmv(M.cols, M.vals, M.lens, x),
                               block_ell_plain(M.cols, M.vals, x, M.lens),
                               rtol=0, atol=0)
    assert block_ell_spmv.launches == before
    with pytest.raises(ValueError):
        block_ell_spmv(M.cols.long(), M.vals, M.lens, x)
    with pytest.raises(ValueError):
        block_ell_spmv(M.cols, M.vals.double(), M.lens, x)
    with pytest.raises(ValueError):
        block_ell_spmv(M.cols, M.vals, M.lens, x.double())
    with pytest.raises(ValueError):
        block_ell_spmv(M.cols, M.vals, M.lens[1:], x)
    with pytest.raises(ValueError):           # no kernel for 1x1 blocks
        block_ell_spmv(M.cols, M.vals[:, :1].contiguous(), M.lens, x)
    with pytest.raises(ValueError):
        BlockEllMatrix(M.cols, M.vals, M.lens, M.n_rows,
                       M.n_cols).spmv(x[:10])
    # rows that do not split into blocks, or a block size with no kernel
    # instance: no block layout, as the JAX packer's None
    assert csr_to_block_ell(A[:-1, :-1], bs, device="cpu") is None
    assert csr_to_block_ell(sp.eye(14, format="csr"), 7, device="cpu") is None


def _holed(bs):
    """random_blocks with node rows 0 and 3 emptied (no block at all)."""
    A = systems.random_blocks(40, bs, 2, 0.1).tolil()
    for node in (0, 3):
        A[node * bs:(node + 1) * bs, :] = 0
    A = A.tocsr()
    A.eliminate_zeros()
    return A


@pytest.mark.parametrize("bs", [2, 3, 6])
def test_block_tables_row_lengths(bs):
    """lens counts each node row's blocks (0 for an empty node row), and
    no slot past it holds anything."""
    A = _holed(bs)
    M = csr_to_block_ell(A, bs, device="cpu")
    want = np.diff(A.tobsr(blocksize=(bs, bs)).indptr)
    lens = M.lens.numpy()
    assert lens.dtype == np.int32 and lens.shape == (M.cols.shape[1],)
    np.testing.assert_array_equal(lens, want)
    assert lens[0] == lens[3] == 0 and lens.max() == M.k
    past = np.arange(M.k)[:, None] >= lens[None, :]
    assert not M.cols.numpy()[past].any()
    vals = M.vals.numpy()[:, :, : M.n_rows].reshape(M.k, bs, -1, bs)
    assert not vals.transpose(0, 2, 1, 3)[past].any()
    assert not M.vals.numpy()[:, :, M.n_rows:].any()     # padding rows


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("bs", [2, 3, 6])
def test_block_plain_with_lens_equals_plain(bs, dt):
    M = csr_to_block_ell(_holed(bs), bs, DTYPES[dt][0], device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        M.n_pad).astype(np.float32))
    got = block_ell_plain(M.cols, M.vals, x, M.lens)
    assert torch.equal(got, block_ell_plain(M.cols, M.vals, x))
    assert not got[:bs].any() and not got[3 * bs: 4 * bs].any()  # empty
    assert not got[M.n_rows:].any()


@pytest.mark.parametrize("prob", PROBLEMS)
def test_hierarchy_from_jax_row_lengths(prob, monkeypatch):
    """hierarchy_from_jax sets lens on every ELL-T and block level, from
    the decoded TPU layouts, as to_device does from the host CSR."""
    monkeypatch.setenv("SPARSH_FORCE_GELL", "1")
    A, ns, p, hier = _hierarchy(*PROBLEMS[prob])
    T = device.hierarchy_from_jax(jdevice.to_device(hier, _jax(p)),
                                  device="cpu")
    H = to_device(hier, p, device="cpu")
    seen = set()
    for lt, lh in zip(T.levels, H.levels):
        for f in ("A", "P", "R"):
            mt, mh = getattr(lt, f), getattr(lh, f)
            if not hasattr(mt, "lens"):
                continue
            seen.add(type(mt).__name__)
            assert type(mt) is type(mh), f
            np.testing.assert_array_equal(mt.lens.numpy(), mh.lens.numpy())
    assert seen == {"EllMatrix", "BlockEllMatrix"}


def _decoded(M):
    kind = type(M).__name__
    return device._block_gell_csr(M) if kind == "BlockGellMatrix" \
        else device._gell_csr(M)


def _fp32_csr(A):
    A = A.tocsr().astype(np.float32).astype(np.float64)
    A.eliminate_zeros()
    return A


@pytest.mark.parametrize("prob", PROBLEMS)
def test_to_device_picks_block_layout_as_jax(prob, monkeypatch):
    monkeypatch.setenv("SPARSH_FORCE_GELL", "1")
    A, ns, p, hier = _hierarchy(*PROBLEMS[prob])
    J = jdevice.to_device(hier, _jax(p))
    T = to_device(hier, p, device="cpu")
    jk = [type(l.A).__name__ for l in J.levels]
    tk = [type(l.A).__name__ for l in T.levels]
    assert "BlockGellMatrix" in jk
    assert [k == "BlockGellMatrix" for k in jk] == \
        [k == "BlockEllMatrix" for k in tk], (jk, tk)
    for lev, lj, lt in zip(hier.levels, J.levels, T.levels):
        if isinstance(lt.A, BlockEllMatrix):
            assert lt.A.bs == lj.A.bs == lev.bs
            assert lt.A.n_pad == lj.A.n_pad and lt.A.k == lj.A.k
        assert lt.lam_max == float(lj.lam_max)
        np.testing.assert_array_equal(lt.dinv.numpy(), np.asarray(lj.dinv))


@pytest.mark.parametrize("prob", PROBLEMS)
def test_decoded_tpu_layouts_hold_the_host_values(prob, monkeypatch):
    """GellMatrix, SplitGell and BlockGellMatrix decode to the host CSR's
    fp32 values."""
    monkeypatch.setenv("SPARSH_FORCE_GELL", "1")
    A, ns, p, hier = _hierarchy(*PROBLEMS[prob])
    J = jdevice.to_device(hier, _jax(p))
    seen = set()
    for lev, lj in zip(hier.levels, J.levels):
        for f in ("A", "P", "R"):
            M = getattr(lj, f)
            kind = type(M).__name__
            if kind not in ("GellMatrix", "SplitGell", "BlockGellMatrix"):
                continue
            seen.add(kind)
            got = _decoded(M)
            want = _fp32_csr(getattr(lev, f))
            assert got.shape == want.shape
            assert abs(got - want).max() == 0.0, (kind, f)
    assert "BlockGellMatrix" in seen and seen & {"GellMatrix", "SplitGell"}


@pytest.mark.parametrize("band_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prob", PROBLEMS)
def test_vcycle_matches_jax_on_identical_data(prob, band_dtype, monkeypatch):
    monkeypatch.setenv("SPARSH_FORCE_GELL", "1")
    A, ns, p, hier = _hierarchy(*PROBLEMS[prob])
    p = p.replace(band_dtype=band_dtype)
    J = jdevice.to_device(hier, _jax(p))
    T = device.hierarchy_from_jax(J, device="cpu")
    assert [type(l.A).__name__ == "BlockGellMatrix" for l in J.levels] == \
        [isinstance(l.A, BlockEllMatrix) for l in T.levels]
    n_pad = T.levels[0].n_pad
    b = np.zeros(n_pad, np.float32)
    b[: A.shape[0]] = np.random.default_rng(0).standard_normal(A.shape[0])
    want = jax.jit(jcycles.make_cycle(_jax(p)))(J.levels, jnp.asarray(b))
    got = cycles.make_cycle(p)(T.levels, torch.from_numpy(b))
    _close(got, want)


@pytest.mark.parametrize("prob", PROBLEMS)
def test_systems_solve_matches_jax(prob, monkeypatch):
    """Prime at tol 1e-2, then solve to 1e-8 (run_configs_tpu.py:167-168),
    the JAX package with its TPU layouts forced."""
    monkeypatch.setenv("SPARSH_FORCE_GELL", "1")
    dim, m, dense_size = PROBLEMS[prob]
    A, ns, p, _ = _hierarchy(dim, m, dense_size)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    ref_solver = JaxSolver(A, _jax(p), jparams.KrylovParams(
        method="cg", tol=1e-8, maxiter=300, loop_mode="device"),
        nullspace=ns)
    solver = AMGSolver(A, p, systems.krylov(), nullspace=ns, device="cpu")
    results = []
    for s in (ref_solver, solver):
        s.solve(b, tol=1e-2)
        results.append(s.solve(b))
    ref, res = results
    assert res.converged and ref.converged
    assert abs(res.iterations - ref.iterations) <= 1, (res, ref)
    assert res.refine_passes == ref.refine_passes, (res, ref)
    for r in (res, ref):
        assert np.linalg.norm(b - A @ r.x) / np.linalg.norm(b) <= 1e-8
    # the Krylov matvec runs on level 0's block operator exactly where
    # the JAX package routes it through its fine cycle operator
    assert solver.mv_from_level0 == ref_solver._mv_from_level0 == (dim == 3)
    L0 = solver.device.levels[0].A
    assert isinstance(L0, BlockEllMatrix) == (dim == 3)
    if dim == 3:
        assert solver._krylov_op is L0 and solver.A32 is None


def test_krylov_matvec_goes_through_block_operator(monkeypatch):
    """On elasticity3d the fine block operator takes the Krylov matvec as
    well as the cycle's work: its SpMVs in one solve exceed the cycles'
    share by at least one per PCG iteration."""
    A, ns, p, hier = _hierarchy(3, 10, 256)
    solver = AMGSolver(A, p, systems.krylov(), hierarchy=hier, device="cpu")
    L0 = solver.device.levels[0].A
    calls = {"L0": 0, "cycles": 0}
    real_spmv, real_cycle = block_ell_spmv, solver._cycle

    def spmv(cols, vals, lens, x):
        calls["L0"] += cols is L0.cols
        return real_spmv(cols, vals, lens, x)

    def cycle(levels, r):
        calls["cycles"] += 1
        return real_cycle(levels, r)

    import sparsh_amg_tpu_torch.ops.block_ell as mod
    monkeypatch.setattr(mod, "block_ell_spmv", spmv)
    solver._cycle = cycle
    r = torch.ones(solver.n_pad)
    cycle(solver.device.levels, r)
    per_cycle = calls["L0"]
    assert per_cycle > 0
    calls.update(L0=0, cycles=0)
    res = solver.solve(np.random.default_rng(0).standard_normal(A.shape[0]))
    assert res.converged and res.iterations > 0
    assert calls["L0"] - per_cycle * calls["cycles"] >= res.iterations
