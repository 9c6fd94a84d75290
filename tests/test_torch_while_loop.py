"""The Krylov loop as the JAX package's device mode runs it (each
refinement pass one loop while ``krylov.loop_continue`` holds: a CUDA
graph WHILE node on the card, a Python loop here), on the CPU.

* one eager pass against the JAX package's ``_inner_solve_dev`` (its
  ``lax.while_loop``) on the same fp32 right-hand side, and the whole
  solve against the JAX package's device mode, for CG, BiCGStab and the
  stationary iteration on small Poisson and elasticity problems: the
  same iterations and passes;
* ``loop_continue`` and the guard's plain version on a met or zero
  right-hand side, the budget, non-finite ||r||^2 and a breakdown, and
  what a pass runs in each case;
* the in-place steps against the JAX package's steps, and the solve
  through ``ops.fp64.finish64`` against the finish composed as before.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsh_amg_tpu import params as jparams
from sparsh_amg_tpu.models.elasticity import (elasticity2d,
                                              elasticity2d_nullspace)
from sparsh_amg_tpu.models.poisson import poisson2d
from sparsh_amg_tpu.ops.blas import dot as jdot
from sparsh_amg_tpu.solve import krylov as jk
from sparsh_amg_tpu.solve.solver import AMGSolver as JaxSolver
from sparsh_amg_tpu_torch import AMGSolver
from sparsh_amg_tpu_torch.ops.blas import dot
from sparsh_amg_tpu_torch.ops.fp64 import residual64
from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
from sparsh_amg_tpu_torch.solve import krylov as tk
from sparsh_amg_tpu_torch.solve import solver as tsolver
from sparsh_amg_tpu_torch.solve.graphs import loop_guard


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these sizes it is faster than the default
    pool, and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(name):
    """(A, near-nullspace, params) of a small problem."""
    if name == "poisson2d":
        return poisson2d(32), None, AMGParams(coarse_size=40)
    return elasticity2d(12), elasticity2d_nullspace(12), AMGParams(
        coarsening="aggregation", interpolation="smoothed",
        smoother="chebyshev", coarse_size=40, agg_blocksize=2,
        p_smooth_filter=False)


def _solvers(name, method):
    A, ns, p = _problem(name)
    kr = KrylovParams(method=method, maxiter=300)
    port = AMGSolver(A, p, kr, nullspace=ns, device="cpu")
    jax_ = JaxSolver(A, jparams.AMGParams(**dataclasses.asdict(p)),
                     jparams.KrylovParams(**dataclasses.asdict(kr)),
                     nullspace=ns)
    return A, port, jax_


def _padded(b, n_pad, dtype):
    out = np.zeros(n_pad, dtype=dtype)
    out[: b.size] = b
    return out


@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
@pytest.mark.parametrize("name", ["poisson2d", "elasticity2d"])
def test_eager_pass_is_the_jax_while_loop(name, method):
    """One pass from x = 0 on the same fp32 right-hand side takes the
    iterations of the JAX package's lax.while_loop, and its x agrees
    within 1e-4 relative (an fp32 iterate stopped at ||r|| <= 1e-6 ||b||,
    its sums in another order); the whole solve takes the JAX device
    mode's iterations and passes, x within 1e-6 relative."""
    A, port, jax_ = _solvers(name, method)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    n = A.shape[0]
    loop = port._loop()
    loop.b64.copy_(torch.from_numpy(_padded(b, port.n_pad, np.float64)))
    iters, rnsq, reads = port._pass(loop, True, 1e-6, 300)
    x = loop.x64.numpy()[:n]
    xj, itj, _ = jax_._inner_solve_dev(
        jax_.device.levels, jax_.A_df.A_hi,
        jnp.asarray(_padded(b, jax_.n_pad, np.float32)), 1e-6, 300)
    xj = np.asarray(xj, np.float64)[:n]
    # eagerly the guard is read after every step, and prog once
    assert iters == int(itj) > 0 and reads == iters + 2
    assert np.linalg.norm(x - xj) <= 1e-4 * np.linalg.norm(xj)
    np.testing.assert_allclose(
        rnsq, np.linalg.norm(b - A @ x) ** 2, rtol=1e-6)

    got, want = port.solve(b), jax_.solve(b)
    assert got.converged and want.converged
    assert (got.iterations, got.refine_passes) == \
        (want.iterations, want.refine_passes), (got.history, want.history)
    assert np.linalg.norm(got.x - want.x) <= 1e-6 * np.linalg.norm(want.x)
    assert got.host_reads == got.iterations + 2 * got.refine_passes


def _operator():
    """A diagonally dominant nonsymmetric matrix, its inverse diagonal and
    a right-hand side, in fp32 numpy arrays."""
    rng = np.random.default_rng(1)
    n = 40
    A = rng.standard_normal((n, n)) * 0.3 + np.diag(np.full(n, 4.0))
    return (A.astype(np.float32), (1.0 / np.diag(A)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _init(method, mv, pc, b, init_dot=dot):
    """A method's initial state, each entry a buffer of its own (as the
    loop holds it)."""
    st = {"cg": lambda: tk.pcg_init(mv, pc, b, init_dot),
          "bicgstab": lambda: tk.bicgstab_init(mv, b, init_dot),
          "amg": lambda: tk.stationary_init(mv, pc, b, init_dot)}[method]()
    return [t.clone() for t in st]


def _state(method, case):
    """A Krylov state of `method` after two in-place steps on a small
    operator, and its guard (target, budget) for `case`."""
    A, dinv, b = map(torch.from_numpy, _operator())
    mv, pc = (lambda v: A @ v), (lambda r: dinv * r)
    step = tk.step_inplace(mv, pc, method, dot, b)
    st = _init(method, mv, pc, b)
    step(st)
    step(st)
    i_rr, i_k, i_brk = tk.READS[method]
    target = torch.zeros((), dtype=torch.float64)
    budget = torch.full((), 50.0, dtype=torch.float64)
    if case == "met":
        target.fill_(float(st[i_rr]))
    elif case == "zero_rhs":
        st = _init(method, mv, pc, torch.zeros_like(b))
    elif case == "budget":
        budget.fill_(int(st[i_k]))
    elif case in ("inf", "nan"):
        st[i_rr] = torch.tensor(float(case), dtype=torch.float32)
    elif case == "breakdown":
        st[i_brk] = torch.ones((), dtype=torch.bool)
    return tuple(st), (target, budget)


# every method and case (a breakdown only BiCGStab reports)
GUARD_CASES = [(m, c) for m in ("cg", "bicgstab", "amg")
               for c in ("active", "met", "zero_rhs", "budget", "inf", "nan",
                         "breakdown") if c != "breakdown" or m == "bicgstab"]


@pytest.mark.parametrize("method,case", GUARD_CASES)
def test_loop_continue_cases_agree_with_masked(method, case):
    """loop_continue steps only while ||r||^2 is finite and above target, k
    below the budget and no breakdown is flagged.  The guard's plain
    version (the CPU's loop_guard) decides the same and records (||r||^2,
    k, breakdown)."""
    st, guard = _state(method, case)
    go = tk.loop_continue(method, st, guard)
    assert go == (case == "active")
    prog = torch.zeros(5, dtype=torch.float64)
    assert bool(loop_guard(method, st, guard, prog)) == go
    i_rr, i_k, i_brk = tk.READS[method]
    assert prog[1] == int(st[i_k])
    assert prog[2] == (1.0 if case == "breakdown" else 0.0)
    torch.testing.assert_close(prog[0], st[i_rr].double(), rtol=0, atol=0,
                               equal_nan=True)


def _jax_step(method, mv, pc, rhat):
    """The JAX package's functional step of `method`."""
    if method == "bicgstab":
        return lambda st: jk.bicgstab_step(mv, pc, jdot, rhat, st)
    step = {"cg": jk.pcg_step, "amg": jk.stationary_step}[method]
    return lambda st: step(mv, pc, jdot, st)


@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
def test_inplace_step_is_the_plain_step(method):
    """The loop body's step (krylov.step_inplace, the state's buffers
    updated in place) takes the JAX package's functional step in every
    state entry over five steps from the same initial state, at rtol
    1e-5 (fp32 sums in another order; PCG's z, which the next step
    recomputes, is not written), with the same count; a breakdown
    freezes x and r."""
    A, dinv, b = _operator()
    At, dt, bt = map(torch.from_numpy, (A, dinv, b))
    Aj, dj, bj = map(jnp.asarray, (A, dinv, b))
    tmv, tpc = (lambda v: At @ v), (lambda r: dt * r)
    jmv, jpc = (lambda v: Aj @ v), (lambda r: dj * r)
    step = tk.step_inplace(tmv, tpc, method, dot, bt)
    plain = _jax_step(method, jmv, jpc, bj)
    bufs = _init(method, tmv, tpc, bt)
    want = {"cg": lambda: jk.pcg_init(jmv, jpc, bj, jdot),
            "bicgstab": lambda: jk.bicgstab_init(jmv, bj, jdot),
            "amg": lambda: jk.stationary_init(jmv, jpc, bj, jdot)}[method]()
    for _ in range(5):
        want = plain(want)
        step(bufs)
        for i, (a, c) in enumerate(zip(bufs, want)):
            if method == "cg" and i == 2:
                continue
            c = np.asarray(c)
            if a.dtype in (torch.bool, torch.int32):
                assert a.item() == c.item(), i
            else:
                np.testing.assert_allclose(
                    a.numpy().astype(np.float64), c.astype(np.float64),
                    rtol=1e-5, atol=1e-5 * max(np.abs(c).max(), 1e-30),
                    err_msg=str(i))
    assert int(bufs[tk.READS[method][1]]) == 5
    if method == "bicgstab":
        bufs[9].fill_(True)
        x, r = bufs[0].clone(), bufs[1].clone()
        step(bufs)
        assert torch.equal(bufs[0], x) and torch.equal(bufs[1], r)


@pytest.mark.parametrize("case", ["zero_rhs", "met", "budget", "inf"])
def test_pass_runs_what_loop_continue_allows(case):
    """A pass on a zero right-hand side, on one that already meets its
    tolerance or that holds an infinity runs no step (lax.while_loop
    runs none); a budget of 3 stops it after 3."""
    A, port, _ = _solvers("poisson2d", "cg")
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    if case == "zero_rhs":
        b[:] = 0.0
    elif case == "inf":
        b[5] = np.inf
    tol, budget = {"met": 2.0, "budget": 1e-12}.get(case, 1e-6), \
        3 if case == "budget" else 50
    loop = port._loop()
    loop.b64.copy_(torch.from_numpy(_padded(b, port.n_pad, np.float64)))
    iters, _, reads = port._pass(loop, True, tol, budget)
    assert iters == (3 if case == "budget" else 0)
    assert reads == iters + 2
    if case != "budget" and case != "inf":
        assert torch.count_nonzero(loop.x64).item() == 0


def _parent_finish(A64, x64, d, b64, b, rr, dot):
    """The loop's finish as it was composed before the finish had a
    kernel: x64 + x, the fp64 residual and its norm, copied back."""
    x = x64 + d
    r = residual64(A64, b64, x)
    return x, r, dot(r, r).reshape(1)


@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
@pytest.mark.parametrize("name", ["poisson2d", "elasticity2d"])
def test_device_mode_solve_keeps_the_parent_finish(name, method,
                                                   monkeypatch):
    """The eager solve through ops.fp64.finish64 takes the
    iterations, passes and history of the same solve with the loop's
    finish composed as before, and gives x with the same bits."""
    A, ns, p = _problem(name)
    kr = KrylovParams(method=method, maxiter=300)
    s = AMGSolver(A, p, kr, nullspace=ns, device="cpu")
    ref = copy.copy(s)
    ref._reset_loop_state()
    b = np.random.default_rng(7).standard_normal(A.shape[0])
    got = s.solve(b)
    monkeypatch.setattr(tsolver, "finish64", _parent_finish)
    want = ref.solve(b)
    assert got.converged and want.converged
    assert (got.iterations, got.refine_passes, got.history) == \
        (want.iterations, want.refine_passes, want.history)
    np.testing.assert_array_equal(got.x, want.x)
