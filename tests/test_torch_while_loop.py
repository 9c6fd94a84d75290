"""The device loop mode as the JAX package runs it (each refinement pass
one loop while ``krylov.loop_continue`` holds: a CUDA graph WHILE node on
the card, a Python loop here) and the host mode's fused pass start and
finish, on the CPU.

* one eager device-mode pass against the JAX package's
  ``_inner_solve_dev`` (its ``lax.while_loop``) on the same fp32
  right-hand side, and the whole device-mode solve against the JAX
  package's, for CG, BiCGStab and the stationary iteration on small
  Poisson and elasticity problems: the same iterations and passes;
* ``loop_continue`` on a met or zero right-hand side, the budget,
  non-finite ||r||^2 and a breakdown, in agreement with ``masked``, and
  what a pass runs in each case;
* the host mode (its start replayed back to back with its first chunk,
  its finish writing the true ||r||^2) against the host mode as it ran
  with every piece launched on its own: the same counts, history and x
  bits.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functools import partial

from sparsh_amg_tpu import params as jparams
from sparsh_amg_tpu.models.elasticity import (elasticity2d,
                                              elasticity2d_nullspace)
from sparsh_amg_tpu.models.poisson import poisson2d
from sparsh_amg_tpu.solve.solver import AMGSolver as JaxSolver
from sparsh_amg_tpu_torch import AMGSolver
from sparsh_amg_tpu_torch.ops.blas import dot
from sparsh_amg_tpu_torch.ops.fp64 import residual64
from sparsh_amg_tpu_torch.ops.formats import spmv
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
    kr = KrylovParams(method=method, loop_mode="device", maxiter=300)
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
    iters, rnsq, steps, reads = port._pass(loop, True, 1e-6, 300)
    x = loop.x64.numpy()[:n]
    xj, itj, _ = jax_._inner_solve_dev(
        jax_.device.levels, jax_.A_df.A_hi,
        jnp.asarray(_padded(b, jax_.n_pad, np.float32)), 1e-6, 300)
    xj = np.asarray(xj, np.float64)[:n]
    # eagerly the guard is read after every step, and prog once
    assert iters == int(itj) > 0 and steps == iters and reads == iters + 2
    assert np.linalg.norm(x - xj) <= 1e-4 * np.linalg.norm(xj)
    np.testing.assert_allclose(
        rnsq, np.linalg.norm(b - A @ x) ** 2, rtol=1e-6)

    got, want = port.solve(b), jax_.solve(b)
    assert got.converged and want.converged
    assert (got.iterations, got.refine_passes) == \
        (want.iterations, want.refine_passes), (got.history, want.history)
    assert np.linalg.norm(got.x - want.x) <= 1e-6 * np.linalg.norm(want.x)
    assert got.masked_steps == 0
    assert got.host_reads == got.iterations + 2 * got.refine_passes


def _state(method, case):
    """A Krylov state of `method` after two steps on a small operator, and
    its guard (target, budget) for `case`."""
    rng = np.random.default_rng(1)
    n = 40
    A = rng.standard_normal((n, n)) * 0.3 + np.diag(np.full(n, 4.0))
    At = torch.from_numpy(A.astype(np.float32))
    dinv = torch.from_numpy((1.0 / np.diag(A)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    chunks = {"cg": tk.pcg_chunk, "bicgstab": tk.bicgstab_chunk,
              "amg": tk.stationary_chunk}[method]
    mv, pc = (lambda v: At @ v), (lambda r: dinv * r)
    init, step = chunks(mv, pc, 1, dot)
    if method == "bicgstab":
        step = partial(step, b)
    st = list(step(step(init(b))))
    i_rr, i_k, i_brk = tk.READS[method]
    target = torch.zeros((), dtype=torch.float64)
    budget = torch.full((), 50.0, dtype=torch.float64)
    if case == "met":
        target.fill_(float(st[i_rr]))
    elif case == "zero_rhs":
        st = list(init(torch.zeros_like(b)))
    elif case == "budget":
        budget.fill_(int(st[i_k]))
    elif case in ("inf", "nan"):
        st[i_rr] = torch.tensor(float(case), dtype=torch.float32)
    elif case == "breakdown":
        st[i_brk] = torch.ones((), dtype=torch.bool)
    return tuple(st), (target, budget), step


# every method and case (a breakdown only BiCGStab reports)
GUARD_CASES = [(m, c) for m in ("cg", "bicgstab", "amg")
               for c in ("active", "met", "zero_rhs", "budget", "inf", "nan",
                         "breakdown") if c != "breakdown" or m == "bicgstab"]


@pytest.mark.parametrize("method,case", GUARD_CASES)
def test_loop_continue_cases_agree_with_masked(method, case):
    """loop_continue steps only while ||r||^2 is finite and above target, k
    below the budget and no breakdown is flagged; where it says stop, a
    masked step leaves every state bit as it was, and where it says go,
    the masked step is the plain step.  The guard's plain version (the
    CPU's loop_guard) decides the same and records (||r||^2, k,
    breakdown)."""
    st, guard, step = _state(method, case)
    go = tk.loop_continue(method, st, guard)
    assert go == (case == "active")
    new = tk.masked(step, method, guard)(st)
    want = step(st) if go else st
    for a, c in zip(new, want):
        torch.testing.assert_close(a, c, rtol=0, atol=0, equal_nan=True)
    prog = torch.zeros(5, dtype=torch.float64)
    assert bool(loop_guard(method, st, guard, prog)) == go
    i_rr, i_k, i_brk = tk.READS[method]
    assert prog[1] == int(st[i_k])
    assert prog[2] == (1.0 if case == "breakdown" else 0.0)
    torch.testing.assert_close(prog[0], st[i_rr].double(), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
def test_inplace_step_is_the_plain_step(method):
    """The loop body's step (krylov.step_inplace, the state's buffers
    updated in place) gives the plain step's bits in every state entry
    over five steps (PCG's z, which the next step recomputes, is not
    written), and a breakdown freezes x and r as the plain step does."""
    st, _, plain = _state(method, "active")
    rng = np.random.default_rng(1)
    n = 40
    A = rng.standard_normal((n, n)) * 0.3 + np.diag(np.full(n, 4.0))
    At = torch.from_numpy(A.astype(np.float32))
    dinv = torch.from_numpy((1.0 / np.diag(A)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    step = tk.step_inplace(lambda v: At @ v, lambda r: dinv * r, method, dot,
                           b)
    bufs = tuple(t.clone() for t in st)
    want = st
    for _ in range(5):
        want = plain(want)
        step(bufs)
        for i, (a, c) in enumerate(zip(bufs, want)):
            if not (method == "cg" and i == 2):
                torch.testing.assert_close(a, c, rtol=0, atol=0)
    if method == "bicgstab":
        bufs[9].fill_(True)
        x, r = bufs[0].clone(), bufs[1].clone()
        step(bufs)
        assert torch.equal(bufs[0], x) and torch.equal(bufs[1], r)


@pytest.mark.parametrize("case", ["zero_rhs", "met", "budget", "inf"])
def test_pass_runs_what_loop_continue_allows(case):
    """A pass on a zero right-hand side, on one that already meets its
    tolerance or that holds an infinity runs no step (lax.while_loop
    runs none; the host mode counts none on a zero one); a budget of 3
    stops it after 3."""
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
    iters, _, steps, reads = port._pass(loop, True, tol, budget)
    assert iters == steps == (3 if case == "budget" else 0)
    assert reads == iters + 2
    if case != "budget" and case != "inf":
        assert torch.count_nonzero(loop.x64).item() == 0
    if case == "zero_rhs":              # the host mode counts none either
        host = copy.copy(port)
        host.krylov = dataclasses.replace(port.krylov, loop_mode="host")
        assert host._pass(loop, True, tol, budget)[0] == 0


def _host_solve_unfused(s, b, tol=None, maxiter=None):
    """The host loop mode with each piece launched on its own, as the
    solver ran it before its start and finish were fused: the pass's
    right-hand side cast eagerly, the Krylov init, the chunks sized by the
    same scheduler, then x += d, the fp64 residual and its norm, read on
    the host.  Returns (x, iterations, passes, history)."""
    kr = s.krylov
    tol = kr.tol if tol is None else tol
    maxiter = kr.maxiter if maxiter is None else maxiter
    method = kr.method
    chunks = {"cg": tk.pcg_chunk, "bicgstab": tk.bicgstab_chunk,
              "amg": tk.stationary_chunk}[method]
    mv = partial(spmv, s._krylov_op)
    pc = partial(s._cycle, s.device.levels)
    i_rr, i_k, i_brk = tk.READS[method]
    rhs = s.prepare_rhs(b)
    b64, bnorm = rhs.b, rhs.bnorm

    def inner(r, itol, budget, first):
        b32 = torch.zeros(s.n_pad, dtype=torch.float32)
        b32.copy_(r)
        init, _ = chunks(mv, pc, 1, s._dot)
        state = init(b32)
        rr0 = float(state[i_rr])
        k = s._first_chunk(itol, first)
        while True:
            _, chunk = chunks(mv, pc, k, s._dot)
            state = chunk(b32, state) if method == "bicgstab" \
                else chunk(state)
            rr, iters = float(state[i_rr]), int(state[i_k])
            broken = i_brk is not None and bool(state[i_brk])
            if rr0 == 0.0:
                return state[0], 0
            target = (itol * itol) * rr0
            if iters > 0 and 0.0 < rr < rr0:
                s._rho2_est = float((rr / rr0) ** (1.0 / iters))
            if (rr <= target or not np.isfinite(rr) or iters >= budget
                    or broken):
                return state[0], iters
            rho2 = s._rho2_est
            if rho2 is not None and 0.0 < rho2 < 1.0 and target > 0.0:
                need = int(np.ceil(np.log(target / rr) / np.log(rho2)))
                k = tsolver._pick_chunk(max(need, 1), kr.chunk)
            elif iters == 0:
                k = min(tsolver._TAILS[-1], kr.chunk)
            else:
                k = kr.chunk

    x = torch.zeros_like(b64)
    r = b64
    history, total, passes, relres = [], 0, 0, 1.0
    for _ in range(kr.max_refine):
        budget = maxiter - total
        if budget <= 0:
            break
        itol = s._pass_tol(tol, relres)
        d, iters = inner(r, itol, budget, passes == 0)
        x += d
        r = residual64(s.A64, b64, x)
        rnsq = s._dot(r, r).item()
        passes += 1
        total += iters
        prev, relres = relres, float(np.sqrt(max(rnsq, 0.0))) / bnorm
        s._note_pass_slack(prev, relres, itol, budget_limited=iters >= budget)
        history.append((iters, relres))
        if relres <= tol:
            break
    return s._unperm(x[: s.n].numpy()), total, passes, history


@pytest.mark.parametrize("chunk", [4, 12])
@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
def test_fused_host_mode_is_the_unfused_one(method, chunk):
    """The host mode with its start and finish as whole pieces (the
    start replayed back to back with the first chunk, the finish's norm
    read from prog) gives the unfused host mode's counts, history and x
    bits, on a cold solver and again on the same solver warm."""
    A = poisson2d(32)
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    kr = KrylovParams(method=method, loop_mode="host", chunk=chunk,
                      maxiter=200)
    s = AMGSolver(A, AMGParams(coarse_size=40), kr, device="cpu")
    ref = copy.copy(s)
    ref._reset_loop_state()
    for _ in range(2):
        got = s.solve(b)
        x, iters, passes, history = _host_solve_unfused(ref, b)
        assert (got.iterations, got.refine_passes, got.history) == \
            (iters, passes, history)
        np.testing.assert_array_equal(got.x, x)
        assert got.converged and got.masked_steps == 0
        assert got.host_reads >= 2 * got.refine_passes


def _parent_finish_fn(loop, bufs):
    """The loop's finish as it was composed before the finish had a
    kernel: x64 + x, the fp64 residual and its norm, copied back."""
    x = loop.x64 + loop.state[0]
    r = residual64(loop._A64, loop.b64, x)
    return x, r, loop._dot(r, r).reshape(1)


@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
@pytest.mark.parametrize("name", ["poisson2d", "elasticity2d"])
def test_device_mode_solve_keeps_the_parent_finish(name, method,
                                                   monkeypatch):
    """The eager device-mode solve through ops.fp64.finish64 takes the
    iterations, passes and history of the same solve with the loop's
    finish composed as before, and gives x with the same bits."""
    A, ns, p = _problem(name)
    kr = KrylovParams(method=method, loop_mode="device", maxiter=300)
    s = AMGSolver(A, p, kr, nullspace=ns, device="cpu")
    ref = copy.copy(s)
    ref._reset_loop_state()
    b = np.random.default_rng(7).standard_normal(A.shape[0])
    got = s.solve(b)
    monkeypatch.setattr(tsolver._Loop, "_finish_fn", _parent_finish_fn)
    want = ref.solve(b)
    assert got.converged and want.converged
    assert (got.iterations, got.refine_passes, got.history) == \
        (want.iterations, want.refine_passes, want.history)
    np.testing.assert_array_equal(got.x, want.x)
