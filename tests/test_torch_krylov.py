"""The port's BiCGStab and stationary iterations (``solve/krylov.py``: the
init and the in-place step on the state's buffers, as the loop runs
them) against the JAX package's on the same small dense nonsymmetric
operator and Jacobi preconditioner: five steps from the same right-hand
side give the same state at rtol 1e-5 (fp32 sums in another order), with
the same iteration count, and a BiCGStab breakdown (a shadow residual
orthogonal to r) freezes x and r in both."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sparsh_amg_tpu.ops.blas import dot as jdot
from sparsh_amg_tpu.solve import krylov as jk
from sparsh_amg_tpu_torch.ops.blas import dot as tdot
from sparsh_amg_tpu_torch.solve import krylov as tk


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these sizes it is faster than the default
    pool, and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 40
RTOL = 1e-5


def _operator(seed=0):
    """A diagonally dominant nonsymmetric matrix, its inverse diagonal and
    a right-hand side, in fp32."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N)) * 0.3 + np.diag(np.full(N, 4.0))
    A[np.abs(A) < 0.25] = 0.0
    dinv = 1.0 / np.diag(A)
    b = rng.standard_normal(N)
    return A.astype(np.float32), dinv.astype(np.float32), b.astype(np.float32)


def _ops(A, dinv):
    At, dt = torch.from_numpy(A), torch.from_numpy(dinv)
    Aj, dj = jnp.asarray(A), jnp.asarray(dinv)
    return ((lambda v: At @ v), (lambda r: dt * r),
            (lambda v: Aj @ v), (lambda r: dj * r))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


def _buffers(state):
    """The state as the loop holds it: each entry a buffer of its own."""
    return [t.clone() for t in state]


def _same_state(ts, js):
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        if isinstance(t, int):
            assert t == int(j)
        elif t.dtype == torch.bool:
            assert bool(t) == bool(j)
        else:
            _close(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("compensated", [False, True])
def test_bicgstab_steps_match_jax(compensated):
    A, dinv, b = _operator()
    tmv, tpc, jmv, jpc = _ops(A, dinv)
    td = lambda x, y: tdot(x, y, compensated)
    jd = lambda x, y: jdot(x, y, compensated=compensated)
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    ts = _buffers(tk.bicgstab_init(tmv, bt, td))
    js = jk.bicgstab_init(jmv, bj, jd)
    _same_state(ts, js)
    for _ in range(5):
        tk.bicgstab_step_(tmv, tpc, td, bt, ts)
        js = jk.bicgstab_step(jmv, jpc, jd, bj, js)
        _same_state(ts, js)
    assert ts[8] == 5 and not bool(ts[9])
    # it converges: ||r||^2 fell by orders of magnitude
    assert float(ts[7]) < 1e-6 * float(np.dot(b, b))


def test_bicgstab_breakdown_freezes_the_state():
    """rhat orthogonal to r gives rho == 0: the flag is set, x and r keep
    their values at that step and every later one, as in the JAX
    package."""
    A, dinv, b = _operator(1)
    tmv, tpc, jmv, jpc = _ops(A, dinv)
    rhat = np.zeros(N, np.float32)
    rhat[0], rhat[1] = b[1], -b[0]           # rhat . b == 0 exactly
    rt, rj = torch.from_numpy(rhat), jnp.asarray(rhat)
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    ts = _buffers(tk.bicgstab_init(tmv, bt, tdot))
    js = jk.bicgstab_init(jmv, bj, jdot)
    for _ in range(3):
        tk.bicgstab_step_(tmv, tpc, tdot, rt, ts)
        js = jk.bicgstab_step(jmv, jpc, jdot, rj, js)
        assert bool(ts[9]) and bool(js[9])
        np.testing.assert_array_equal(ts[0].numpy(), np.zeros(N))
        np.testing.assert_array_equal(ts[1].numpy(), b)
        np.testing.assert_array_equal(np.asarray(js[1]), b)
    assert ts[8] == int(js[8]) == 3


def test_stationary_steps_match_jax():
    A, dinv, b = _operator(2)
    tmv, tpc, jmv, jpc = _ops(A, dinv)
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    ts = _buffers(tk.stationary_init(tmv, tpc, bt, tdot))
    js = jk.stationary_init(jmv, jpc, bj, jdot)
    _same_state(ts, js)
    for _ in range(5):
        tk.stationary_step_(tmv, tpc, tdot, ts)
        js = jk.stationary_step(jmv, jpc, jdot, js)
        _same_state(ts, js)
    assert ts[3] == 5
    assert float(ts[2]) < float(np.dot(b, b))


def test_solver_stops_on_breakdown(monkeypatch):
    """The solver's loop ends a BiCGStab pass at the first step that
    reports a breakdown (the loop condition sees the flag and no step runs
    after it), read in the pass's one sync with ||r||^2."""
    from sparsh_amg_tpu.models.poisson import poisson2d
    from sparsh_amg_tpu_torch import AMGSolver
    from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
    real = tk.bicgstab_step_

    def broken(*args):
        real(*args)
        args[-1][9].fill_(True)
    monkeypatch.setattr(tk, "bicgstab_step_", broken)
    s = AMGSolver(poisson2d(32), AMGParams(coarse_size=64, dense_size=256),
                  KrylovParams(method="bicgstab", refine=False),
                  device="cpu")
    b = torch.zeros(s.n_pad, dtype=torch.float64)
    b[: s.n] = 1.0
    loop = s._loop()
    loop.b64.copy_(b)
    iters, rnsq, reads = s._pass(loop, True, 1e-8, 50)
    rr, k, brk, rr0, _ = loop.prog.tolist()
    assert iters == k == 1 and brk == 1.0 and 0.0 < rr / rr0 < 1.0
    assert reads == iters + 2 and rnsq > 0.0
