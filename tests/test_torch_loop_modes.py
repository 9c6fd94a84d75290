"""The port's Krylov loop placement (``KrylovParams.loop_mode`` and
``chunk``) against the JAX package's on the CPU, on the same seeded
inputs: the device mode's counts are the JAX device mode's (+-1 CG, +-2
BiCGStab, the same passes), the host mode lands within one iteration per
pass of the device mode and of the JAX host mode, chunk 12 on a cold
solver and "auto" behave as in the JAX package, and the stationary
iteration runs in both modes.  The device mode (one loop per pass, a
step at a time) gives the bits of ``chunk=1``; a predicated step past
convergence changes nothing;
``_pick_chunk`` is the JAX package's; ``counted()`` sees the plain
versions' zero launches.  The tests mirror ``tests/test_aux.py:89-147``
and ``tests/test_solver.py:224-246``.

Importing this module limits numpy's and scipy's OpenBLAS to one thread
for the rest of the process.  Every pytest-xdist worker imports every
test module while it collects, so the whole Tier-1 run takes one BLAS
thread per worker: six workers already share the cores, and a
multithreaded OpenBLAS call after the forked ranks of
``tests/test_blocked.py`` (``setup/comm.py:219``) waits forever, which
hung the run whenever ``tests/test_configs.py`` followed on the same
worker."""
import dataclasses

import numpy as np
import pytest
import scipy.linalg  # noqa: F401 -- loads scipy's OpenBLAS before the limit
import threadpoolctl
import torch

from sparsh_amg_tpu import params as jparams
from sparsh_amg_tpu.models.poisson import poisson2d, poisson3d
from sparsh_amg_tpu.solve import solver as jsolver
from sparsh_amg_tpu_torch import AMGSolver
from sparsh_amg_tpu_torch.ops import counted
from sparsh_amg_tpu_torch.ops.blas import dot
from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
from sparsh_amg_tpu_torch.solve import krylov as tk
from sparsh_amg_tpu_torch.solve import solver as tsolver
from sparsh_amg_tpu_torch.solve.graphs import ChunkGraph

threadpoolctl.threadpool_limits(1, user_api="blas")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these sizes it is faster than the default
    pool, and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(A, b, p, **kw):
    """{mode: (port result, JAX result)} for the host and device modes."""
    out = {}
    for mode in ("host", "device"):
        kr = KrylovParams(loop_mode=mode, **kw)
        port = AMGSolver(A, p, kr, device="cpu").solve(b)
        jax_ = jsolver.AMGSolver(
            A, jparams.AMGParams(**dataclasses.asdict(p)),
            jparams.KrylovParams(**dataclasses.asdict(kr))).solve(b)
        out[mode] = (port, jax_)
    return out


def _relres(A, b, r):
    return np.linalg.norm(b - A @ r.x) / np.linalg.norm(b)


def _held(runs, A, b, slack=1):
    """Converged, relres <= 1e-8; device counts the JAX device mode's;
    host within one iteration per pass of the port's device mode and of
    the JAX host mode, with the same passes."""
    (ph, jh), (pd, jd) = runs["host"], runs["device"]
    for r in (ph, jh, pd, jd):
        assert r.converged and _relres(A, b, r) <= 1e-8, r
    assert pd.refine_passes == jd.refine_passes
    assert abs(pd.iterations - jd.iterations) <= slack, (pd, jd)
    assert ph.refine_passes == pd.refine_passes == jh.refine_passes
    assert ph.iterations <= pd.iterations + ph.refine_passes
    assert abs(ph.iterations - jh.iterations) <= ph.refine_passes, \
        (ph.history, jh.history)
    assert pd.masked_steps == 0 and ph.masked_steps == 0


def test_host_device_loop_modes_agree():
    """test_aux.py:89-101: poisson2d(32), CG, chunk 4."""
    A = poisson2d(32)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    _held(_both(A, b, AMGParams(coarse_size=40)), A, b)


def test_host_chunk_scheduler_tight_and_auto_mode():
    """test_aux.py:104-124: the flagship's coarsening on poisson3d(20),
    chunk 12 on a cold solver; "auto" resolves at construction (a CPU
    launch and scalar read take microseconds: device) and converges."""
    A = poisson3d(20)
    b = np.random.default_rng(7).standard_normal(A.shape[0])
    p = AMGParams(smoother="chebyshev", coarsening="pmis",
                  interpolation="extpi", interp_max=4, rap_drop_tol=0.01,
                  agg_levels=1, interp_max_composed=5, aggressive="pmis2",
                  coarse_size=400)
    _held(_both(A, b, p, chunk=12), A, b)
    auto = AMGSolver(A, p, KrylovParams(loop_mode="auto"), device="cpu")
    assert auto.krylov.loop_mode == "device"
    assert auto.solve(b).converged


def test_bicgstab_host_mode():
    """test_aux.py:140-147: BiCGStab in both modes on poisson2d(24)."""
    A = poisson2d(24)
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    _held(_both(A, b, AMGParams(coarse_size=40), method="bicgstab"), A, b,
          slack=2)


def test_stationary_amg_solve_modes_agree():
    """test_solver.py:224-246: the stationary iteration (method "amg")
    converges in both modes, the host mode within its chunk overrun of
    the device mode, and PCG needs fewer iterations."""
    A = poisson2d(40)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    p = AMGParams(smoother="chebyshev")
    runs = _both(A, b, p, method="amg", maxiter=200)
    _held(runs, A, b)
    assert abs(runs["host"][0].iterations
               - runs["device"][0].iterations) <= 4
    pcg = AMGSolver(A, p, KrylovParams(loop_mode="device"),
                    device="cpu").solve(b)
    assert pcg.iterations < runs["device"][0].iterations


@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
def test_device_mode_gives_the_bits_of_chunk_one(method):
    """Device mode at chunks 1, 4 and 12 (its loop steps one at a time
    whatever the chunk) returns the same x, counts and history as the
    host loop that reads the host after every iteration (chunk 1)."""
    A = poisson2d(32)
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    p = AMGParams(coarse_size=40)
    res = {}
    for mode, chunk in (("host", 1), ("device", 1), ("device", 4),
                        ("device", 12)):
        kr = KrylovParams(method=method, loop_mode=mode, chunk=chunk,
                          maxiter=200)
        res[(mode, chunk)] = AMGSolver(A, p, kr, device="cpu").solve(b)
    one = res[("host", 1)]
    assert one.converged and one.masked_steps == 0
    for key, r in res.items():
        np.testing.assert_array_equal(r.x, one.x, err_msg=str(key))
        assert (r.iterations, r.refine_passes, r.history) == \
            (one.iterations, one.refine_passes, one.history), key


def _operator(seed=0, n=40):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) * 0.3 + np.diag(np.full(n, 4.0))
    return (torch.from_numpy(A.astype(np.float32)),
            torch.from_numpy((1.0 / np.diag(A)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)))


@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
def test_masked_step_past_convergence_changes_nothing(method):
    """A predicated step whose guard is off (||r||^2 at or below the
    target, or k at the budget) leaves every state entry bit for bit
    unchanged, k included; with the guard on it gives the plain step's
    bits and counts one."""
    A, dinv, b = _operator(1)
    chunks = {"cg": tk.pcg_chunk, "bicgstab": tk.bicgstab_chunk,
              "amg": tk.stationary_chunk}[method]
    mv, pc = (lambda v: A @ v), (lambda r: dinv * r)
    target = torch.zeros((), dtype=torch.float64)
    budget = torch.full((), 50, dtype=torch.int32)
    init, plain = chunks(mv, pc, 1, dot)
    _, guarded = chunks(mv, pc, 1, dot, guard=(target, budget))
    if method == "bicgstab":
        plain, guarded = (lambda st, f=plain: f(b, st)), \
            (lambda st, f=guarded: f(b, st))
    i_rr, i_k, _ = tk.READS[method]
    st = plain(plain(init(b)))
    for a, c in zip(guarded(st), plain(st)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    target.fill_(float(st[i_rr]))                   # converged: off
    for a, c in zip(guarded(st), st):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    target.zero_()
    budget.fill_(int(st[i_k]))                      # budget spent: off
    assert int(guarded(st)[i_k]) == int(st[i_k]) == 2


@pytest.mark.parametrize("main", [1, 4, 12])
def test_pick_chunk_is_the_jax_schedulers(main):
    """_pick_chunk and the tail ladder are the JAX package's, and
    chunk_sizes lists every size the scheduler can pick (the graphs
    warm() captures)."""
    assert tsolver._TAILS == jsolver._TAILS
    picked = set()
    for need in range(1, 41):
        k = tsolver._pick_chunk(need, main)
        assert k == jsolver._pick_chunk(need, main), need
        picked.add(k)
    picked.add(min(tsolver._TAILS[-1], main))       # the cold probe
    assert set(tsolver.chunk_sizes(main)) == picked


def test_counted_on_the_cpu_and_eager_chunks():
    """On the CPU a ChunkGraph runs its function eagerly and records no
    replay launches; counted() sees the plain versions' zero launches
    over a solve in either mode; unknown placements raise."""
    A = poisson2d(16)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    for mode in ("host", "device"):
        s = AMGSolver(A, AMGParams(coarse_size=40),
                      KrylovParams(loop_mode=mode), device="cpu")
        res, launches = counted(lambda: s.solve(b))
        assert res.converged and not any(launches.values())
        assert set(launches) >= {"dia_spmv", "ell_spmv", "block_ell_spmv"}
        graphs = [g for lp in s._loops.values() for g in lp.all_graphs()]
        assert graphs and all(g.graph is None and g.per_replay == {}
                              for g in graphs)
        assert s.graph_seconds() == (0.0, 0.0)
    buf = (torch.zeros(3),)
    g = ChunkGraph(lambda bufs: (bufs[0] + 1,), buf, capture=False)
    g.run()
    g.run()
    assert buf[0].tolist() == [2.0, 2.0, 2.0]
    for bad in ({"loop_mode": "while"}, {"chunk": 0}):
        with pytest.raises(ValueError):
            AMGSolver(A, AMGParams(coarse_size=40), KrylovParams(**bad),
                      device="cpu")
