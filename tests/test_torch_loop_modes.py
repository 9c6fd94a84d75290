"""The port's one placement of the Krylov loop (each refinement pass one
device-resident loop, the JAX package's device loop mode) against the JAX
package's device mode on the CPU, on the same seeded inputs: the same
passes and iterations within +-1 (CG and the stationary iteration) or
+-2 (BiCGStab).  A solver built with default KrylovParams runs that loop;
any other placement is refused at construction; the benchmark's
configuration files load as KrylovParams; a second solve on one solver
reuses the loop's static buffers and gives the first solve's bits;
``counted()`` sees the plain versions' zero launches.  The tests mirror
``tests/test_aux.py:89-147`` and ``tests/test_solver.py:224-246``.

Importing this module limits numpy's and scipy's OpenBLAS to one thread
for the rest of the process.  Every pytest-xdist worker imports every
test module while it collects, so the whole Tier-1 run takes one BLAS
thread per worker: six workers already share the cores, and a
multithreaded OpenBLAS call after the forked ranks of
``tests/test_blocked.py`` (``setup/comm.py:219``) waits forever, which
hung the run whenever ``tests/test_configs.py`` followed on the same
worker."""
import dataclasses
import json
import pathlib

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
from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
from sparsh_amg_tpu_torch.parallel import DistAMGSolver
from sparsh_amg_tpu_torch.solve.graphs import ChunkGraph
from sparsh_amg_tpu_torch.solve.solver import check_krylov

threadpoolctl.threadpool_limits(1, user_api="blas")

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these sizes it is faster than the default
    pool, and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_device_mode(A, b, p, kr):
    """The JAX package's solve in its device loop mode, with the port's
    parameters."""
    kw = dataclasses.asdict(kr)
    kw["loop_mode"] = "device"
    return jsolver.AMGSolver(A, jparams.AMGParams(**dataclasses.asdict(p)),
                             jparams.KrylovParams(**kw)).solve(b)


def _relres(A, b, r):
    return np.linalg.norm(b - A @ r.x) / np.linalg.norm(b)


def _held(A, b, p, kr=None, slack=1):
    """The port's solve (default KrylovParams where `kr` is None) and the
    JAX device mode's: both converged to 1e-8, the same passes, the
    iterations within `slack`.  Returns the port's result."""
    port = AMGSolver(A, p, kr, device="cpu").solve(b)
    want = _jax_device_mode(A, b, p, kr or KrylovParams())
    for r in (port, want):
        assert r.converged and _relres(A, b, r) <= 1e-8, r
    assert port.refine_passes == want.refine_passes, (port, want)
    assert abs(port.iterations - want.iterations) <= slack, \
        (port.history, want.history)
    return port


def test_host_device_loop_modes_agree():
    """test_aux.py:89-101: poisson2d(32), CG."""
    A = poisson2d(32)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    _held(A, b, AMGParams(coarse_size=40), KrylovParams())


FLAGSHIP_20 = AMGParams(smoother="chebyshev", coarsening="pmis",
                        interpolation="extpi", interp_max=4,
                        rap_drop_tol=0.01, agg_levels=1,
                        interp_max_composed=5, aggressive="pmis2",
                        coarse_size=400)


@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
def test_host_chunk_scheduler_tight_and_auto_mode(method):
    """test_aux.py:104-124: the flagship's coarsening on poisson3d(20),
    each method on a cold solver, against the JAX device mode."""
    A = poisson3d(20)
    b = np.random.default_rng(7).standard_normal(A.shape[0])
    _held(A, b, FLAGSHIP_20, KrylovParams(method=method, maxiter=200),
          slack=2 if method == "bicgstab" else 1)


def test_bicgstab_host_mode():
    """test_aux.py:140-147: BiCGStab on poisson2d(24)."""
    A = poisson2d(24)
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    _held(A, b, AMGParams(coarse_size=40), KrylovParams(method="bicgstab"),
          slack=2)


def test_stationary_amg_solve_modes_agree():
    """test_solver.py:224-246: the stationary iteration (method "amg")
    converges with the JAX device mode's counts, and PCG needs fewer
    iterations."""
    A = poisson2d(40)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    p = AMGParams(smoother="chebyshev")
    amg = _held(A, b, p, KrylovParams(method="amg", maxiter=200))
    pcg = AMGSolver(A, p, KrylovParams(), device="cpu").solve(b)
    assert pcg.iterations < amg.iterations


@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
def test_default_krylov_params_run_the_device_loop(method):
    """A solver given no KrylovParams (CG), or only a method, runs the
    device loop: the JAX device mode's counts, and on the CPU the guard
    read after every step plus one read of prog a pass."""
    A = poisson2d(24)
    b = np.random.default_rng(8).standard_normal(A.shape[0])
    assert KrylovParams().loop_mode == "device"
    kr = None if method == "cg" else KrylovParams(method=method)
    res = _held(A, b, AMGParams(coarse_size=40), kr,
                slack=2 if method == "bicgstab" else 1)
    assert res.host_reads == res.iterations + 2 * res.refine_passes


@pytest.mark.parametrize("placement", ["host", "auto", "while"])
def test_solver_refuses_another_placement(placement):
    """The port has one placement: check_krylov, and with it every
    solver's construction, refuses any other loop_mode (the JAX package's
    host and auto modes included) with a ValueError naming the device
    loop."""
    A = poisson2d(16)
    kr = KrylovParams(loop_mode=placement)
    with pytest.raises(ValueError, match="device loop"):
        check_krylov(kr)
    with pytest.raises(ValueError, match="device loop"):
        AMGSolver(A, AMGParams(coarse_size=40), kr, device="cpu")
    with pytest.raises(ValueError, match="device loop"):
        DistAMGSolver(A, params=AMGParams(coarse_size=40), krylov=kr,
                      device="cpu")


@pytest.mark.parametrize("config", sorted(
    p.name for p in (ROOT / "amgbench" / "configs").glob("*.json")))
def test_benchmark_config_loads_as_krylov_params(config):
    """The benchmark builds KrylovParams(**cfg["krylov"]) from each of its
    configuration files, which carry loop_mode and chunk: they load and
    pass check_krylov."""
    cfg = json.loads((ROOT / "amgbench" / "configs" / config).read_text())
    kr = KrylovParams(**cfg["krylov"])
    assert {"loop_mode", "chunk"} <= set(cfg["krylov"])
    check_krylov(kr)
    assert kr.loop_mode == "device"


@pytest.mark.parametrize("kind", ["serial", "dist"])
@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
def test_second_solve_reuses_the_loop(method, kind):
    """A second solve on the same solver runs on the same loop (its
    static buffers and graphs) and gives the first solve's x bits,
    counts and history, also after a solve of another right-hand side on
    a shallow copy, which shares the loop."""
    import copy
    A = poisson2d(24)
    p, kr = AMGParams(coarse_size=40), KrylovParams(method=method,
                                                    maxiter=200)
    s = AMGSolver(A, p, kr, device="cpu") if kind == "serial" \
        else DistAMGSolver(A, params=p, krylov=kr, device="cpu")
    rng = np.random.default_rng(9)
    b, other = rng.standard_normal((2, A.shape[0]))
    first = s.solve(b)
    loop = s._loop()
    assert copy.copy(s).solve(other).converged
    second = s.solve(b)
    assert s._loop() is loop and len(s._loops) == 1
    assert first.converged and _relres(A, b, first) <= 1e-8
    assert (second.iterations, second.refine_passes, second.history) == \
        (first.iterations, first.refine_passes, first.history)
    np.testing.assert_array_equal(second.x, first.x)


def test_counted_on_the_cpu_and_eager_chunks():
    """On the CPU a ChunkGraph runs its function eagerly and records no
    replay launches; counted() sees the plain versions' zero launches
    over a solve; the JAX package's host placement raises."""
    A = poisson2d(16)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    s = AMGSolver(A, AMGParams(coarse_size=40), KrylovParams(),
                  device="cpu")
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
    with pytest.raises(ValueError):
        AMGSolver(A, AMGParams(coarse_size=40),
                  KrylovParams(loop_mode="host"), device="cpu")
