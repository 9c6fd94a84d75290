"""Which solvers capture their Krylov loop as CUDA graphs, the lifetime
of a solver's loop and graphs, and the teardown of a process group after
captured solves (CPU; no jax).

One rank or NCCL ranks capture on the card; gloo ranks never do (their
collectives are staged through host buffers); the CPU never does.  Each
pass is read back before the next uncaptured collective (the rhs norm of
the next solve).  A dropped solver's loop is freed at once, with the
cyclic collector off: nothing of the loop refers back to it.  A solver's
graphs are released before its process group is destroyed, also when a
rank raises: graphs that captured NCCL collectives hold the
communicator."""
import gc
import os
import weakref

import numpy as np
import pytest
import torch

from sparsh_amg_tpu_torch.params import KrylovParams
from sparsh_amg_tpu_torch.parallel.solver import loop_capture


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("backend, nranks, captures", [
    (None, 1, True),            # one rank, no process group
    ("nccl", 2, True), ("nccl", 8, True),
    ("gloo", 2, False), ("gloo", 8, False),
])
def test_capture_decision(backend, nranks, captures):
    assert loop_capture(backend, nranks) is captures


def _small():
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.parallel.multihost import _flagship_params
    A = poisson3d(10)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    return A, b, _flagship_params().replace(dense_size=256)


def _solver(kind, method, A, p):
    from sparsh_amg_tpu_torch import AMGSolver
    from sparsh_amg_tpu_torch.parallel import DistAMGSolver
    kr = KrylovParams(method=method, tol=1e-8, maxiter=60)
    return AMGSolver(A, p, kr, device="cpu") if kind == "serial" \
        else DistAMGSolver(A, params=p, krylov=kr, device="cpu")


@pytest.mark.parametrize("kind", ["serial", "dist"])
@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
def test_the_cpu_never_captures(kind, method):
    """On the CPU both solvers run every piece of the loop eagerly: no
    graph, no capture or instantiation time, no pass graph."""
    A, b, p = _small()
    solver = _solver(kind, method, A, p)
    assert solver.capture           # the choice, where the device allows
    solver.warm()
    res = solver.solve(b)
    loop = solver._loop()
    assert not loop.capture
    assert all(g.graph is None for g in loop.all_graphs())
    assert all(p.exec is None for p in loop.passes.values())
    assert solver.graph_seconds() == (0.0, 0.0)
    assert solver.pass_graph_seconds() == 0.0
    assert res.converged
    assert res.pass_ms == []        # no pass graph launched


@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
def test_every_launch_is_read_before_a_collective(method):
    """Every pass is read back before the pass returns (one read per pass
    graph launch), so the next solve's rhs norm, an uncaptured
    collective, follows a finished pass: two solves in a row on the
    distributed solver agree in counts, history and x bits, and each
    pass's read is counted."""
    A, b, p = _small()
    solver = _solver("dist", method, A, p)
    runs = [solver.solve(solver.prepare_rhs(b)) for _ in range(2)]
    assert runs[0].converged
    assert (runs[0].iterations, runs[0].history) == \
        (runs[1].iterations, runs[1].history)
    np.testing.assert_array_equal(runs[0].x, runs[1].x)
    for r in runs:
        # eagerly: the guard after every step, and prog once a pass
        assert r.host_reads == r.iterations + 2 * r.refine_passes


@pytest.mark.parametrize("kind", ["serial", "dist"])
@pytest.mark.parametrize("method", ["cg", "bicgstab", "amg"])
def test_a_dropped_solver_frees_its_loop_with_the_collector_off(kind,
                                                                method):
    """A solver dropped after a solve frees its loop and the loop's graphs
    by reference counting alone: with the cyclic collector off, a weak
    reference to the loop is dead once the solver and its result are
    gone (no graph's function refers back to the loop)."""
    A, b, p = _small()
    solver = _solver(kind, method, A, p)
    res = solver.solve(b)
    assert res.converged
    loop = weakref.ref(solver._loop())
    step = weakref.ref(solver._loop().step)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del solver, res
        assert loop() is None and step() is None
    finally:
        if collecting:
            gc.enable()


def test_release_graphs_then_destroy_the_group():
    """multihost.destroy_process_group releases the graphs of every
    distributed solver of the process (every loop of each, shared with
    its shallow copies) before it destroys the group; a released graph
    runs no more, and the next solve builds the loop anew with the same
    counts."""
    import copy
    import torch.distributed as dist
    from sparsh_amg_tpu_torch.parallel import DistAMGSolver, multihost
    A, b, p = _small()
    kr = KrylovParams(tol=1e-8, maxiter=60, loop_mode="device")
    solver = DistAMGSolver(A, params=p, krylov=kr, device="cpu")
    first = copy.copy(solver).solve(b)
    loop = solver._loop()
    assert solver._loops
    dist.init_process_group("gloo", init_method="tcp://localhost:"
                            f"{multihost.free_port()}", rank=0,
                            world_size=1)
    multihost.destroy_process_group()
    assert not dist.is_initialized()
    assert not solver._loops
    with pytest.raises(RuntimeError, match="released"):
        loop.step.run()
    again = copy.copy(solver).solve(b)
    assert (again.iterations, again.refine_passes) == \
        (first.iterations, first.refine_passes)
    np.testing.assert_array_equal(again.x, first.x)
    multihost.destroy_process_group()       # no group left: a no-op


def raising_ranks(backend: str, device: str) -> str:
    """Two ranks of ``tests/torch_dist_rank.py raises`` (a solve, then an
    error, the group left to the teardown at exit): the first to fail
    exits with its error, not at the time limit, after the teardown that
    releases its graphs and destroys the group.  Returns the failure's
    text."""
    from sparsh_amg_tpu_torch.parallel import multihost
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with pytest.raises(RuntimeError) as e:
        multihost.spawn_ranks(
            2, [os.path.join(root, "tests", "torch_dist_rank.py"),
                "raises"], backend=backend, device=device, threads=1,
            timeout=240)
    text = str(e.value)
    assert "timed out" not in text and "rc=1" in text, text
    assert "raises after its solve" in text, text
    assert "at exit: graphs released, group destroyed" in text, text
    return text


def test_a_rank_that_raises_exits_with_its_error():
    text = raising_ranks("gloo", "cpu")
    assert '"capture": false' in text, text
