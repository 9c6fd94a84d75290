"""Which solvers capture their Krylov loop as CUDA graphs, the order of
graph launches and uncaptured collectives, and the teardown of a process
group after captured solves (CPU; no jax).

One rank or NCCL ranks capture on the card; gloo ranks never do (their
collectives are staged through host buffers); the CPU never does.  The
host reads every launch of the loop back before the solver issues an
uncaptured collective.  A solver's graphs are released before its
process group is destroyed, also when a rank raises: graphs that
captured NCCL collectives hold the communicator."""
import os

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


@pytest.mark.parametrize("kind", ["serial", "dist"])
@pytest.mark.parametrize("mode", ["device", "host"])
def test_the_cpu_never_captures(kind, mode):
    """On the CPU both solvers run every piece of the loop eagerly: no
    graph, no capture or instantiation time, no pass graph."""
    from sparsh_amg_tpu_torch import AMGSolver
    from sparsh_amg_tpu_torch.parallel import DistAMGSolver
    A, b, p = _small()
    kr = KrylovParams(tol=1e-8, maxiter=60, loop_mode=mode)
    solver = AMGSolver(A, p, kr, device="cpu") if kind == "serial" \
        else DistAMGSolver(A, params=p, krylov=kr, device="cpu")
    assert solver.capture           # the choice, where the device allows
    solver.warm()
    res = solver.solve(b)
    loop = solver._loop()
    assert not loop.capture
    assert all(g.graph is None for g in loop.all_graphs())
    assert all(p.exec is None for p in loop.passes.values())
    assert solver.graph_seconds() == (0.0, 0.0)
    assert solver.pass_graph_seconds() == 0.0
    assert res.converged and res.masked_steps == 0
    assert res.pass_ms == []        # no pass graph launched


@pytest.mark.parametrize("mode", ["device", "host"])
def test_every_launch_is_read_before_a_collective(mode):
    """Each solve leaves no launch of the loop unread (each of the host
    mode's chunk and finish launches is read back), so the next solve's
    rhs norm, an uncaptured collective, goes ahead; a launch left unread
    stops it until the host reads prog."""
    from sparsh_amg_tpu_torch.parallel import DistAMGSolver
    A, b, p = _small()
    kr = KrylovParams(tol=1e-8, maxiter=60, loop_mode=mode)
    solver = DistAMGSolver(A, params=p, krylov=kr, device="cpu")
    counts = []
    for _ in range(2):
        res = solver.solve(solver.prepare_rhs(b))
        assert not solver._loop().unread
        counts.append((res.iterations, res.refine_passes))
    assert counts[0] == counts[1] and res.converged
    loop = solver._loop()
    loop.replay(loop.init)
    with pytest.raises(RuntimeError, match="not read back"):
        solver.prepare_rhs(b)
    loop.read(loop.prog)
    solver.prepare_rhs(b)


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
