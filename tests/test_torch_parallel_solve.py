"""Distributed solves of the port on four gloo ranks against the JAX
package's ``DistAMGSolver`` on ``default_mesh(4)``: the cycle and Krylov
cases of the JAX package's tests/test_parallel.py (Chebyshev V, W and F
cycles, BiCGStab; test_torch_parallel_levels.py has the others).  Counts are held to the JAX package's
(``loop_mode="device"``, exact counts): iterations +-1 (CG) or +-2
(BiCGStab) and the same refinement passes, with the host-fp64 relative
residual <= 1e-8; one rank in this process takes the four ranks'
counts.  The ranks are subprocesses that import only the port
(``tests/torch_dist_rank.py``)."""
import numpy as np
import pytest
import torch

import torch_dist_rank as W
from sparsh_amg_tpu.params import AMGParams as JParams
from sparsh_amg_tpu.params import KrylovParams as JKrylov
from sparsh_amg_tpu.parallel.solver import DistAMGSolver as JDist
from sparsh_amg_tpu.parallel.solver import default_mesh
from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
from sparsh_amg_tpu_torch.parallel import DistAMGSolver

GROUP = "cycles"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ranks_and_jax_counts(group):
    """(the four ranks' results, the JAX package's counts) per case of
    the group; the ranks run while the JAX side is computed."""
    wait = W.spawn(group)
    want = {}
    for name, (A, pkw, kkw) in W.solve_cases(group).items():
        b = W.solve_rhs(A.shape[0])
        res = JDist(A, mesh=default_mesh(W.RANKS), params=JParams(**pkw),
                    krylov=JKrylov(tol=1e-8, loop_mode="device",
                                   **kkw)).solve(b)
        want[name] = (res.iterations, res.refine_passes)
    return wait(), want


def holds_jax_counts(solves, name):
    """Every rank took one control flow, and it holds the JAX package's
    counts."""
    outs, want = solves
    got = [o[name] for o in outs]
    assert all(g == got[0] for g in got), got       # one control flow
    g = got[0]
    it, passes = want[name]
    slack = 2 if name == "bicgstab" else 1
    assert g["converged"] and g["relres_host_fp64"] <= 1e-8, g
    assert abs(g["iterations"] - it) <= slack, (g, want[name])
    assert g["passes"] == passes, (g, want[name])
    if name == "replicated":
        assert "DeviceLevel" in g["levels"] and "DistLevel" in g["levels"]
    if name in ("gs2", "bf16", "poisson3d_chebyshev"):
        assert g["ops"][0] == "DistDia", g


def one_rank_takes_the_four_ranks_counts(solves, name):
    """A one-rank DistAMGSolver (no process group) takes the four ranks'
    counts and reaches the tolerance."""
    outs, _ = solves
    A, pkw, kkw = W.solve_cases()[name]
    b = W.solve_rhs(A.shape[0])
    res = DistAMGSolver(A, params=AMGParams(**pkw),
                        krylov=KrylovParams(tol=1e-8, **kkw),
                        device="cpu").solve(b)
    g = outs[0][name]
    assert (res.iterations, res.refine_passes) == (g["iterations"],
                                                   g["passes"])
    assert np.linalg.norm(b - A @ res.x) / np.linalg.norm(b) <= 1e-8


@pytest.fixture(scope="module")
def solves():
    return ranks_and_jax_counts(GROUP)


@pytest.mark.parametrize("name", W.SOLVE_GROUPS[GROUP])
def test_distributed_solve_holds_jax_counts(solves, name):
    holds_jax_counts(solves, name)


@pytest.mark.parametrize("name", ["W", "F"])
def test_one_rank_takes_the_four_ranks_counts(solves, name):
    one_rank_takes_the_four_ranks_counts(solves, name)
