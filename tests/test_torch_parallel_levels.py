"""Distributed solves of the port on four gloo ranks against the JAX
package's ``DistAMGSolver`` on ``default_mesh(4)``: the level cases of the
JAX package's tests/test_parallel.py (two-stage Gauss-Seidel with its
triangles, bf16 cycle bands with the fp32 Krylov matvec, replicated
coarse levels), held as in test_torch_parallel_solve.py."""
import pytest
import torch

import torch_dist_rank as W
from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
from sparsh_amg_tpu_torch.parallel import DistAMGSolver
from test_torch_parallel_solve import (holds_jax_counts,
                                       one_rank_takes_the_four_ranks_counts,
                                       ranks_and_jax_counts)

GROUP = "levels"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solves():
    return ranks_and_jax_counts(GROUP)


@pytest.mark.parametrize("name", W.SOLVE_GROUPS[GROUP])
def test_distributed_solve_holds_jax_counts(solves, name):
    holds_jax_counts(solves, name)


@pytest.mark.parametrize("name", ["replicated", "gs2"])
def test_one_rank_takes_the_four_ranks_counts(solves, name):
    one_rank_takes_the_four_ranks_counts(solves, name)


def test_bf16_cycle_keeps_the_fp32_krylov_matvec():
    """With bf16 cycle bands the Krylov matvec stays on the fp32 fine
    operator (DistFp64.A_hi), not the cycle's bf16 bands."""
    A, pkw, kkw = W.solve_cases("levels")["bf16"]
    s = DistAMGSolver(A, params=AMGParams(**pkw),
                      krylov=KrylovParams(tol=1e-8, **kkw), device="cpu")
    assert s.dist.levels[0].A.bands.dtype == torch.bfloat16
    assert s._krylov_op.bands.dtype == torch.float32
    assert s.A64.A.bands.dtype == torch.float64
