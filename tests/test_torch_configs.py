"""The seven scalar acceptance configurations (``configs.py``), one solve
per family at a small size on the CPU, against the JAX package's solver
with ``loop_mode="device"``: the same refinement passes, iterations within
1 (CG, the stationary iteration) or 2 (BiCGStab), both to relres <= 1e-8
recomputed in fp64.  ``dense_size`` 256 keeps ELL-T levels (and their
gs2 triangles) in the small hierarchies."""
import dataclasses

import numpy as np
import pytest
import torch

from sparsh_amg_tpu import params as jparams
from sparsh_amg_tpu.solve.solver import AMGSolver as JaxSolver
from sparsh_amg_tpu_torch import AMGSolver, configs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these sizes it is faster than the default
    pool, and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (configuration, size, Krylov method override)
CASES = {
    "aniso2d(64) SA W bicgstab": (
        "aniso2d_1024_eps1e-3_rot45_aggW_bicgstab", 64, None),
    "aniso2d(64) gs2 W bicgstab": (
        "aniso2d_1024_pmis_extpi_W_gs2_bicgstab", 64, None),
    "convection3d(16) gs2 bicgstab": (
        "convection3d_96_pmis_extpi_V_bicgstab", 16, None),
    "poisson2d(64) wjacobi amg": ("poisson2d_1024_wjacobi_V_cg", 64, "amg"),
    "jump2d(64) chebyshev cg": ("jump2d_1024_random_1e4_V_cg", 64, None),
    "delaunay(4096) l1jacobi cg": ("delaunay_1024sq_rcm_l1jac_V_cg", 64,
                                   None),
}


@pytest.mark.parametrize("case", CASES)
def test_config_solve_matches_jax(case):
    name, m, method = CASES[case]
    A, _ = configs.problem(name, m)
    b = configs.rhs(A.shape[0])
    p = configs.params(name, dense_size=256)
    kr = configs.krylov(name)
    if method:
        kr = dataclasses.replace(kr, method=method)
    ref = JaxSolver(A, jparams.AMGParams(**dataclasses.asdict(p)),
                    jparams.KrylovParams(**{**dataclasses.asdict(kr),
                                            "loop_mode": "device"})).solve(b)
    solver = AMGSolver(A, p, kr, device="cpu")
    res = solver.solve(b)
    slack = 2 if kr.method == "bicgstab" else 1
    assert res.converged and ref.converged, (res, ref)
    assert res.refine_passes == ref.refine_passes, (res, ref)
    assert abs(res.iterations - ref.iterations) <= slack, (res, ref)
    for r in (res, ref):
        assert np.linalg.norm(b - A @ r.x) / np.linalg.norm(b) <= 1e-8
    if p.smoother == "gs2":
        assert solver.device.levels[0].L is not None


def test_config_table():
    """Every configuration builds its parameters, and the reference holds
    the JAX package's CPU counts for each."""
    assert len(configs.NAMES) == 7
    for name in configs.NAMES:
        p, kr = configs.params(name), configs.krylov(name)
        assert kr.tol == 1e-8 and kr.method in ("cg", "bicgstab")
        assert configs.iteration_slack(name) == (
            2 if kr.method == "bicgstab" else 1)
        ref = configs.REFERENCE[name]
        assert ref["cpu"]["refine_passes"] >= 2, name
        assert configs.held_counts(name) is ref[ref.get("hold", "cpu")]
        assert p.coarsening in ("pmis", "aggregation")
    held = [n for n in configs.NAMES if "hold" in configs.REFERENCE[n]]
    assert held == ["aniso2d_1024_pmis_extpi_W_gs2_bicgstab"]
