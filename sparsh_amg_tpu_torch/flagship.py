"""The flagship configuration of ``bench.py`` (lines 137-170): 3-D 7-point
Poisson, PMIS with a pmis2 aggressive first level and ext+i interpolation,
bf16 matrix data, Chebyshev V-cycle, AMG-PCG to 1e-8 with iterative
refinement.  On poisson3d(192) the JAX package reaches 12 PCG iterations
in 2 refinement passes at relres 9.38e-10, with 5 levels at operator
complexity 1.223 (BENCH_r05.json)."""
from __future__ import annotations

from ._host import AMGParams, KrylovParams

REFERENCE_192 = {"iterations": 12, "refine_passes": 2, "relres": 9.38e-10,
                 "levels": 5, "operator_complexity": 1.223}


def params(dense_size: int = 2048) -> AMGParams:
    return AMGParams(smoother="chebyshev", cycle="V", band_dtype="bfloat16",
                     coarsening="pmis", interpolation="extpi",
                     dense_size=dense_size, cheby_degree_coarse=1,
                     cheby_coarse_from=1, interp_max=4, rap_drop_tol=0.01,
                     agg_levels=1, interp_max_composed=5,
                     intermediate_drop_tol=0.02, aggressive="pmis2")


def krylov(tol: float = 1e-8) -> KrylovParams:
    return KrylovParams(method="cg", tol=tol)
