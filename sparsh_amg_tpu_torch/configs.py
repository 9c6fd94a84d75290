"""The seven scalar acceptance configurations of
``scripts/run_configs_tpu.py`` (lines 52-116) beside the flagship
(``flagship.py``) and the two elasticity ones (``systems.py``): the same
generators at the same sizes, the same ``AMGParams`` and ``KrylovParams``.

* ``poisson2d_1024_wjacobi_V_cg``: PMIS + ext+i, weighted Jacobi, V, CG;
* ``aniso2d_1024_eps1e-3_rot45_aggW_bicgstab`` and the same at 2048:
  rotated anisotropic diffusion, smoothed aggregation (``agg_theta``
  0.25), l1-Jacobi, W, BiCGStab;
* ``aniso2d_1024_pmis_extpi_W_gs2_bicgstab``: PMIS + ext+i, two-stage
  Gauss-Seidel, W, BiCGStab;
* ``convection3d_96_pmis_extpi_V_bicgstab``: nonsymmetric
  convection-diffusion, gs2, V, BiCGStab;
* ``jump2d_1024_random_1e4_V_cg``: random coefficient jumps of 1e4,
  Chebyshev, V, CG;
* ``delaunay_1024sq_rcm_l1jac_V_cg``: a Delaunay graph Laplacian over 1M
  points in RCM order (no stencil: an ELL-T fine level), l1-Jacobi, V, CG.

``REFERENCE`` holds the JAX package's counts for a priming solve at tol
1e-2 followed by a solve to 1e-8 (``run_configs_tpu.py:167-168``): on the
CPU with ``loop_mode="device"`` (the counts to match), and on a TPU v5e
(``CONFIGS_r5.json``, host loop mode, context only).  The CPU counts, and
the port's own where one is given, come from
``scripts/config_reference_counts.py``.
"""
from __future__ import annotations

import numpy as np

from .models.anisotropic import anisotropic2d
from .models.convection import convection3d
from .models.jump import jump2d
from .models.poisson import poisson2d
from .models.unstructured import delaunay_laplacian
from .params import AMGParams, KrylovParams

_ANISO = dict(epsilon=1e-3, angle_deg=45)
_SA_W = dict(coarsening="aggregation", interpolation="smoothed", cycle="W",
             smoother="l1jacobi", agg_theta=0.25)
_PMIS = dict(coarsening="pmis", interpolation="extpi", interp_max=4)

# name: (generator, size, AMGParams keywords, KrylovParams keywords)
_TABLE = {
    "poisson2d_1024_wjacobi_V_cg": (
        poisson2d, 1024, dict(smoother="jacobi", **_PMIS),
        dict(method="cg", maxiter=300)),
    "aniso2d_1024_eps1e-3_rot45_aggW_bicgstab": (
        lambda m: anisotropic2d(m, **_ANISO), 1024, _SA_W,
        dict(method="bicgstab", maxiter=400)),
    "aniso2d_2048_eps1e-3_rot45_aggW_bicgstab": (
        lambda m: anisotropic2d(m, **_ANISO), 2048, _SA_W,
        dict(method="bicgstab", maxiter=400)),
    "aniso2d_1024_pmis_extpi_W_gs2_bicgstab": (
        lambda m: anisotropic2d(m, **_ANISO), 1024,
        dict(cycle="W", smoother="gs2", rap_drop_tol=0.01, **_PMIS),
        dict(method="bicgstab", maxiter=400)),
    "convection3d_96_pmis_extpi_V_bicgstab": (
        convection3d, 96, dict(smoother="gs2", rap_drop_tol=0.01, **_PMIS),
        dict(method="bicgstab", maxiter=300)),
    "jump2d_1024_random_1e4_V_cg": (
        lambda m: jump2d(m, contrast=1e4, pattern="random"), 1024,
        dict(smoother="chebyshev", **_PMIS), dict(method="cg", maxiter=300)),
    "delaunay_1024sq_rcm_l1jac_V_cg": (
        lambda m: delaunay_laplacian(m * m), 1024,
        dict(smoother="l1jacobi", rap_drop_tol=0.01, **_PMIS),
        dict(method="cg", maxiter=300)),
}

NAMES = tuple(_TABLE)
SIZES = {name: row[1] for name, row in _TABLE.items()}   # grid sides

REFERENCE = {
    "poisson2d_1024_wjacobi_V_cg": {
        "n": 1_048_576, "nnz": 5_238_784,
        "cpu": {"iterations": 14, "refine_passes": 2,
                "relres": 6.63e-10, "levels": 6},
        "tpu": {"iterations": 14, "refine_passes": 2}},
    "aniso2d_1024_eps1e-3_rot45_aggW_bicgstab": {
        "n": 1_048_576, "nnz": 9_424_900,
        "cpu": {"iterations": 21, "refine_passes": 2,
                "relres": 7.29e-09, "levels": 8},
        "tpu": {"iterations": 21, "refine_passes": 2}},
    "aniso2d_2048_eps1e-3_rot45_aggW_bicgstab": {
        "n": 4_194_304, "nnz": 37_724_164,
        "cpu": {"iterations": 23, "refine_passes": 3,
                "relres": 6.58e-10, "levels": 8},
        "tpu": {"iterations": 24, "refine_passes": 3}},
    # The count here moves by up to six iterations and a pass when only
    # rounding changes: the fp32 attainable floor of this problem sits at
    # the tolerance, so the second pass ends between 4.6e-9 and 1.27e-8
    # and a third pass follows when it lands above 1e-8.  Both packages
    # flip: JAX 46/3 as configured and 41/2 with compensated dots; the
    # port's own code 38/2 on the CPU and 44/3 on the card with
    # compensated dots (the same inputs, only the summation order
    # differs).  "spread" holds every count measured with
    # scripts/config_reference_counts.py (rhs rng seed, compensated dots)
    # as (iterations, passes).  The card is held to the port's plain
    # versions on the CPU at full size ("port_cpu"), the JAX package's
    # count is printed beside.
    "aniso2d_1024_pmis_extpi_W_gs2_bicgstab": {
        "n": 1_048_576, "nnz": 9_424_900,
        "cpu": {"iterations": 46, "refine_passes": 3,
                "relres": 8.84e-10, "levels": 6},
        "spread": {
            "jax cpu": {"seed 0": (46, 3), "seed 0 compensated": (41, 2),
                        "seed 1": (40, 2), "seed 2": (42, 2)},
            "port cpu": {"seed 0": (38, 2), "seed 0 compensated": (38, 2),
                         "seed 1": (38, 2), "seed 1 compensated": (37, 2),
                         "seed 2": (41, 2), "seed 2 compensated": (39, 2)},
            "port card": {"seed 0": (37, 2), "seed 0 compensated": (44, 3),
                          "seed 1": (38, 2), "seed 1 compensated": (39, 2),
                          "seed 2": (42, 2), "seed 2 compensated": (38, 2)}},
        "port_cpu": {"iterations": 38, "refine_passes": 2,
                     "relres": 7.08e-9},
        "hold": "port_cpu",
        "tpu": {"iterations": 43, "refine_passes": 2}},
    "convection3d_96_pmis_extpi_V_bicgstab": {
        "n": 884_736, "nnz": 6_137_856,
        "cpu": {"iterations": 8, "refine_passes": 2,
                "relres": 1.82e-10, "levels": 6},
        "tpu": {"iterations": 8, "refine_passes": 2}},
    "jump2d_1024_random_1e4_V_cg": {
        "n": 1_048_576, "nnz": 5_238_784,
        "cpu": {"iterations": 17, "refine_passes": 3,
                "relres": 1.01e-09, "levels": 7},
        "tpu": {"iterations": 18, "refine_passes": 3}},
    "delaunay_1024sq_rcm_l1jac_V_cg": {
        "n": 1_048_576, "nnz": 7_339_948,
        "cpu": {"iterations": 21, "refine_passes": 2,
                "relres": 6.33e-09, "levels": 6},
        "tpu": {"iterations": 25, "refine_passes": 3}},
}


def problem(name: str, m: int | None = None):
    """(A, near-nullspace) of configuration `name` at size m (grid side;
    for delaunay, the side of the point lattice), m defaulting to the
    configuration's.  None of these has a near-nullspace."""
    gen, size, _, _ = _TABLE[name]
    return gen(size if m is None else m).tocsr(), None


def params(name: str, **overrides) -> AMGParams:
    return AMGParams(**{**_TABLE[name][2], **overrides})


def krylov(name: str, tol: float = 1e-8) -> KrylovParams:
    """The configuration's method and budget (REFERENCE's counts were taken
    in the JAX package's device loop mode, the port's one placement)."""
    return KrylovParams(tol=tol, **_TABLE[name][3])


def held_counts(name: str) -> dict:
    """The counts the card's solve is held to: the JAX package's on the
    CPU, or for a configuration whose reference says otherwise ("hold"),
    the port's plain versions' on the CPU at full size."""
    ref = REFERENCE[name]
    return ref[ref.get("hold", "cpu")]


def iteration_slack(name: str) -> int:
    """Iterations the port may differ from the reference by: 1 for CG,
    2 for BiCGStab (its recurrences amplify the order of fp32 sums)."""
    return 2 if _TABLE[name][3]["method"] == "bicgstab" else 1


def rhs(n: int) -> np.ndarray:
    """The right-hand side of ``run_configs_tpu.py:162``."""
    return np.random.default_rng(0).standard_normal(n)
