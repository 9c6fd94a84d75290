"""Smoothers (the port of ``sparsh_amg_tpu/solve/smoothers.py``).

Weighted Jacobi, l1-Jacobi and Chebyshev.  On DIA levels each sweep or
Chebyshev step is one fused kernel (``ops/dia_spmv.py``); elsewhere an
SpMV plus plain elementwise PyTorch.  All smoothers preserve zero padding
because dinv/l1_dinv are zero there.  Chebyshev scalars are computed in
fp32 (numpy scalars), as the JAX package computes them from its fp32
lam_max.
"""
from __future__ import annotations

import numpy as np

from ..ops.dia_spmv import dia_cheb_step, dia_dinv_residual, dia_jacobi_sweep
from ..ops.formats import DiaMatrix, spmv


def _jacobi_like(A, b, x, sweeps, dinv, omega, zero_start):
    """Shared weighted-Jacobi sweep loop; one fused kernel per sweep on
    DIA levels."""
    if sweeps <= 0:
        return x
    if zero_start:
        x = omega * dinv * b if omega != 1.0 else dinv * b
        sweeps -= 1
    for _ in range(sweeps):
        if isinstance(A, DiaMatrix):
            x = dia_jacobi_sweep(A.bands, x, b, dinv, omega, A.offsets)
        else:
            x = x + omega * dinv * (b - spmv(A, x))
    return x


def jacobi(level, b, x, sweeps: int, omega: float, zero_start: bool = False):
    """Weighted Jacobi: x <- x + omega D^-1 (b - A x)."""
    return _jacobi_like(level.A, b, x, sweeps, level.dinv, omega, zero_start)


def l1_jacobi(level, b, x, sweeps: int, zero_start: bool = False):
    """l1-Jacobi: x <- x + D_l1^-1 (b - A x),
    D_l1 = diag(a_ii + sum_{j!=i} |a_ij|)."""
    return _jacobi_like(level.A, b, x, sweeps, level.l1_dinv, 1.0,
                        zero_start)


def chebyshev(level, b, x, degree: int, lower_frac: float,
              zero_start: bool = False):
    """Chebyshev polynomial smoother of the given degree on D^-1 A, with
    eigenvalue window [lower_frac * lam_max, lam_max]."""
    if degree <= 0:
        return x
    f32 = np.float32
    lmax = f32(level.lam_max)
    lmin = f32(lower_frac) * lmax
    theta = f32(0.5) * (lmax + lmin)
    delta = f32(0.5) * (lmax - lmin)
    sigma = theta / delta
    rho = f32(1.0) / sigma
    A = level.A
    fused = isinstance(A, DiaMatrix)
    if zero_start:
        r = level.dinv * b
    elif fused:
        r = dia_dinv_residual(A.bands, x, b, level.dinv, A.offsets)
    else:
        r = level.dinv * (b - spmv(A, x))
    d = r / float(theta)
    for _ in range(degree - 1):
        rho_new = f32(1.0) / (f32(2.0) * sigma - rho)
        a, c = float(rho_new * rho), float(f32(2.0) * rho_new / delta)
        if fused:
            x, r, d = dia_cheb_step(A.bands, x, d, r, level.dinv, a, c,
                                    A.offsets)
        else:
            x = x + d
            r = r - level.dinv * spmv(A, d)
            d = a * d + c * r
        rho = rho_new
    return x + d


def smooth(level, b, x, params, zero_start: bool = False, sweeps: int = None,
           backward: bool = False, coarse: bool = False):
    """Dispatch on params.smoother.  `coarse` selects the reduced
    coarse-level Chebyshev degree when configured; `backward` is accepted
    for the direction-dependent two-stage GS, which is not ported."""
    name = params.smoother
    if name == "jacobi":
        nu = sweeps if sweeps is not None else params.nu1
        return jacobi(level, b, x, nu, params.jacobi_omega, zero_start)
    if name == "l1jacobi":
        nu = sweeps if sweeps is not None else params.nu1
        return l1_jacobi(level, b, x, nu, zero_start)
    if name == "chebyshev":
        degree = (params.cheby_degree_coarse
                  if coarse and params.cheby_degree_coarse
                  else params.cheby_degree)
        return chebyshev(level, b, x, degree,
                         params.cheby_lower_frac, zero_start)
    if name == "gs2":
        raise NotImplementedError("two-stage Gauss-Seidel (gs2) is not "
                                  "ported yet; see ROADMAP.md")
    raise ValueError(f"unknown smoother {name!r}")
