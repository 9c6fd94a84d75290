"""Smoothers (the port of ``sparsh_amg_tpu/solve/smoothers.py``).

Weighted Jacobi, l1-Jacobi, Chebyshev and two-stage Gauss-Seidel.  On DIA
levels each Jacobi sweep or Chebyshev step, and each Gauss-Seidel
residual, is one fused product (``ops/formats.py::FusedDia``: one kernel
on a ``DiaMatrix``, the same kernel and a boundary launch on a rank's
block); a Chebyshev smooth there runs those launches alone, its start
and its closing x + d inside them.  On ELL levels each Jacobi sweep and
each residual is one fused ELL launch (``ops/ell_spmv.py``).  Elsewhere
an SpMV plus plain elementwise PyTorch.  A zero start may pass x = None
to ``smooth``, which makes the zero unless the smoother never reads it.
All smoothers preserve zero padding because dinv/l1_dinv are zero there.  Chebyshev scalars are computed in
fp32 (numpy scalars), as the JAX package computes them from its fp32
lam_max.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.formats import FusedDia, jacobi_sweep, residual, spmv


def _jacobi_like(A, b, x, sweeps, dinv, omega, zero_start):
    """Shared weighted-Jacobi sweep loop; one fused product per sweep on
    DIA and ELL levels.  A zero start does not read x."""
    if sweeps <= 0:
        return x
    if zero_start:
        x = omega * dinv * b if omega != 1.0 else dinv * b
        sweeps -= 1
    for _ in range(sweeps):
        x = jacobi_sweep(A, x, b, dinv, omega)
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
    eigenvalue window [lower_frac * lam_max, lam_max].  On a FusedDia
    level: a start product (r and d = r / theta; none after a zero
    start), degree - 2 steps and a last step that writes x + d'; x may
    be None there after a zero start."""
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
    fused = isinstance(A, FusedDia)
    if fused:
        x = None if zero_start else x
        r, d = A.cheb_start(x, b, level.dinv, float(theta))
    else:
        r = level.dinv * b if zero_start else level.dinv * (b - spmv(A, x))
        d = r / float(theta)
    for k in range(degree - 1):
        rho_new = f32(1.0) / (f32(2.0) * sigma - rho)
        a, c = float(rho_new * rho), float(f32(2.0) * rho_new / delta)
        if fused and k == degree - 2:
            return A.cheb_last(x, d, r, level.dinv, a, c)
        if fused:
            x, r, d = A.cheb_step(x, d, r, level.dinv, a, c)
        else:
            x = x + d
            r = r - level.dinv * spmv(A, d)
            d = a * d + c * r
        rho = rho_new
    return d if x is None else x + d


def two_stage_gs(level, b, x, sweeps: int, stages: int = 2,
                 backward: bool = False, zero_start: bool = False):
    """Two-stage Gauss-Seidel: each sweep solves (D + L) z = r inexactly
    with `stages` Jacobi iterations on the triangle, z_0 = D^-1 r,
    z_{k+1} = D^-1 (r - L z_k).  `backward=True` uses U instead (the
    post-smoothing direction).  A level without triangles (the coarsest,
    when it has a dense inverse) falls back to l1-Jacobi."""
    T = level.U if backward else level.L
    if T is None:
        return l1_jacobi(level, b, x, sweeps, zero_start)
    for s in range(sweeps):
        if zero_start and s == 0:
            r = b
        else:
            r = residual(level.A, x, b)
        z = level.dinv * r
        for _ in range(stages - 1):
            z = level.dinv * (r - spmv(T, z))
        x = z if (zero_start and s == 0) else x + z
    return x


def smooth(level, b, x, params, zero_start: bool = False, sweeps: int = None,
           backward: bool = False, coarse: bool = False):
    """Dispatch on params.smoother.  `backward` selects the sweep direction
    of two-stage GS; `coarse` selects the reduced coarse-level Chebyshev
    degree when configured.  x None: a zero start, whose zero is made
    here unless the smoother never reads it (Chebyshev on a FusedDia
    level; a zero start's Jacobi sweeps)."""
    name = params.smoother
    nu = sweeps if sweeps is not None else params.nu1
    degree = (params.cheby_degree_coarse
              if coarse and params.cheby_degree_coarse
              else params.cheby_degree)
    unread = (degree > 0 and isinstance(level.A, FusedDia)
              if name == "chebyshev" else
              zero_start and nu > 0 and name in ("jacobi", "l1jacobi"))
    if x is None and not unread:
        x = torch.zeros_like(b)
    if name == "jacobi":
        return jacobi(level, b, x, nu, params.jacobi_omega, zero_start)
    if name == "l1jacobi":
        return l1_jacobi(level, b, x, nu, zero_start)
    if name == "chebyshev":
        return chebyshev(level, b, x, degree,
                         params.cheby_lower_frac, zero_start)
    if name == "gs2":
        return two_stage_gs(level, b, x, nu, params.gs_stages, backward,
                            zero_start)
    raise ValueError(f"unknown smoother {name!r}")
