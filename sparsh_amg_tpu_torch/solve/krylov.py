"""Krylov iterations (the port of ``sparsh_amg_tpu/solve/krylov.py``): the
init and step functions of preconditioned CG, BiCGStab and the stationary
AMG iteration, with the JAX package's state tuples.  The scalars stay 0-d
tensors on the device; the solver's host loop reads r.r (and BiCGStab's
breakdown flag) once per iteration.

* PCG: (x, r, z, p, r.z, r.r, k);
* BiCGStab: (x, r, v, p, rho, alpha, omega, r.r, k, breakdown);
* stationary: (x, r, r.r, k).
"""
from __future__ import annotations

import torch


def pcg_init(matvec, precond, b, _dot, x0=None):
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    z = precond(r)
    p = z
    return (x, r, z, p, _dot(r, z), _dot(r, r), 0)


def pcg_step(matvec, precond, _dot, state):
    x, r, z, p, rz_, rr_, k = state
    q = matvec(p)
    pq = _dot(p, q)
    alpha = rz_ / torch.where(pq != 0, pq, 1.0)
    x = x + alpha * p
    r = r - alpha * q
    z = precond(r)
    rz_new = _dot(r, z)
    beta = rz_new / torch.where(rz_ != 0, rz_, 1.0)
    p = z + beta * p
    return (x, r, z, p, rz_new, _dot(r, r), k + 1)


def bicgstab_init(matvec, b, _dot, x0=None):
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    v = torch.zeros_like(b)
    p = torch.zeros_like(b)
    return (x, r, v, p, one, one, one, _dot(r, r), 0,
            torch.zeros((), dtype=torch.bool, device=b.device))


def bicgstab_step(matvec, precond, _dot, rhat, state):
    """One preconditioned BiCGStab iteration (two preconditioner
    applications, two matvecs).  On breakdown (rho == 0 or omega == 0)
    x and r keep their values, as in the JAX package."""
    x, r, v, p, rho, alpha, omega, rr, k, brk = state
    rho_new = _dot(rhat, r)
    breakdown = (rho_new == 0) | (omega == 0)
    beta = (rho_new / torch.where(rho != 0, rho, 1.0)) * \
           (alpha / torch.where(omega != 0, omega, 1.0))
    p = r + beta * (p - omega * v)
    phat = precond(p)
    v = matvec(phat)
    rhat_v = _dot(rhat, v)
    alpha = rho_new / torch.where(rhat_v != 0, rhat_v, 1.0)
    s = r - alpha * v
    shat = precond(s)
    t = matvec(shat)
    tt = _dot(t, t)
    omega = _dot(t, s) / torch.where(tt != 0, tt, 1.0)
    x_new = x + alpha * phat + omega * shat
    r_new = s - omega * t
    frozen = brk | breakdown
    x = torch.where(frozen, x, x_new)
    r = torch.where(frozen, r, r_new)
    return (x, r, v, p, rho_new, alpha, omega, _dot(r, r), k + 1, frozen)


def stationary_init(matvec, precond, b, _dot, x0=None):
    """The standalone multigrid iteration x += M^-1 r (method "amg")."""
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    return (x, r, _dot(r, r), 0)


def stationary_step(matvec, precond, _dot, state):
    x, r, rr, k = state
    e = precond(r)
    x = x + e
    r = r - matvec(e)       # one matvec per iteration (incremental residual)
    return (x, r, _dot(r, r), k + 1)
