"""Krylov iterations (the port of ``sparsh_amg_tpu/solve/krylov.py``): the
init and the in-place step of preconditioned CG, BiCGStab and the
stationary AMG iteration, with the JAX package's state tuples.  Every
scalar, the iteration count k included, is a 0-d tensor on the device, so
a step runs with no host sync and captures as a CUDA graph.

* PCG: (x, r, z, p, r.z, r.r, k);
* BiCGStab: (x, r, v, p, rho, alpha, omega, r.r, k, breakdown);
* stationary: (x, r, r.r, k).

A step (``pcg_step_``, ``bicgstab_step_``, ``stationary_step_``) advances
the state's buffers in place: the JAX package's step, its operations in
the same order, each vector written where it lies.

``loop_continue`` is the condition of the JAX package's device-mode
``lax.while_loop`` (``sparsh_amg_tpu/solve/krylov.py:73-77``, ``:164-167``,
``:227-230``): ||r||^2 finite and above the pass's target, k below its
budget, and (BiCGStab) no breakdown.  Each refinement pass steps while it
holds: on the card inside one CUDA graph (``solve/graphs.py``, the guard
kernel of ``csrc/graph_loop.cu``), on the CPU in a Python loop.
"""
from __future__ import annotations

import torch

# state index of ||r||^2, of the iteration count and of the breakdown flag
READS = {"cg": (5, 6, None), "bicgstab": (7, 8, 9), "amg": (2, 3, None)}


def _count(b: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=b.device)


def pcg_init(matvec, precond, b, _dot):
    # x before the cycle's temporaries: the allocation order sets where a
    # captured graph's blocks land in its pool, and so the pool's peak
    x = torch.zeros_like(b)
    z = precond(b)
    return (x, b, z, z, _dot(b, z), _dot(b, b), _count(b))


def bicgstab_init(matvec, b, _dot):
    x = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    return (x, b, torch.zeros_like(b), torch.zeros_like(b), one, one, one,
            _dot(b, b), _count(b),
            torch.zeros((), dtype=torch.bool, device=b.device))


def pcg_step_(matvec, precond, _dot, state) -> None:
    """One PCG iteration on the state's buffers, in place.  z, which the
    next step recomputes from r, keeps its old value."""
    x, r, _, p, rz_, rr_, k = state
    q = matvec(p)
    pq = _dot(p, q)
    alpha = rz_ / torch.where(pq != 0, pq, 1.0)
    x.add_(alpha * p)
    r.sub_(alpha * q)
    z = precond(r)
    rz_new = _dot(r, z)
    beta = rz_new / torch.where(rz_ != 0, rz_, 1.0)
    torch.add(z, beta * p, out=p)
    rz_.copy_(rz_new)
    rr_.copy_(_dot(r, r))
    k.add_(1)


def bicgstab_step_(matvec, precond, _dot, rhat, state) -> None:
    """One preconditioned BiCGStab iteration (two preconditioner
    applications, two matvecs) on the state's buffers, in place.  On
    breakdown (rho == 0 or omega == 0) x and r keep their values, as in
    the JAX package."""
    x, r, v, p, rho, alpha, omega, rr, k, brk = state
    rho_new = _dot(rhat, r)
    breakdown = (rho_new == 0) | (omega == 0)
    beta = (rho_new / torch.where(rho != 0, rho, 1.0)) * \
           (alpha / torch.where(omega != 0, omega, 1.0))
    torch.add(r, beta * (p - omega * v), out=p)
    phat = precond(p)
    v_new = matvec(phat)
    rhat_v = _dot(rhat, v_new)
    alpha_new = rho_new / torch.where(rhat_v != 0, rhat_v, 1.0)
    s = r - alpha_new * v_new
    shat = precond(s)
    t = matvec(shat)
    tt = _dot(t, t)
    omega_new = _dot(t, s) / torch.where(tt != 0, tt, 1.0)
    x_new = x + alpha_new * phat + omega_new * shat
    frozen = brk | breakdown
    torch.where(frozen, x, x_new, out=x)
    torch.where(frozen, r, s - omega_new * t, out=r)
    v.copy_(v_new)
    rho.copy_(rho_new)
    alpha.copy_(alpha_new)
    omega.copy_(omega_new)
    rr.copy_(_dot(r, r))
    k.add_(1)
    brk.copy_(frozen)


def stationary_init(matvec, precond, b, _dot):
    """The standalone multigrid iteration x += M^-1 r (method "amg")."""
    return (torch.zeros_like(b), b, _dot(b, b), _count(b))


def stationary_step_(matvec, precond, _dot, state) -> None:
    """One stationary iteration x += M^-1 r on the state's buffers, in
    place (one matvec: the residual is updated incrementally)."""
    x, r, rr, k = state
    e = precond(r)
    x.add_(e)
    r.sub_(matvec(e))
    rr.copy_(_dot(r, r))
    k.add_(1)


def loop_active(method: str, state, guard) -> torch.Tensor:
    """The loop condition as a 0-d bool tensor on the state's device (no
    host read): ||r||^2 finite and above target, k below maxiter, and
    (BiCGStab) no breakdown yet.  guard = (target, maxiter): 0-d tensors
    on the state's device (fp64; maxiter fp64 or int32) that the host
    fills before a pass."""
    i_rr, i_k, i_brk = READS[method]
    target, maxiter = guard
    rr = state[i_rr]
    active = (rr.double() > target) & torch.isfinite(rr) \
        & (state[i_k] < maxiter)
    if i_brk is not None:
        active = active & ~state[i_brk]
    return active


def loop_continue(method: str, state, guard) -> bool:
    """Whether a pass steps again (``loop_active``, read on the host): the
    plain version of the guard kernel of ``csrc/graph_loop.cu``."""
    return bool(loop_active(method, state, guard))


def loop_record(method: str, state) -> torch.Tensor:
    """(||r||^2, k, breakdown) of a state in fp64, as the guard kernel
    writes them for the host (breakdown 0 for CG and the stationary
    iteration)."""
    i_rr, i_k, i_brk = READS[method]
    brk = torch.zeros((), dtype=torch.float64, device=state[i_rr].device) \
        if i_brk is None else state[i_brk].double()
    return torch.stack((state[i_rr].double(), state[i_k].double(), brk))


def step_inplace(matvec, precond, method: str, _dot, rhat=None):
    """step(state) -> None: one step of `method` on the state's buffers
    (the body of the loop); BiCGStab's shadow residual is `rhat`."""
    if method == "bicgstab":
        return lambda st: bicgstab_step_(matvec, precond, _dot, rhat, st)
    step = {"cg": pcg_step_, "amg": stationary_step_}[method]
    return lambda st: step(matvec, precond, _dot, st)
