"""Krylov iterations (the port of ``sparsh_amg_tpu/solve/krylov.py``): the
init and step functions of preconditioned CG, BiCGStab and the stationary
AMG iteration, with the JAX package's state tuples, and their chunks.
Every scalar, the iteration count k included, is a 0-d tensor on the
device, so a chunk runs with no host sync and captures as a CUDA graph.

* PCG: (x, r, z, p, r.z, r.r, k);
* BiCGStab: (x, r, v, p, rho, alpha, omega, r.r, k, breakdown);
* stationary: (x, r, r.r, k).

A chunk (``pcg_chunk``, ``bicgstab_chunk``, ``stationary_chunk``) is k
calls of the step with no data-dependent control flow: the host loop
mode, which may step up to k-1 times past convergence.  The device loop
mode steps one at a time on fixed buffers, with the steps' in-place
forms (``pcg_step_``, ``bicgstab_step_``, ``stationary_step_``: the same
bits, no copy of the state per step).

``loop_continue`` is the condition of the JAX package's device-mode
``lax.while_loop`` (``sparsh_amg_tpu/solve/krylov.py:73-77``, ``:164-167``,
``:227-230``): ||r||^2 finite and above the pass's target, k below its
budget, and (BiCGStab) no breakdown.  The device loop mode steps while it
holds: on the card inside one CUDA graph (``solve/graphs.py``, the guard
kernel of ``csrc/graph_loop.cu``), on the CPU in a Python loop.  With a
``guard`` a chunk's steps are predicated on it (``masked``): a step past
convergence, the budget or a breakdown changes no bit of the state.
"""
from __future__ import annotations

import torch

# state index of ||r||^2, of the iteration count and of the breakdown flag
READS = {"cg": (5, 6, None), "bicgstab": (7, 8, 9), "amg": (2, 3, None)}


def _count(b: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=b.device)


def pcg_init(matvec, precond, b, _dot, x0=None):
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    z = precond(r)
    p = z
    return (x, r, z, p, _dot(r, z), _dot(r, r), _count(b))


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
    return (x, r, v, p, one, one, one, _dot(r, r), _count(b),
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


def pcg_step_(matvec, precond, _dot, state) -> None:
    """``pcg_step`` advancing the state's buffers in place: the same
    operations in the same order (the same bits), each vector written
    where it lies instead of copied back after the step.  z, which the
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
    """``bicgstab_step`` advancing the state's buffers in place (see
    ``pcg_step_``)."""
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


def stationary_init(matvec, precond, b, _dot, x0=None):
    """The standalone multigrid iteration x += M^-1 r (method "amg")."""
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    return (x, r, _dot(r, r), _count(b))


def stationary_step(matvec, precond, _dot, state):
    x, r, rr, k = state
    e = precond(r)
    x = x + e
    r = r - matvec(e)       # one matvec per iteration (incremental residual)
    return (x, r, _dot(r, r), k + 1)


def stationary_step_(matvec, precond, _dot, state) -> None:
    """``stationary_step`` advancing the state's buffers in place (see
    ``pcg_step_``)."""
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
    """step(state) -> None: one plain step of `method` on the state's
    buffers (the body of the device loop mode's loop); BiCGStab's shadow
    residual is `rhat`."""
    if method == "bicgstab":
        return lambda st: bicgstab_step_(matvec, precond, _dot, rhat, st)
    step = {"cg": pcg_step_, "amg": stationary_step_}[method]
    return lambda st: step(matvec, precond, _dot, st)


def masked(step, method: str, guard):
    """`step` predicated on the device by ``loop_active``: an active step
    gives the plain step's bits; an inactive one leaves every state entry
    bit for bit unchanged and k where it was."""

    def step_masked(state):
        active = loop_active(method, state, guard)
        new = step(state)
        return tuple(torch.where(active, n, o) for n, o in zip(new, state))

    return step_masked


def _chunk(step, chunk: int, method: str, guard):
    if guard is not None:
        step = masked(step, method, guard)

    def chunk_fn(state):
        for _ in range(chunk):
            state = step(state)
        return state

    return chunk_fn


def pcg_chunk(matvec, precond, chunk: int, _dot, guard=None):
    """(init_fn(b) -> state, chunk_fn(state) -> state): chunk_fn advances
    `chunk` iterations with no data-dependent control flow (each one
    predicated when a guard is given, see ``masked``)."""
    init_fn = lambda b, x0=None: pcg_init(matvec, precond, b, _dot, x0)
    return init_fn, _chunk(lambda st: pcg_step(matvec, precond, _dot, st),
                           chunk, "cg", guard)


def bicgstab_chunk(matvec, precond, chunk: int, _dot, guard=None):
    """BiCGStab's (init_fn(b), chunk_fn(rhat, state)), as pcg_chunk."""
    init_fn = lambda b, x0=None: bicgstab_init(matvec, b, _dot, x0)

    def chunk_fn(rhat, state):
        return _chunk(lambda st: bicgstab_step(matvec, precond, _dot, rhat,
                                               st),
                      chunk, "bicgstab", guard)(state)

    return init_fn, chunk_fn


def stationary_chunk(matvec, precond, chunk: int, _dot, guard=None):
    """The stationary iteration's (init_fn(b), chunk_fn(state)), as
    pcg_chunk (the JAX package unrolls it inside its solver)."""
    init_fn = lambda b, x0=None: stationary_init(matvec, precond, b, _dot, x0)
    return init_fn, _chunk(
        lambda st: stationary_step(matvec, precond, _dot, st), chunk, "amg",
        guard)
