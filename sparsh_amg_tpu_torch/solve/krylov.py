"""Preconditioned conjugate gradients (the port of ``pcg_init`` and
``pcg_step`` in ``sparsh_amg_tpu/solve/krylov.py``), with the same 7-tuple
state (x, r, z, p, r.z, r.r, k).  The scalars stay 0-d tensors on the
device; the solver reads r.r once per iteration."""
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
