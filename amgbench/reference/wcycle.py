"""The plain reference of the port's preconditioner and Krylov method on
the W-cycle cells: one multigrid W-cycle with l1-Jacobi sweeps, and
BiCGStab preconditioned by it, in float64 with plain PyTorch (sparse CSR
products and a dense LU).  It imports nothing of the program: it takes the
host hierarchy's CSR matrices, A, P and R of each level, as SciPy or
``torch.sparse_csr`` matrices.

It follows ``sparsh_amg_tpu_torch/solve/cycles.py``'s recursion: on each
level but the coarsest, ``nu1`` sweeps of l1-Jacobi from a zero start,
the residual restricted, two visits to the next level (the second from
the first's result; a visit to the coarsest level solves there and reads
no start), the prolonged correction added, ``nu2`` sweeps.  A sweep is
x <- x + D_l1^-1 (b - A x) with D_l1 = diag(a_ii + sum_{j != i} |a_ij|)
(``solve/smoothers.py::l1_jacobi``; 0 where D_l1 is 0).  BiCGStab is
``solve/krylov.py::bicgstab_step_`` (right preconditioning, the shadow
residual the right-hand side), from x = 0 until the recurrence's
||r|| <= tol ||b||.

Departures from the port, each on purpose:

* every number is float64: the port runs the cycle in its configured
  precision (fp32 levels) inside fp64 iterative refinement;
* the coarsest level is solved by an LU factorisation (``lu_factor`` /
  ``lu_solve``), where the port multiplies by an explicit fp32 inverse
  computed on the host (or, above ``coarse_inv_max``, smooths);
* a zero start is a sweep from x = 0 (the same numbers as the port's
  D_l1^-1 b);
* no padding: vectors have the level's own length;
* one BiCGStab run to tol, where the port restarts in refinement passes.
"""
from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch


def csr(M, device="cpu") -> torch.Tensor:
    """M (SciPy sparse or ``torch.sparse_csr``) as a float64 torch CSR
    matrix on `device`."""
    if isinstance(M, torch.Tensor):
        return M.to(device=device, dtype=torch.float64)
    M = sp.csr_matrix(M)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "beta" support
        return torch.sparse_csr_tensor(
            torch.from_numpy(M.indptr.astype(np.int64)),
            torch.from_numpy(M.indices.astype(np.int64)),
            torch.from_numpy(M.data.astype(np.float64)),
            size=M.shape, device=device, check_invariants=False)


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x for a torch CSR matrix A."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return torch.mv(A, x)


def l1_diagonal_inverse(A: torch.Tensor) -> torch.Tensor:
    """1 / (a_ii + sum_{j != i} |a_ij|) of a torch CSR matrix, 0 where
    that is 0."""
    crow, col, val = (A.crow_indices(), A.col_indices(), A.values())
    n = A.shape[0]
    row = torch.repeat_interleave(torch.arange(n, device=val.device),
                                  crow[1:] - crow[:-1])
    diag = torch.zeros(n, dtype=val.dtype, device=val.device).index_add_(
        0, row, torch.where(row == col, val, 0.0))
    absrow = torch.zeros_like(diag).index_add_(0, row, val.abs())
    l1 = diag + (absrow - diag.abs())
    return torch.where(l1 != 0, 1.0 / torch.where(l1 != 0, l1, 1.0), 0.0)


class WCycle:
    """M^-1 b by one multigrid W-cycle over `levels`: a list of (A, P, R),
    P and R None on the coarsest level (the matrices as ``csr`` takes
    them); ``nu1``/``nu2`` l1-Jacobi sweeps before and after the coarse
    correction."""

    def __init__(self, levels: list, nu1: int = 1, nu2: int = 1,
                 device="cpu"):
        self.nu1, self.nu2 = nu1, nu2
        self.A, self.P, self.R, self.l1inv = [], [], [], []
        for A, P, R in levels[:-1]:
            A = csr(A, device)
            self.A.append(A)
            self.P.append(csr(P, device))
            self.R.append(csr(R, device))
            self.l1inv.append(l1_diagonal_inverse(A))
        Ac = levels[-1][0]
        Ac = Ac.to_dense() if isinstance(Ac, torch.Tensor) \
            else sp.csr_matrix(Ac).toarray()
        self.lu = torch.linalg.lu_factor(torch.as_tensor(
            Ac, dtype=torch.float64, device=device))

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, b)

    def _coarse(self, b: torch.Tensor) -> torch.Tensor:
        return torch.linalg.lu_solve(*self.lu, b[:, None])[:, 0]

    def _smooth(self, l: int, b: torch.Tensor, x: torch.Tensor,
                sweeps: int) -> torch.Tensor:
        for _ in range(sweeps):
            x = x + self.l1inv[l] * (b - mv(self.A[l], x))
        return x

    def _cycle(self, l: int, b: torch.Tensor, x=None) -> torch.Tensor:
        """A visit to level l from x (None: from zero)."""
        if l == len(self.A):
            return self._coarse(b)
        x = self._smooth(l, b, torch.zeros_like(b) if x is None else x,
                         self.nu1)
        rc = mv(self.R[l], b - mv(self.A[l], x))
        ec = self._cycle(l + 1, rc)
        ec = self._cycle(l + 1, rc, ec)
        x = x + mv(self.P[l], ec)
        return self._smooth(l, b, x, self.nu2)


def bicgstab(A, b: torch.Tensor, precond, tol: float = 1e-8,
             maxiter: int = 400) -> tuple:
    """(x, iterations, breakdown) of BiCGStab on A x = b (A as ``csr``
    takes it), right-preconditioned by `precond`, from x = 0, stepping
    while the recurrence's ||r|| > tol ||b|| and no breakdown (rho or
    omega 0)."""
    A = csr(A, b.device)
    b = b.to(torch.float64)
    x = torch.zeros_like(b)
    r, rhat = b.clone(), b.clone()
    v, p = torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = 1.0
    target = tol * float(torch.linalg.vector_norm(b))
    k = 0
    while k < maxiter and float(torch.linalg.vector_norm(r)) > target:
        rho_new = float(rhat @ r)
        if rho_new == 0.0 or omega == 0.0:
            return x, k, True
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = mv(A, phat)
        rv = float(rhat @ v)
        alpha = rho_new / (rv if rv != 0.0 else 1.0)
        s = r - alpha * v
        shat = precond(s)
        t = mv(A, shat)
        tt = float(t @ t)
        omega = float(t @ s) / (tt if tt != 0.0 else 1.0)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    return x, k, False
