"""Top-level solver (the port of ``sparsh_amg_tpu/solve/solver.py``).

The hierarchy is built on the host in float64 (the shared setup), frozen
into padded device layouts, and solved by AMG-preconditioned CG or
BiCGStab, or by the stationary AMG iteration, in fp32 inside
mixed-precision iterative refinement: each pass computes the residual in
fp64 on the device, solves for a correction in fp32, and adds it to the
fp64 solution.  The Krylov loop is a plain host loop with one host sync
per iteration (||r||^2, and BiCGStab's breakdown flag in the same read).
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.blas import dot as _blas_dot
from ..ops.block_ell import BlockEllMatrix
from ..ops.formats import EllMatrix, spmv
from ..ops.fp64 import csr_to_fp64, residual64, to_fp32
from ..params import AMGParams, KrylovParams
from ..setup.hierarchy import Hierarchy, amg_setup
from ..setup.reorder import maybe_reorder
from .cycles import make_cycle
from .device import DeviceHierarchy, _torch_dtype, to_device
from .krylov import (bicgstab_init, bicgstab_step, pcg_init, pcg_step,
                     stationary_init, stationary_step)

# state index of ||r||^2 and of the iteration count, per method
_READS = {"cg": (5, 6), "bicgstab": (7, 8), "amg": (2, 3)}


@dataclasses.dataclass
class SolveResult:
    _x: object                 # float64 solution, or a zero-arg callable
                               # that downloads it on first access
    converged: bool
    relres: float              # final true relative residual (fp64)
    iterations: int            # total inner Krylov iterations
    refine_passes: int
    setup_time: float
    solve_time: float
    history: list              # per-pass (inner_iters, relres after pass)

    @property
    def x(self) -> np.ndarray:
        """Solution, float64 (downloaded on first access)."""
        if callable(self._x):
            self._x = self._x()
        return self._x

    def __repr__(self):
        return (f"SolveResult(converged={self.converged}, "
                f"relres={self.relres:.3e}, iters={self.iterations}, "
                f"passes={self.refine_passes}, setup={self.setup_time:.3f}s, "
                f"solve={self.solve_time:.3f}s)")


@dataclasses.dataclass(frozen=True)
class DeviceRhs:
    """A right-hand side already permuted, padded and resident on the
    device in fp64 (see AMGSolver.prepare_rhs)."""
    b: torch.Tensor
    bnorm: float


class AMGSolver:
    """Reusable AMG-preconditioned Krylov solver for a fixed matrix
    (krylov.method: "cg", "bicgstab", or "amg", the cycle alone).

    >>> solver = AMGSolver(A, params, krylov, device="cuda")
    >>> res = solver.solve(b)           # b float64, returns SolveResult
    """

    def __init__(self, A: sp.csr_matrix, params: AMGParams | None = None,
                 krylov: KrylovParams | None = None,
                 hierarchy: Hierarchy | None = None, nullspace=None, *,
                 device):
        self.torch_device = torch.device(device)
        self.params = params or (hierarchy.params if hierarchy else None) \
            or AMGParams()
        self.krylov = krylov or KrylovParams()
        if self.krylov.method not in _READS:
            raise ValueError(f"unknown Krylov method {self.krylov.method!r}")
        # the dense coarse solve and dense levels must stay fp32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        A = A.tocsr()
        self.n = A.shape[0]
        self.perm = None
        if hierarchy is None:
            A, self.perm = maybe_reorder(A, self.params.reorder)
            if nullspace is not None and self.perm is not None:
                nullspace = np.asarray(nullspace)[self.perm]
        self.hierarchy: Hierarchy = hierarchy or amg_setup(
            A, self.params, nullspace=nullspace)
        # fp64 fine operator for the refinement residuals, uploaded once;
        # the fp32 Krylov operator and the band_dtype cycle operator are
        # cast from it on the device
        self.A64 = csr_to_fp64(A, prefer_dia=self.params.prefer_dia,
                               dia_max_bands=self.params.dia_max_bands,
                               device=self.torch_device)
        self.A32 = to_fp32(self.A64)
        self.device: DeviceHierarchy = to_device(
            self.hierarchy, self.params, fine_hi=self.A32,
            device=self.torch_device)
        # The Krylov matvec runs on the fp32 fine operator.  When the
        # cycle's fine operator holds the same fp32 values in the block
        # layout (elasticity: node blocks against the fp64 path's scalar
        # ELL-T rows), the matvec goes through it: the entries are the
        # same fp32 rounding of A, only the summation order differs, and
        # the fp32 ELL-T copy is dropped.
        L0 = self.device.levels[0].A
        self.mv_from_level0 = (
            _torch_dtype(self.params.band_dtype) == torch.float32
            and isinstance(self.A64, EllMatrix)
            and isinstance(L0, BlockEllMatrix))
        if self.mv_from_level0:
            self.A32 = None
        self._krylov_op = L0 if self.mv_from_level0 else self.A32
        self.n_pad = self.device.levels[0].n_pad
        self._cycle = make_cycle(self.params)
        self._dot = partial(_blas_dot, compensated=self.krylov.compensated_dots)
        self._floor_est = None     # fp32 attainable pass contraction, once seen
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)
        self.setup_time = time.perf_counter() - t0

    def device_bytes(self) -> int:
        """Persistent device footprint: frozen hierarchy + fp64 and fp32
        fine operators (tensors shared between them counted once; no fp32
        copy when the Krylov matvec runs on level 0's block operator)."""
        from ..utils.meminfo import tree_device_bytes
        return tree_device_bytes((self.device, self.A64, self.A32))

    def warm(self) -> None:
        """One throwaway solve of a ones right-hand side at tol 1e-1, then
        one fp64 refinement residual and its norm, so the kernel builds
        (nvcc, at first launch), the first launch of every kernel and the
        allocator's first growth happen before any timed solve.  Leaves
        no state behind (the fp32 floor estimate is untouched)."""
        b64 = self.prepare_rhs(np.ones(self.n)).b
        x, _, _ = self._inner_solve(b64.float(), 1e-1, self.krylov.maxiter)
        r = residual64(self.A64, b64, x.double())
        self._dot(r, r).item()

    def _inner_solve(self, b: torch.Tensor, tol: float, maxiter: int):
        """fp32 AMG-preconditioned iteration on b from x = 0 until
        ||r|| <= tol ||b||, maxiter iterations, or a BiCGStab breakdown.
        Returns (x, iters, relres)."""
        levels = self.device.levels
        mv = lambda v: spmv(self._krylov_op, v)
        pc = lambda r: self._cycle(levels, r)
        dot, method = self._dot, self.krylov.method
        if method == "cg":
            state = pcg_init(mv, pc, b, dot)
            step = lambda st: pcg_step(mv, pc, dot, st)
        elif method == "bicgstab":
            # the shadow residual is the pass's right-hand side
            state = bicgstab_init(mv, b, dot)
            step = lambda st: bicgstab_step(mv, pc, dot, b, st)
        else:
            state = stationary_init(mv, pc, b, dot)
            step = lambda st: stationary_step(mv, pc, dot, st)
        i_rr, i_k = _READS[method]
        rr0 = rr = state[i_rr].item()
        if rr0 == 0.0:
            return state[0], 0, 0.0
        target = (tol * tol) * rr0
        broken = False
        while (rr > target and np.isfinite(rr) and not broken
               and state[i_k] < maxiter):
            state = step(state)
            if method == "bicgstab":
                # ||r||^2 and the breakdown flag in one host sync
                rr, broken = torch.stack(
                    (state[7], state[9].to(state[7].dtype))).tolist()
            else:
                rr = state[i_rr].item()
        return state[0], state[i_k], float(np.sqrt(max(rr, 0.0) / rr0))

    def _pass_tol(self, tol: float, relres: float) -> float:
        """Inner tolerance for the next refinement pass: aim 10x past the
        needed drop, floored at inner_tol; once a pass has shown the fp32
        attainable floor, never ask for more than ~3x past it."""
        base = tol / max(relres, 1e-30) * 0.1
        if self._floor_est is not None:
            base = max(base, 0.3 * self._floor_est)
        return max(self.krylov.inner_tol, base)

    def _note_pass_slack(self, relres_before: float, relres_after: float,
                         itol: float, budget_limited: bool) -> None:
        """A finished pass that undershot its request by >3x was limited by
        the fp32 attainable floor, not by inner depth: record the floor
        (geometric mean; persists across solves).  A pass cut short by the
        iteration budget says nothing about the floor and is skipped."""
        if relres_before <= 0.0 or itol <= 0.0 or relres_after <= 0.0:
            return
        achieved = relres_after / relres_before
        if achieved > 3.0 * itol and not budget_limited:
            pf = self._floor_est
            self._floor_est = achieved if pf is None \
                else float(np.sqrt(pf * achieved))

    def _unperm(self, x: np.ndarray) -> np.ndarray:
        if self.perm is None:
            return x
        out = np.empty_like(x)
        out[self.perm] = x
        return out

    def _fetch(self, x: torch.Tensor):
        return lambda: self._unperm(
            x[: self.n].cpu().numpy().astype(np.float64))

    def prepare_rhs(self, b: np.ndarray) -> DeviceRhs:
        """Permute, pad and upload a right-hand side in fp64.  Reuse the
        result across solve() calls to keep the upload out of the solve."""
        b = np.asarray(b, dtype=np.float64)
        if self.perm is not None:
            b = b[self.perm]
        bpad = np.zeros(self.n_pad, dtype=np.float64)
        bpad[: self.n] = b
        return DeviceRhs(torch.from_numpy(bpad).to(self.torch_device),
                         float(np.linalg.norm(bpad)))

    def solve(self, b: np.ndarray | DeviceRhs, tol: float | None = None,
              maxiter: int | None = None) -> SolveResult:
        kr = self.krylov
        tol = kr.tol if tol is None else tol
        maxiter = kr.maxiter if maxiter is None else maxiter
        if not isinstance(b, DeviceRhs):
            b = self.prepare_rhs(b)
        t0 = time.perf_counter()
        b64, bnorm = b.b, b.bnorm
        if bnorm == 0.0:
            return SolveResult(np.zeros(self.n), True, 0.0, 0, 0,
                               self.setup_time, 0.0, [])
        if not kr.refine:
            x, iters, _ = self._inner_solve(b64.float(), tol, maxiter)
            r = residual64(self.A64, b64, x.double())
            relres = float(np.sqrt(max(self._dot(r, r).item(), 0.0))) / bnorm
            return SolveResult(self._fetch(x), relres <= tol, relres, iters,
                               1, self.setup_time, time.perf_counter() - t0,
                               [(iters, relres)])

        x = torch.zeros_like(b64)
        r = b64                       # residual of x = 0
        history = []
        total_iters = passes = 0
        converged = False
        relres = 1.0
        for _ in range(kr.max_refine):
            budget = maxiter - total_iters
            if budget <= 0:
                break
            itol = self._pass_tol(tol, relres)
            d, iters, _ = self._inner_solve(r.float(), itol, budget)
            x += d.double()
            r = residual64(self.A64, b64, x)
            rnsq = self._dot(r, r).item()
            passes += 1
            total_iters += iters
            relres_prev = relres
            relres = float(np.sqrt(max(rnsq, 0.0))) / bnorm
            self._note_pass_slack(relres_prev, relres, itol,
                                  budget_limited=iters >= budget)
            history.append((iters, relres))
            if relres <= tol:
                converged = True
                break
        return SolveResult(self._fetch(x), converged, relres, total_iters,
                           passes, self.setup_time, time.perf_counter() - t0,
                           history)


def solve(A: sp.csr_matrix, b: np.ndarray, params: AMGParams | None = None,
          krylov: KrylovParams | None = None, *, device, **kw) -> SolveResult:
    """One-shot convenience wrapper: setup + solve."""
    return AMGSolver(A, params, krylov, device=device).solve(b, **kw)
