"""Top-level solver (the port of ``sparsh_amg_tpu/solve/solver.py``).

The hierarchy is built on the host in float64 (the shared setup), frozen
into padded device layouts, and solved by AMG-preconditioned CG or
BiCGStab, or by the stationary AMG iteration, in fp32 inside
mixed-precision iterative refinement: each pass computes the residual in
fp64 on the device, solves for a correction in fp32, and adds it to the
fp64 solution.

Each refinement pass is one device-resident loop, the JAX package's
device loop mode (``_inner_solve_dev``'s ``lax.while_loop``): the start
(the cast of b or the previous pass's residual, the Krylov init), the
plain step while ``krylov.loop_continue`` holds, and the finish (x += d
in fp64, the true residual and its norm).  On the card that is one
launch of a CUDA graph with a WHILE node (``solve/graphs.py``) and one
host read per pass; on the CPU the same pass runs eagerly with the loop
in Python.  The counts are exact.

Each pass is capped at the iterations left of the solve's budget (the JAX
device mode gives every pass the whole ``maxiter``).
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
from ..ops.fp64 import csr_to_fp64, finish64, to_fp32
from ..params import AMGParams, KrylovParams
from ..setup.hierarchy import Hierarchy, amg_setup
from ..setup.reorder import maybe_reorder
from ..utils import trace
from .cycles import make_cycle
from .device import DeviceHierarchy, _torch_dtype, to_device
from .graphs import ChunkGraph, PassGraph
from .krylov import (READS, bicgstab_init, loop_record, pcg_init,
                     stationary_init, step_inplace)

# the Krylov init of each method as init(matvec, precond, b, dot)
_INITS = {"cg": pcg_init,
          "bicgstab": lambda mv, pc, b, dot: bicgstab_init(mv, b, dot),
          "amg": stationary_init}


def _parts(method, init, step, A64, dot, b64, x64, b, limits, state, guard,
           prog) -> dict:
    """{name: (fn, bufs)} of the loop's four graphs.  The functions close
    over the buffers and the operators alone: a graph holds its function,
    and one that held the loop would keep the loop and its graphs (and
    their device memory) alive until the cyclic collector ran."""
    i_rr = READS[method][0]

    def cast(bufs):
        return b64, torch.zeros_like(x64)

    def start(bufs):
        st = init(b)
        rr0 = st[i_rr].double()
        return (*st, limits[0] * rr0,
                torch.cat((loop_record(method, st), rr0.reshape(1))))

    def advance(bufs):
        # the tracer's stamps, when it is on while the step is captured
        with trace.stamping(b.device):
            step(state)
        return ()

    def finish(bufs):
        x, r, rr = bufs
        return finish64(A64, x, state[0], b64, r, rr, dot)

    return {"cast": (cast, (b, x64)),
            "init": (start, (*state, guard[0], prog[:4])),
            "step": (advance, ()),
            "finish": (finish, (x64, b, prog[4:]))}


class _Loop:
    """The static buffers and graphs of one Krylov method on one solver.
    Every graph reads and writes only these buffers: the state tuple, the
    solve's right-hand side and solution in fp64 (``b64``, ``x64``), the
    pass's right-hand side ``b`` in fp32 (BiCGStab's shadow residual),
    ``limits`` (tol^2 and the iteration budget, filled by the host before
    a pass), the target ||r||^2 in fp64, and ``prog``, what the host
    reads: (||r||^2, k, breakdown, ||r0||^2, true ||r||^2 after the pass)
    in fp64.  The graphs, all in one memory pool:

    * ``cast`` (pass 0's start): b = fp32(b64), x64 = 0;
    * ``init``: the Krylov state from b, the target, prog[:4];
    * ``step``: one plain step on the state's buffers, in place (the
      body of the loop);
    * ``finish``: x64 += x, r = b64 - A64 x64 in fp64, prog[4] = ||r||^2
      and b = fp32(r), the next pass's right-hand side (so a later pass
      starts with ``init`` alone, as the JAX package's ``refine_start``
      starts from the residual of the previous pass's x); on a DIA
      operator on the card one kernel writing the buffers in place
      (``ops.fp64.finish64``);
    * the two pass graphs (``pass_graph``): cast and init, or init alone,
      then the step while ``krylov.loop_continue`` holds, then finish."""

    def __init__(self, solver, method: str):
        dev, n = solver.torch_device, solver.n_pad
        self.method = method
        self.capture = solver.capture and dev.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.b64 = torch.zeros(n, dtype=torch.float64, device=dev)
        self.x64 = torch.zeros(n, dtype=torch.float64, device=dev)
        self.b = torch.zeros(n, dtype=torch.float32, device=dev)
        self.limits = torch.zeros(2, dtype=torch.float64, device=dev)
        self._limits_host = torch.zeros(2, dtype=torch.float64,
                                        pin_memory=self.capture)
        self.guard = (torch.zeros((), dtype=torch.float64, device=dev),
                      self.limits[1])
        self.prog = torch.zeros(5, dtype=torch.float64, device=dev)
        # the operators, not the solver: a loop that referenced its solver
        # would hold it (and its device memory) while a graph held the loop
        mv = partial(spmv, solver._krylov_op)
        pc = partial(solver._cycle, solver.device.levels)
        dot = solver._dot
        init = lambda b: _INITS[method](mv, pc, b, dot)
        self.state = tuple(t.clone() for t in init(self.b))
        parts = _parts(method, init,
                       step_inplace(mv, pc, method, dot, self.b),
                       solver.A64, dot, self.b64, self.x64, self.b,
                       self.limits, self.state, self.guard, self.prog)
        if self.capture:
            # one eager run of each part first: the kernel build, each
            # first launch and the BLAS handles happen outside any capture
            # (the buffers hold nothing of a solve yet)
            for fn, bufs in parts.values():
                ChunkGraph(fn, bufs, False).run()
        for name, (fn, bufs) in parts.items():
            setattr(self, name, ChunkGraph(fn, bufs, self.capture, self.pool))
        self.passes = {}
        self.pass_ms = []          # the current solve's pass graphs' ms

    def set_limits(self, tol: float, budget: int) -> None:
        """tol^2 and the budget of the next pass: one copy to the device."""
        self._limits_host[0], self._limits_host[1] = tol * tol, budget
        with trace.device_op("solve.limits", self.limits.device):
            self.limits.copy_(self._limits_host, non_blocking=True)

    def pass_graph(self, first: bool) -> PassGraph:
        """The pass (pass 0's when `first`), built on first use."""
        g = self.passes.get(first)
        if g is None:
            heads = [self.cast, self.init] if first else [self.init]
            g = self.passes[first] = PassGraph(
                heads, self.step, [self.finish], self.method, self.state,
                self.guard, self.prog, self.capture)
        return g

    def all_graphs(self) -> list:
        return [self.cast, self.init, self.step, self.finish]

    def release(self) -> None:
        """Destroy every graph of the loop (the pass graphs first: they
        hold copies of the others)."""
        for g in (*self.passes.values(), *self.all_graphs()):
            g.release()


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
    host_reads: int = 0        # reads of the device by the host: one per
                               # pass graph (an eager pass reads the guard
                               # after every step too)
    pass_ms: list = dataclasses.field(default_factory=list)
                               # device ms of each pass graph launch (CUDA
                               # events; captured passes only)

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


def check_krylov(krylov: KrylovParams) -> None:
    """Validate the method and the loop placement: the port places the
    Krylov loop one way, on the device (``loop_mode="device"``)."""
    if krylov.method not in READS:
        raise ValueError(f"unknown Krylov method {krylov.method!r}")
    if krylov.loop_mode != "device":
        raise ValueError(f"loop_mode {krylov.loop_mode!r}: the port has one "
                         f"placement of the Krylov loop, the device loop "
                         f"(loop_mode=\"device\")")


class AMGSolver:
    """Reusable AMG-preconditioned Krylov solver for a fixed matrix
    (krylov.method: "cg", "bicgstab", or "amg", the cycle alone).

    >>> solver = AMGSolver(A, params, krylov, device="cuda")
    >>> res = solver.solve(b)           # b float64, returns SolveResult

    On the card the loop's graphs are captured once and replayed (each
    pass as one launch); the CPU runs the same
    pieces eagerly.  Shallow copies share the graphs and their buffers; a
    copy with ``capture = False`` runs them eagerly on the card too (its
    own buffers).
    """

    capture = True

    def __init__(self, A: sp.csr_matrix, params: AMGParams | None = None,
                 krylov: KrylovParams | None = None,
                 hierarchy: Hierarchy | None = None, nullspace=None, *,
                 device):
        self.torch_device = torch.device(device)
        self.params = params or (hierarchy.params if hierarchy else None) \
            or AMGParams()
        self.krylov = krylov or KrylovParams()
        check_krylov(self.krylov)
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
        self._freeze(A)
        self.setup_time = time.perf_counter() - t0

    @trace.spanned("freeze")
    def _freeze(self, A: sp.csr_matrix) -> None:
        """The fine operators and the hierarchy on the device."""
        # fp64 fine operator for the refinement residuals, uploaded once;
        # the fp32 Krylov operator and the band_dtype cycle operator are
        # cast from it on the device
        with trace.span("freeze.fine"):
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
        self._reset_loop_state()
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    def device_bytes(self) -> int:
        """Persistent device footprint: frozen hierarchy + fp64 and fp32
        fine operators (tensors shared between them counted once; no fp32
        copy when the Krylov matvec runs on level 0's block operator)."""
        from ..utils.meminfo import tree_device_bytes
        return tree_device_bytes((self.device, self.A64, self.A32))

    def _reset_loop_state(self) -> None:
        self._floor_est = None     # fp32 attainable pass contraction, once seen
        self._loops = {}           # (Krylov method, capture) -> _Loop

    def _loop(self) -> _Loop:
        key = (self.krylov.method, self.capture)
        if key not in self._loops:
            self._loops[key] = _Loop(self, key[0])
        return self._loops[key]

    def graph_seconds(self) -> tuple:
        """(capture, instantiation) seconds of every captured graph so
        far (the pass graphs' assembly: ``pass_graph_seconds``)."""
        gs = [g for lp in self._loops.values() for g in lp.all_graphs()]
        return (sum(g.capture_s for g in gs),
                sum(g.instantiate_s for g in gs))

    def pass_graph_seconds(self) -> float:
        """Seconds spent assembling, instantiating and uploading the pass
        graphs so far."""
        return sum(g.build_s for lp in self._loops.values()
                   for g in lp.passes.values())

    def release_graphs(self) -> None:
        """Destroy every CUDA graph this solver and its shallow copies
        captured, now; the next solve captures them anew.  A graph holds
        what its capture used until it is destroyed: on several NCCL ranks
        that is the communicator (``multihost.destroy_process_group``)."""
        for lp in self._loops.values():
            lp.release()
        self._loops.clear()
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    @trace.spanned("warm")
    def warm(self) -> None:
        """Capture every graph of the loop (the start, step and finish, and
        the two pass graphs), then two throwaway passes (a first and a
        later one) on a ones right-hand side at tol 1e-1, so the kernel
        builds (nvcc, at first launch), every capture and instantiation
        and the allocator's first growth happen before any timed solve.
        Leaves no estimate behind."""
        loop = self._loop()
        for first in (True, False):
            loop.pass_graph(first)
        with trace.span("warm.passes"):
            loop.b64.copy_(self.prepare_rhs(np.ones(self.n)).b)
            for first in (True, False):
                self._pass(loop, first, 1e-1, self.krylov.maxiter)

    def _pass(self, loop: _Loop, first: bool, tol: float, maxiter: int):
        """One refinement pass on the loop's buffers: the fp32 iteration
        on b (pass 0: the solve's rhs, else the previous pass's residual)
        from x = 0 until ||r|| <= tol ||b||, maxiter iterations or a
        BiCGStab breakdown, then x64 += x and the true residual.  Returns
        (iterations, true ||r||^2, host reads)."""
        loop.set_limits(tol, maxiter)
        pg = loop.pass_graph(first)
        (_, iters, _, _, rnsq), reads = pg.run()
        if pg.device_ms is not None:
            loop.pass_ms.append(pg.device_ms)
        return int(iters), rnsq, reads

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

    @trace.spanned("solve", lambda r: {"passes": r.refine_passes,
                                       "iterations": r.iterations})
    def solve(self, b: np.ndarray | DeviceRhs, tol: float | None = None,
              maxiter: int | None = None) -> SolveResult:
        kr = self.krylov
        tol = kr.tol if tol is None else tol
        maxiter = kr.maxiter if maxiter is None else maxiter
        if not isinstance(b, DeviceRhs):
            b = self.prepare_rhs(b)
        t0 = time.perf_counter()
        bnorm = b.bnorm
        if bnorm == 0.0:
            return SolveResult(np.zeros(self.n), True, 0.0, 0, 0,
                               self.setup_time, 0.0, [])
        with trace.span("solve.prologue"):
            loop = self._loop()
            with trace.device_op("solve.rhs_copy", loop.b64.device):
                loop.b64.copy_(b.b)
            loop.pass_ms = []
        history = []
        total_iters = passes = reads = 0
        converged = False
        relres = 1.0
        # without refinement: one pass to tol itself
        for _ in range(kr.max_refine if kr.refine else 1):
            budget = maxiter - total_iters
            if budget <= 0:
                break
            itol = self._pass_tol(tol, relres) if kr.refine else tol
            with trace.span("solve.pass"):
                iters, rnsq, r = self._pass(loop, passes == 0, itol, budget)
            reads += r
            passes += 1
            total_iters += iters
            relres_prev = relres
            relres = float(np.sqrt(max(rnsq, 0.0))) / bnorm
            if kr.refine:
                self._note_pass_slack(relres_prev, relres, itol,
                                      budget_limited=iters >= budget)
            history.append((iters, relres))
            if relres <= tol:
                converged = True
                break
        with trace.span("solve.epilogue"):
            # the loop's buffers belong to the next solve: keep a copy
            with trace.device_op("solve.x_clone", loop.x64.device):
                x = loop.x64.clone()
            return SolveResult(self._fetch(x), converged, relres,
                               total_iters, passes, self.setup_time,
                               time.perf_counter() - t0, history, reads,
                               loop.pass_ms)


def solve(A: sp.csr_matrix, b: np.ndarray, params: AMGParams | None = None,
          krylov: KrylovParams | None = None, *, device, **kw) -> SolveResult:
    """One-shot convenience wrapper: setup + solve."""
    return AMGSolver(A, params, krylov, device=device).solve(b, **kw)
