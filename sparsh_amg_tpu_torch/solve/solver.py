"""Top-level solver (the port of ``sparsh_amg_tpu/solve/solver.py``).

The hierarchy is built on the host in float64 (the shared setup), frozen
into padded device layouts, and solved by AMG-preconditioned CG or
BiCGStab, or by the stationary AMG iteration, in fp32 inside
mixed-precision iterative refinement: each pass computes the residual in
fp64 on the device, solves for a correction in fp32, and adds it to the
fp64 solution.

The Krylov loop runs in chunks of iterations, as in the JAX package
(``KrylovParams.loop_mode`` and ``chunk``): the host reads ||r||^2, the
count and BiCGStab's breakdown flag once per chunk and picks the next
chunk's size from the contraction seen so far (``_pick_chunk``).  On the
card every chunk is one CUDA graph replay (``solve/graphs.py``).

* ``"host"``: plain chunks; a pass may run up to chunk-1 iterations past
  convergence, as the JAX host mode does.
* ``"device"``: the same ladder of chunks, each step predicated on the
  device (``krylov.masked``): the counts are exact, those of the JAX
  package's ``lax.while_loop``, and the bits are those of ``chunk=1``.
* ``"auto"``: ``"device"`` when one launch and scalar read cost under
  1 ms (``utils.timing.resolve_loop_mode``), resolved at construction.
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
from ..utils.logging import get_logger, iteration_log
from .cycles import make_cycle
from .device import DeviceHierarchy, _torch_dtype, to_device
from .graphs import ChunkGraph
from .krylov import READS, bicgstab_chunk, pcg_chunk, stationary_chunk

_log = get_logger(__name__)

_CHUNKS = {"cg": pcg_chunk, "bicgstab": bicgstab_chunk,
           "amg": stationary_chunk}
LOOP_MODES = ("host", "device", "auto")

# tail-chunk size ladder: the scheduler lands within +1 iteration of the
# estimated need using at most two extra chunks (need <= 1 -> 1, 2 -> 2,
# 3..5 -> 4 (+1 worst case), > 5 -> 4 then re-estimate).  A fixed small
# set bounds the number of captured chunk graphs.
_TAILS = (1, 2, 4)


def _pick_chunk(need: int, main: int) -> int:
    """Chunk size for an estimated ``need`` remaining iterations: the
    smallest ladder size covering it, a full main chunk when at least a
    main chunk is known to be needed."""
    if need >= main:
        return main
    for k in _TAILS:
        if need <= k:
            return k
    return min(main, _TAILS[-1])


def chunk_sizes(main: int) -> tuple:
    """Every chunk size the scheduler can pick for a main chunk of `main`
    (the probe included)."""
    return tuple(sorted({_pick_chunk(n, main) for n in range(1, main + 1)}
                        | {min(_TAILS[-1], main)}))


class _Loop:
    """The static buffers and chunk graphs of one Krylov method on one
    solver.  Every graph reads and writes only these buffers: the state
    tuple, the pass's right-hand side `b` (BiCGStab's shadow residual),
    tol^2 and the guard (target ||r||^2 in fp64, the iteration budget),
    and `prog`, the one vector the host reads per chunk: (||r||^2, k,
    breakdown, ||r0||^2) in fp64.  Graphs are keyed by (masked, k) and
    share one memory pool."""

    def __init__(self, solver, method: str):
        dev, n = solver.torch_device, solver.n_pad
        self.method = method
        self.capture = solver.capture and dev.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        # the operators, not the solver: a loop that referenced its solver
        # would hold it (and its device memory) in a cycle until gc ran
        self._mv = partial(spmv, solver._krylov_op)
        self._pc = partial(solver._cycle, solver.device.levels)
        self._dot = solver._dot
        self.b = torch.zeros(n, dtype=torch.float32, device=dev)
        self.tol2 = torch.zeros((), dtype=torch.float64, device=dev)
        self.guard = (torch.zeros((), dtype=torch.float64, device=dev),
                      torch.zeros((), dtype=torch.int32, device=dev))
        self.prog = torch.zeros(4, dtype=torch.float64, device=dev)
        # one eager init makes the state buffers and launches every kernel
        # of the init once (the kernel build and each first launch happen
        # outside any capture)
        init_fn, _ = _CHUNKS[method](self._mv, self._pc, 1, self._dot)
        self.state = tuple(t.clone() for t in init_fn(self.b))
        self.graphs = {}
        self.init = ChunkGraph(self._init_fn, (*self.state, self.guard[0],
                                               self.prog),
                               self.capture, self.pool)
        self._warmed = set()

    def _progress(self, state, rr0):
        i_rr, i_k, i_brk = READS[self.method]
        brk = torch.zeros((), dtype=torch.float64, device=self.b.device) \
            if i_brk is None else state[i_brk].double()
        return torch.stack((state[i_rr].double(), state[i_k].double(), brk,
                            rr0))

    def _init_fn(self, bufs):
        init_fn, _ = _CHUNKS[self.method](self._mv, self._pc, 1, self._dot)
        st = init_fn(self.b)
        rr0 = st[READS[self.method][0]].double()
        return (*st, self.tol2 * rr0, self._progress(st, rr0))

    def _chunk_fn(self, masked: bool, k: int):
        _, chunk = _CHUNKS[self.method](self._mv, self._pc, k, self._dot,
                                        self.guard if masked else None)
        if self.method == "bicgstab":
            chunk = partial(chunk, self.b)

        def fn(bufs):
            st = chunk(bufs[:-1])
            return (*st, self._progress(st, bufs[-1][3]))
        return fn

    def graph(self, masked: bool, k: int) -> ChunkGraph:
        """The chunk of k (masked) steps, captured on first use; before the
        first capture of a kind, one eager step launches its kernels."""
        g = self.graphs.get((masked, k))
        if g is None:
            bufs = (*self.state, self.prog)
            if self.capture and masked not in self._warmed:
                ChunkGraph(self._chunk_fn(masked, 1), bufs, False).run()
                self._warmed.add(masked)
            g = self.graphs[(masked, k)] = ChunkGraph(
                self._chunk_fn(masked, k), bufs, self.capture, self.pool)
        return g

    def all_graphs(self) -> list:
        return [self.init, *self.graphs.values()]


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
    masked_steps: int = 0      # device mode: steps replayed past the end
                               # of a pass (predicated off, uncounted)

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


def check_krylov(krylov: KrylovParams, device) -> KrylovParams:
    """Validate the method and the loop placement; resolve "auto"."""
    if krylov.method not in READS:
        raise ValueError(f"unknown Krylov method {krylov.method!r}")
    if krylov.loop_mode not in LOOP_MODES:
        raise ValueError(f"unknown loop_mode {krylov.loop_mode!r} "
                         f"(one of {LOOP_MODES})")
    if krylov.chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {krylov.chunk}")
    if krylov.loop_mode == "auto":
        from ..utils.timing import resolve_loop_mode
        krylov = dataclasses.replace(
            krylov, loop_mode=resolve_loop_mode("auto", device))
    return krylov


class AMGSolver:
    """Reusable AMG-preconditioned Krylov solver for a fixed matrix
    (krylov.method: "cg", "bicgstab", or "amg", the cycle alone).

    >>> solver = AMGSolver(A, params, krylov, device="cuda")
    >>> res = solver.solve(b)           # b float64, returns SolveResult

    On the card each Krylov chunk is captured once as a CUDA graph and
    replayed; the CPU runs the same chunks eagerly.  Shallow copies share
    the graphs and their buffers; a copy with ``capture = False`` runs
    its chunks eagerly on the card too (its own buffers).
    """

    capture = True

    def __init__(self, A: sp.csr_matrix, params: AMGParams | None = None,
                 krylov: KrylovParams | None = None,
                 hierarchy: Hierarchy | None = None, nullspace=None, *,
                 device):
        self.torch_device = torch.device(device)
        self.params = params or (hierarchy.params if hierarchy else None) \
            or AMGParams()
        self.krylov = check_krylov(krylov or KrylovParams(),
                                   self.torch_device)
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
        self._reset_loop_state()
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)
        self.setup_time = time.perf_counter() - t0

    def device_bytes(self) -> int:
        """Persistent device footprint: frozen hierarchy + fp64 and fp32
        fine operators (tensors shared between them counted once; no fp32
        copy when the Krylov matvec runs on level 0's block operator)."""
        from ..utils.meminfo import tree_device_bytes
        return tree_device_bytes((self.device, self.A64, self.A32))

    def _reset_loop_state(self) -> None:
        self._floor_est = None     # fp32 attainable pass contraction, once seen
        self._rho2_est = None      # per-iteration ||r||^2 contraction
        self._loops = {}           # (Krylov method, capture) -> _Loop

    def _loop(self) -> _Loop:
        key = (self.krylov.method, self.capture)
        if key not in self._loops:
            self._loops[key] = _Loop(self, key[0])
        return self._loops[key]

    def graph_seconds(self) -> tuple:
        """(capture, instantiation) seconds of every chunk graph so far."""
        gs = [g for lp in self._loops.values() for g in lp.all_graphs()]
        return (sum(g.capture_s for g in gs),
                sum(g.instantiate_s for g in gs))

    def warm(self) -> None:
        """Capture every chunk graph the configured loop mode can replay
        (the init, the main chunk, the ladder 1, 2, 4 and the probe: the
        JAX package's warm() compiles the same set), then one throwaway
        solve of a ones right-hand side at tol 1e-1 and one fp64
        refinement residual and its norm, so the kernel builds (nvcc, at
        first launch), every capture and the allocator's first growth
        happen before any timed solve.  Leaves no estimate behind."""
        loop = self._loop()
        masked = self.krylov.loop_mode == "device"
        for k in chunk_sizes(self.krylov.chunk):
            loop.graph(masked, k)
        b64 = self.prepare_rhs(np.ones(self.n)).b
        rho2 = self._rho2_est
        x, _, _, _ = self._inner_solve(b64, 1e-1, self.krylov.maxiter)
        self._rho2_est = rho2
        r = residual64(self.A64, b64, x.double())
        self._dot(r, r).item()

    def _first_chunk(self, itol: float, first_pass: bool) -> int:
        """A pass's first chunk, chosen with no read of the device: on the
        first pass a main chunk when the contraction estimate says one is
        needed, else the probe; on later passes a ladder size capped at
        the probe."""
        main = self.krylov.chunk
        probe = min(_TAILS[-1], main)
        rho2 = self._rho2_est
        need = None
        if rho2 is not None and 0.0 < rho2 < 1.0:
            need = int(np.ceil(2.0 * np.log(itol) / np.log(rho2)))
        if first_pass:
            return main if need is not None and need >= main else probe
        if need is None:
            need = max(1, main // 4)
        return _pick_chunk(max(1, min(need, _TAILS[-1])), main)

    def _inner_solve(self, b: torch.Tensor, tol: float, maxiter: int,
                     first_pass: bool = True):
        """fp32 AMG-preconditioned iteration on b (cast to fp32) from x = 0
        until ||r|| <= tol ||b||, maxiter iterations, or a BiCGStab
        breakdown, in chunks: the first sized by _first_chunk, each later
        one from the contraction seen so far.  One host read per chunk.
        Returns (x, iters, relres, steps); x is the loop's buffer,
        overwritten by the next pass."""
        kr = self.krylov
        main = kr.chunk
        masked = kr.loop_mode == "device"
        loop = self._loop()
        loop.b.copy_(b)
        loop.tol2.fill_(tol * tol)
        loop.guard[1].fill_(maxiter)
        loop.init.run()
        k = self._first_chunk(tol, first_pass)
        steps = 0
        t0 = time.perf_counter()
        while True:
            loop.graph(masked, k).run()
            steps += k
            rr, iters, broken, rr0 = loop.prog.tolist()
            iters = int(iters)
            if rr0 == 0.0:
                return loop.state[0], 0, 0.0, steps
            target = (tol * tol) * rr0
            # the cumulative geometric-mean contraction of this pass
            if iters > 0 and 0.0 < rr < rr0:
                self._rho2_est = float((rr / rr0) ** (1.0 / iters))
            if _log.isEnabledFor(10):
                _log.debug("%s", iteration_log(
                    iters, float(np.sqrt(max(rr, 0.0) / rr0)),
                    time.perf_counter() - t0))
            if (rr <= target or not np.isfinite(rr) or iters >= maxiter
                    or broken):
                break
            # the next chunk lands within +1 of the projected crossing
            rho2 = self._rho2_est
            if rho2 is not None and 0.0 < rho2 < 1.0 and target > 0.0:
                need = int(np.ceil(np.log(target / rr) / np.log(rho2)))
                k = _pick_chunk(max(need, 1), main)
            elif iters == 0:
                k = min(_TAILS[-1], main)    # cold probe
            else:
                k = main
        return loop.state[0], iters, float(np.sqrt(max(rr, 0.0) / rr0)), \
            steps

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
            x, iters, _, steps = self._inner_solve(b64, tol, maxiter)
            x = x.clone()
            r = residual64(self.A64, b64, x.double())
            relres = float(np.sqrt(max(self._dot(r, r).item(), 0.0))) / bnorm
            return SolveResult(self._fetch(x), relres <= tol, relres, iters,
                               1, self.setup_time, time.perf_counter() - t0,
                               [(iters, relres)], steps - iters)

        x = torch.zeros_like(b64)
        r = b64                       # residual of x = 0
        history = []
        total_iters = passes = steps = 0
        converged = False
        relres = 1.0
        for _ in range(kr.max_refine):
            budget = maxiter - total_iters
            if budget <= 0:
                break
            itol = self._pass_tol(tol, relres)
            d, iters, _, k = self._inner_solve(r, itol, budget,
                                               first_pass=passes == 0)
            steps += k
            x += d
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
                           history, steps - total_iters)


def solve(A: sp.csr_matrix, b: np.ndarray, params: AMGParams | None = None,
          krylov: KrylovParams | None = None, *, device, **kw) -> SolveResult:
    """One-shot convenience wrapper: setup + solve."""
    return AMGSolver(A, params, krylov, device=device).solve(b, **kw)
