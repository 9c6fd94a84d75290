"""Distributed AMG-Krylov solver (the port of
``sparsh_amg_tpu/parallel/solver.py``).

One process per rank of a ``torch.distributed`` process group; each rank
holds its row block of every distributed level on its own device.  Every
rank runs the serial solver's loop (``AMGSolver``: each refinement pass
one device-resident loop, fp64 iterative refinement) on its block: the
serial cycle, smoothers and Krylov steps apply unchanged, since the
distributed operators have the serial ones' ``spmv``, the coarse level
its ``coarse_solve``, and the dots are ``pdot`` (each rank's fp64
partial, one all-reduce).  The all-reduced ||r||^2 gives every rank the
same control flow, on the device as on the host.  On the card the
loop's graphs are captured as the serial solver's are, with the halos
and all-reduces inside them, as the JAX package runs the whole solve as
one program over the mesh (``sparsh_amg_tpu/parallel/solver.py:438-478``):
one rank (no collective) or NCCL ranks capture; gloo ranks run the loop
eagerly (``loop_capture``).

Three constructors, as in the JAX package:

* ``DistAMGSolver(A, ...)``: every rank holds the global matrix, runs the
  global setup and freezes its own block;
* ``from_blocked(make_rows, n, ...)``: process-local: each rank assembles
  only its rows, runs the blocked setup (``setup/blocked.py``) with the
  other ranks and freezes its block (``parallel/blocked_dist.py``); no
  rank ever holds the global matrix, hierarchy or an O(n) vector;
* ``from_frozen(dist, A64, ...)``: an already frozen rank block.
"""
from __future__ import annotations

import time
import weakref
from functools import partial

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ..params import AMGParams, KrylovParams
from ..setup.hierarchy import Hierarchy, amg_setup
from ..setup.reorder import maybe_reorder
from ..solve.cycles import make_cycle
from ..solve.solver import AMGSolver, DeviceRhs, check_krylov
from ..utils import trace
from .dist import RankGroup, pdot
from .hierarchy import DistHierarchy, fine_fp64, to_dist


def rank_group(group=None) -> RankGroup:
    """This process's RankGroup over `group` (None: the default process
    group); rank 0 of 1 when torch.distributed is not initialised."""
    if not dist.is_available() or not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given, but "
                             "torch.distributed is not initialised")
        return RankGroup(0, 1)
    return RankGroup(dist.get_rank(group), dist.get_world_size(group), group)


def loop_capture(backend: str | None, nranks: int) -> bool:
    """Whether a solver of `nranks` ranks over `backend` captures its
    Krylov loop's graphs on the card (the CPU runs the same pieces
    eagerly).  One rank issues no collective.  NCCL ranks capture the
    halos, all-reduces and all-gathers with the kernels: each is a kernel
    on the rank's own card.  gloo stages every collective through pinned
    host buffers and the host's own transport, which no CUDA graph can
    hold, so gloo ranks run the loop eagerly."""
    return nranks == 1 or backend == "nccl"


def check_backend(backend: str, nranks: int, device) -> None:
    """NCCL moves device tensors between distinct cards: it needs CUDA and
    one card per rank.  Raise otherwise, naming the backend that shares
    cards (gloo, through pinned host buffers)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend != "nccl":
        return
    device = torch.device(device)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device.type != "cuda" or nranks > cards:
        raise ValueError(
            f'backend="nccl" needs one CUDA card per rank: {nranks} '
            f"rank(s) on {device.type} with {cards} card(s); pass "
            f'backend="gloo" to share a card or to run on the CPU')


class DistAMGSolver(AMGSolver):
    """Multi-rank AMG-preconditioned Krylov solver (every rank calls the
    same methods in the same order).

    >>> solver = DistAMGSolver(A, device=device)   # host CSR, float64
    >>> res = solver.solve(b)                      # res.x: the full x
    >>> multihost.destroy_process_group()

    Graphs that captured NCCL collectives hold the communicator until
    they are destroyed, and the group's teardown waits for them: every
    solver of the process is in ``DistAMGSolver.live``, whose graphs
    ``multihost.destroy_process_group`` (also run at exit) releases
    (``release_graphs``) before it destroys the group; destroy the group
    through it, not through ``torch.distributed`` directly.  The pass
    graphs need ``NCCL_GRAPH_MIXING_SUPPORT=0`` in the environment when
    the communicator is created (``multihost.init_process_group`` sets
    it), and with it no uncaptured collective may follow a graph launch
    that the host has not read back (``PassGraph.run`` reads each back).
    """

    live = weakref.WeakSet()       # every solver of this process

    def __init__(self, A: sp.csr_matrix, group=None,
                 params: AMGParams | None = None,
                 krylov: KrylovParams | None = None,
                 hierarchy: Hierarchy | None = None, nullspace=None, *,
                 device):
        t0 = time.perf_counter()
        ranks = rank_group(group)
        self._begin(ranks, params or (hierarchy.params if hierarchy
                                      else None), krylov, device)
        A = A.tocsr()
        self.n = A.shape[0]
        self.perm = None
        if hierarchy is None:
            A, self.perm = maybe_reorder(A, self.params.reorder)
            if nullspace is not None and self.perm is not None:
                nullspace = np.asarray(nullspace)[self.perm]
        self.hierarchy = hierarchy or amg_setup(A, self.params,
                                                nullspace=nullspace)
        dh = to_dist(self.hierarchy, ranks.rank, ranks.size, self.params,
                     group=group, device=self.torch_device)
        self._finish(dh, fine_fp64(self.hierarchy, dh, self.params,
                                   device=self.torch_device),
                     local_rows=False, t0=t0)

    def _begin(self, ranks: RankGroup, params, krylov, device) -> None:
        self.torch_device = torch.device(device)
        backend = None
        if ranks.size > 1:
            backend = dist.get_backend(ranks.group)
            check_backend(backend, ranks.size, self.torch_device)
        self.ranks = ranks
        self.capture = loop_capture(backend, ranks.size)
        self.params = params or AMGParams()
        self.krylov = krylov or KrylovParams()
        check_krylov(self.krylov)
        torch.backends.cuda.matmul.allow_tf32 = False

    def _finish(self, dh: DistHierarchy, A64, local_rows: bool,
                t0: float) -> None:
        """The state AMGSolver's solve loop reads, for a frozen block."""
        self.dist = self.device = dh
        self.part = dh.parts[0]
        self.local_rows = local_rows
        self.A64 = A64
        self.A32 = self._krylov_op = A64.A_hi     # fp32 Krylov matvec
        self.mv_from_level0 = False
        self.n_pad = self.part.n_loc
        self._cycle = make_cycle(self.params)
        self._dot = partial(pdot, ranks=self.ranks,
                            compensated=self.krylov.compensated_dots)
        self._reset_loop_state()
        DistAMGSolver.live.add(self)
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)
        self.setup_time = time.perf_counter() - t0

    @classmethod
    def from_blocked(cls, make_rows, n: int, group=None,
                     params: AMGParams | None = None,
                     krylov: KrylovParams | None = None, comm=None,
                     make_nullspace=None, *, device) -> "DistAMGSolver":
        """Process-local construction: each rank assembles only its row
        block ``make_rows(r0, r1)`` ((r1-r0, n) CSR, global column ids),
        runs the blocked setup with boundary exchanges over `comm` (a
        GlooComm over every rank by default) and freezes its own block.
        ``SolveResult.x`` is then this rank's rows (``row_range``);
        ``gather_global`` assembles the whole vector.  ``setup_phases``
        keeps the seconds of the blocked setup (span ``setup.blocked``)
        and of the freeze (span ``freeze.dist``), read whether tracing
        is on or off."""
        from ..setup.blocked import blocked_amg_setup, partition_bounds
        from ..setup.comm import GlooComm, ThreadComm, _ThreadGroup
        from .blocked_dist import blocked_to_dist, fine_fp64_blocked
        t0 = time.perf_counter()
        self = cls.__new__(cls)
        ranks = rank_group(group)
        self._begin(ranks, params, krylov, device)
        if comm is None:
            comm = ThreadComm(_ThreadGroup(1), 0) if ranks.size == 1 \
                else GlooComm(None if group is None else dist.new_group(
                    ranks=dist.get_process_group_ranks(group),
                    backend="gloo"))
        assert (comm.rank, comm.size) == (ranks.rank, ranks.size)
        self.comm = comm
        self.n = n
        self.perm = None          # RCM is a global permutation; the
        self.hierarchy = None     # blocked path keeps the natural order
        align = self.params.row_align
        bounds = partition_bounds(n, ranks.size, ranks.size, align=align)
        r0, r1 = int(bounds[ranks.rank]), int(bounds[ranks.rank + 1])
        A_own = make_rows(r0, r1).tocsr()
        assert A_own.shape == (r1 - r0, n)
        ns_own = make_nullspace(r0, r1) if make_nullspace else None
        with trace.timed("setup.blocked", rows=r1 - r0,
                         nnz=int(A_own.nnz)) as t_setup:
            self.blocked = blocked_amg_setup(
                A_own, bounds, comm, self.params,
                bounds_fn=lambda nc: partition_bounds(
                    nc, ranks.size, ranks.size, align=align),
                nullspace_own=ns_own)
        with trace.timed("freeze.dist") as t_freeze:
            dh = blocked_to_dist(self.blocked, comm, self.params,
                                 group=group, device=self.torch_device)
            A64 = fine_fp64_blocked(self.blocked.levels[0].A, r0,
                                    dh.parts[0], comm, self.params, dh.ranks,
                                    device=self.torch_device)
        self.setup_phases = {"blocked": t_setup.seconds,
                             "freeze": t_freeze.seconds}
        self._finish(dh, A64, local_rows=True, t0=t0)
        return self

    @classmethod
    def from_frozen(cls, dh: DistHierarchy, A64, params: AMGParams,
                    krylov: KrylovParams | None = None, *,
                    device) -> "DistAMGSolver":
        """A ready solver around an already frozen rank block (no setup
        work): ``dh`` from ``to_dist``/``blocked_to_dist`` and its fp64
        fine operator."""
        t0 = time.perf_counter()
        self = cls.__new__(cls)
        self._begin(dh.ranks, params, krylov, device)
        self.n = dh.parts[0].n
        self.perm = None
        self.hierarchy = None
        self._finish(dh, A64, local_rows=False, t0=t0)
        return self

    @property
    def row_range(self) -> tuple:
        """The global rows this rank owns."""
        nl = self.part.n_loc
        r = self.ranks.rank
        return min(r * nl, self.n), min((r + 1) * nl, self.n)

    def prepare_rhs(self, b: np.ndarray) -> DeviceRhs:
        """This rank's block of a right-hand side on the device in fp64.
        Takes the full vector, or (process-local) this rank's rows; the
        norm is reduced over the ranks."""
        b = np.asarray(b, dtype=np.float64)
        r0, r1 = self.row_range
        if b.shape[0] == self.n:
            if self.perm is not None:
                b = b[self.perm]
            b = b[r0:r1]
        elif b.shape[0] != r1 - r0 or self.perm is not None:
            raise ValueError(f"rhs of length {b.shape[0]}: want {self.n} "
                             f"or this rank's {r1 - r0} rows")
        bpad = np.zeros(self.part.n_loc)
        bpad[: r1 - r0] = b
        t = torch.from_numpy(bpad).to(self.torch_device)
        return DeviceRhs(t, float(np.sqrt(self._dot(t, t).item())))

    def _fetch(self, x: torch.Tensor):
        """Process-local: this rank's rows.  Otherwise the full solution,
        gathered over the ranks right away (a collective: every rank
        takes part), or downloaded on first access with one rank."""
        r0, r1 = self.row_range
        if self.local_rows:
            return lambda: x[: r1 - r0].cpu().numpy().astype(np.float64)
        if self.ranks.size == 1:
            return super()._fetch(x)
        full = self.ranks.all_gather(x)[: self.n].cpu().numpy()
        return self._unperm(full.astype(np.float64))

    def gather_global(self, res_or_x) -> np.ndarray:
        """The whole solution on every rank (a collective)."""
        x = res_or_x.x if hasattr(res_or_x, "x") else res_or_x
        x = np.asarray(x, dtype=np.float64)
        if not self.local_rows:
            return x
        r0, r1 = self.row_range
        pad = torch.zeros(self.part.n_loc, dtype=torch.float64,
                          device=self.torch_device)
        pad[: r1 - r0] = torch.from_numpy(x[: r1 - r0]).to(pad.device)
        return self.ranks.all_gather(pad)[: self.n].cpu().numpy()
