"""The Krylov loop as CUDA graphs: the counterpart of the JAX package's
jitted device-mode pass (``solve/solver.py``: ``_inner_solve_dev``'s
``lax.while_loop``, with the fused ``refine_start``/``refine_finish``).

A ``ChunkGraph`` runs ``fn`` on a tuple of static buffers and copies its
outputs back into them.  On the card it captures that once as one
``torch.cuda.CUDAGraph`` and each ``run()`` replays it; on the CPU (the
caller's choice, never a fallback) it runs ``fn`` eagerly.  Because the
captured region ends by writing its outputs into buffers allocated
before capture, replays chain, and no tensor made inside a graph
outlives it: every graph of a solver can share one memory pool whatever
order they replay in.

A ``PassGraph`` is one refinement pass: start
graphs, then the step graph while the loop condition holds, then finish
graphs.  On the card it is one graph launch: ``csrc/graph_loop.cu``
assembles the captured graphs as child graphs around a conditional WHILE
node whose body is the step and the guard kernel (``loop_guard``), so the
host reads the device once per pass.  Eagerly it is the same pass with
the loop in Python.  A failure to build or launch it raises: nothing
falls back to another loop.

The kernel wrappers count their launches in ``launches`` as the Python
code issues them, and the tallies (``trace.Tally``: the distributed
solver's collectives) their own counts; during capture nothing launches,
so a capture takes back what they counted and every replay adds it again
(a pass graph adds its step graph's count once per iteration it ran).
"""
from __future__ import annotations

import ctypes
import gc

import torch

from ..ops import kernel_wrappers
from ..utils import trace
from .krylov import READS, loop_active, loop_record


class ChunkGraph:
    """fn(bufs) -> outputs, written back into bufs: captured once on the
    card (``capture=True``), run eagerly otherwise.

    ``capture_s`` and ``instantiate_s`` time the capture (the Python code
    issuing fn's launches into the graph) and the graph's instantiation,
    which ``instantiate()`` or the first replay does (a graph that only a
    pass graph holds as a child is never instantiated alone);
    ``per_replay`` maps each kernel wrapper and tally to its launches
    per replay."""

    def __init__(self, fn, bufs: tuple, capture: bool, pool=None):
        self.fn, self.bufs = fn, bufs
        self.graph = None
        self._instantiated = False
        self.per_replay = {}
        self.capture_s = self.instantiate_s = 0.0
        if capture:
            self._capture(pool)

    def _body(self) -> None:
        outs = self.fn(self.bufs)
        for buf, out in zip(self.bufs, outs, strict=True):
            if out is not buf:          # fn may write a buffer in place
                buf.copy_(out)

    def _capture(self, pool) -> None:
        wrappers = (*kernel_wrappers(), *trace.tallies())
        before = [w.launches for w in wrappers]
        # keep_graph: the cudaGraph_t stays readable (raw_cuda_graph) for
        # the pass graphs that take this graph as a child
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # the collector stays off while the stream captures: a solver
        # dropped without release_graphs() leaves its loop and graphs as
        # cyclic garbage, and a collection that destroyed them mid-capture
        # would invalidate the capture (CUDA refuses it then)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with trace.timed("graphs.capture") as t:
                with torch.cuda.graph(graph, pool=pool):
                    self._body()
        finally:
            if collecting:
                gc.enable()
        self.capture_s = t.seconds
        for w, n in zip(wrappers, before):
            if w.launches != n:
                self.per_replay[w] = w.launches - n
            w.launches = n
        self.graph = graph

    def raw(self) -> int:
        """The captured cudaGraph_t."""
        return self.graph.raw_cuda_graph()

    def node_kinds(self) -> dict:
        """{node type: count} of the captured graph, child graphs
        entered (cudaGraphNodeType's names)."""
        from .. import _build
        names = ("kernel", "memcpy", "memset", "host", "graph", "empty",
                 "wait_event", "event_record", "ext_semaphore_signal",
                 "ext_semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op",
                 "conditional")
        counts = (ctypes.c_int * len(names))()
        _build.check(_build.lib().graph_node_counts(
            self.raw(), ctypes.addressof(counts), len(names)), "node kinds")
        return {k: n for k, n in zip(names, counts) if n}

    def count(self, times: int = 1) -> None:
        """Add `times` replays' launches to the wrappers' counts."""
        for w, n in self.per_replay.items():
            w.launches += n * times

    def instantiate(self) -> None:
        """Instantiate the captured graph for replay (once)."""
        if self.graph is not None and not self._instantiated:
            with trace.timed("graphs.instantiate") as t:
                self.graph.instantiate()
            self.instantiate_s = t.seconds
            self._instantiated = True

    def run(self) -> None:
        if self.graph is None:
            if self.fn is None:
                raise RuntimeError("this graph was released")
            self._body()
            return
        self.instantiate()
        self.graph.replay()
        self.count()

    def release(self) -> None:
        """Destroy the captured graph and its instantiation now (not when
        the object is collected); the graph runs no more."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
        self.fn = None


def _check_guard(rr, k, brk, target, budget, prog) -> None:
    want = ((rr, torch.float32), (k, torch.int32), (target, torch.float64),
            (budget, torch.float64))
    for t, dt in want + (((brk, torch.bool),) if brk is not None else ()):
        if t.dim() != 0 or t.dtype != dt:
            raise ValueError(f"loop guard: want a 0-d {dt} tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if prog.dtype != torch.float64 or prog.dim() != 1 or prog.numel() < 3 \
            or not prog.is_contiguous():
        raise ValueError(f"loop guard: prog must be a contiguous fp64 vector "
                         f"of at least 3, got {tuple(prog.shape)} "
                         f"{prog.dtype}")
    devices = {t.device for t in (rr, k, target, budget, prog)}
    if brk is not None:
        devices.add(brk.device)
    if len(devices) != 1:
        raise ValueError(f"loop guard: tensors on different devices: "
                         f"{devices}")


def _guard_args(method: str, state, guard, prog):
    i_rr, i_k, i_brk = READS[method]
    brk = None if i_brk is None else state[i_brk]
    args = (state[i_rr], state[i_k], brk, *guard, prog)
    _check_guard(*args)
    return args


def loop_guard(method: str, state, guard, prog: torch.Tensor) -> torch.Tensor:
    """The loop condition of a pass with its record: writes (||r||^2, k,
    breakdown) in fp64 into prog[:3] and returns whether the loop steps
    again, as a 0-d tensor on the state's device (nonzero: step).  On the
    card one launch of ``csrc/graph_loop.cu``'s guard kernel (the pass
    graph holds the same kernel as nodes); on the CPU its plain version,
    ``krylov.loop_active`` and ``krylov.loop_record``.  guard = (target,
    budget), 0-d fp64 tensors."""
    args = _guard_args(method, state, guard, prog)
    dev = prog.device
    if dev.type == "cpu":
        prog[:3] = loop_record(method, state)
        return loop_active(method, state, guard)
    if dev.type != "cuda":
        raise ValueError(f"no loop guard kernel for device {dev}")
    from .. import _build
    go = torch.empty((), dtype=torch.int32, device=dev)
    ptrs = [None if t is None else t.data_ptr() for t in args]
    rc = _build.lib().loop_guard_launch(
        *ptrs, go.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "loop_guard")
    loop_guard.launches += 1
    return go


loop_guard.launches = 0


class PassGraph:
    """One refinement pass: the ``heads`` graphs, then ``step`` while the
    loop condition of ``method`` holds on ``state`` and ``guard``, then
    the ``tails`` graphs; ``run()`` returns ``prog`` as the host reads it
    after the pass (prog[1] is k, the iterations the pass ran) and the
    number of host reads the pass made; ``device_ms`` is the device time
    of the last launch (captured passes).  ``run()`` reads prog back
    before it returns, so every launch of the loop has finished when the
    caller goes on: on NCCL ranks, whose communicator is created with
    ``NCCL_GRAPH_MIXING_SUPPORT=0`` (``multihost.init_process_group``),
    an uncaptured collective (the rhs norm, the gathered x) may follow
    only a graph launch that the host has read back.

    With ``capture`` (every graph captured) the pass is one launch of a
    graph built by ``csrc/graph_loop.cu`` (``build_s`` times its assembly,
    instantiation and upload); otherwise the same graphs run eagerly and
    the loop asks ``loop_guard`` before every step."""

    def __init__(self, heads: list, step: ChunkGraph, tails: list,
                 method: str, state: tuple, guard: tuple,
                 prog: torch.Tensor, capture: bool):
        self.heads, self.step, self.tails = list(heads), step, list(tails)
        self.method, self.state, self.guard = method, state, guard
        self.prog = prog
        self.exec = None
        self.build_s = 0.0
        self.device_ms = None      # the last launch's, from CUDA events
        self._lib = None
        if capture:
            self._build()

    def _build(self) -> None:
        from .. import _build
        graphs = [*self.heads, self.step, *self.tails]
        if any(g.graph is None for g in graphs):
            raise RuntimeError("a pass graph needs every part captured")
        lib = _build.lib()
        heads = (ctypes.c_void_p * len(self.heads))(
            *[g.raw() for g in self.heads])
        tails = (ctypes.c_void_p * len(self.tails))(
            *[g.raw() for g in self.tails])
        ptrs = [None if t is None else t.data_ptr() for t in _guard_args(
            self.method, self.state, self.guard, self.prog)]
        out = ctypes.c_void_p()
        msg = ctypes.create_string_buffer(512)
        with trace.timed("graphs.pass_build") as t:
            rc = lib.pass_graph_create(
                ctypes.addressof(heads), len(self.heads), self.step.raw(),
                ctypes.addressof(tails), len(self.tails), *ptrs,
                ctypes.addressof(out), ctypes.addressof(msg), len(msg),
                torch.cuda.current_stream(self.prog.device).cuda_stream)
            if rc == 0:
                torch.cuda.synchronize(self.prog.device)
        if rc != 0:
            kinds = {"start": [g.node_kinds() for g in self.heads],
                     "step": self.step.node_kinds(),
                     "finish": [g.node_kinds() for g in self.tails]}
            hint = ""
            if "wait_event" in str(kinds):
                hint = ("; NCCL's support for mixing captured and "
                        "uncaptured collectives adds event nodes: set "
                        "NCCL_GRAPH_MIXING_SUPPORT=0 before the "
                        "communicator is created (multihost."
                        "init_process_group does)")
            raise RuntimeError(f"pass graph (a CUDA graph WHILE node) not "
                               f"built: {msg.value.decode()}; the captured "
                               f"parts' nodes: {kinds}{hint}")
        self.build_s = t.seconds
        self.exec, self._lib = out.value, lib

    def launch(self) -> None:
        """Enqueue the pass graph on the current stream (no read, no
        count); a captured pass only."""
        from .. import _build
        rc = self._lib.pass_graph_launch(
            self.exec, torch.cuda.current_stream(self.prog.device).cuda_stream)
        _build.check(rc, "pass graph")

    def run(self) -> tuple:
        if self.exec is None:
            for g in self.heads:
                g.run()
            reads = 1
            while loop_guard(self.method, self.state, self.guard, self.prog):
                self.step.run()
                reads += 1
            for g in self.tails:
                g.run()
            return self.prog.tolist(), reads + 1
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with trace.span("solve.launch"):
            ev[0].record()
            self.launch()
            ev[1].record()
        with trace.span("solve.read"):
            prog = self.prog.tolist()
        self.device_ms = ev[0].elapsed_time(ev[1])
        trace.note_events("pass_graph", *ev)
        iters = int(prog[1])
        for g in (*self.heads, *self.tails):
            g.count()
        self.step.count(iters)
        loop_guard.launches += iters + 1
        return prog, 1

    def release(self) -> None:
        """Destroy the assembled graph's instantiation now."""
        if self.exec is not None and self._lib is not None:
            self._lib.pass_graph_destroy(self.exec)
        self.exec = None

    __del__ = release
