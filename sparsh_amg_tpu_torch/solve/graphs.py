"""Chunks of the Krylov loop captured as CUDA graphs: the counterpart of the
JAX package's jitted chunk programs (``solve/solver.py``: ``_kr_chunk``,
a trace-time unroll of k iterations compiled once per k).

A ``ChunkGraph`` runs ``fn`` on a tuple of static buffers and copies its
outputs back into them.  On the card it captures that once as one
``torch.cuda.CUDAGraph`` and each ``run()`` replays it; on the CPU (the
caller's choice, never a fallback) it runs ``fn`` eagerly.  Because the
captured region ends by writing its outputs into buffers allocated
before capture, replays chain, and no tensor made inside a graph
outlives it: every graph of a solver can share one memory pool whatever
order they replay in.

The kernel wrappers count their launches in ``launches`` as the Python
code issues them; during capture nothing launches, so a capture takes
back what the wrappers counted and every replay adds it again.
"""
from __future__ import annotations

import time

import torch

from ..ops import kernel_wrappers


class ChunkGraph:
    """fn(bufs) -> outputs, written back into bufs: captured once on the
    card (``capture=True``), run eagerly otherwise.

    ``capture_s`` and ``instantiate_s`` time the capture (the Python code
    issuing fn's launches into the graph) and the graph's instantiation;
    ``per_replay`` maps each kernel wrapper to its launches per replay."""

    def __init__(self, fn, bufs: tuple, capture: bool, pool=None):
        self.fn, self.bufs = fn, bufs
        self.graph = None
        self.per_replay = {}
        self.capture_s = self.instantiate_s = 0.0
        if capture:
            self._capture(pool)

    def _body(self) -> None:
        outs = self.fn(self.bufs)
        for buf, out in zip(self.bufs, outs, strict=True):
            buf.copy_(out)

    def _capture(self, pool) -> None:
        wrappers = kernel_wrappers()
        before = [w.launches for w in wrappers]
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        ctx = torch.cuda.graph(graph, pool=pool)
        with ctx:
            self._body()
            t1 = time.perf_counter()
        self.instantiate_s = time.perf_counter() - t1
        self.capture_s = t1 - t0
        for w, n in zip(wrappers, before):
            if w.launches != n:
                self.per_replay[w] = w.launches - n
            w.launches = n
        self.graph = graph

    def run(self) -> None:
        if self.graph is None:
            self._body()
            return
        self.graph.replay()
        for w, n in self.per_replay.items():
            w.launches += n
