"""Host-side collective primitives for the blocked (per-host) setup.

The reference's setup phase coarsens under MPI with point-to-point
boundary exchanges (SURVEY.md §3.2 "MPI boundary negotiation in parallel
runs").  The blocked setup in :mod:`setup.blocked` is written SPMD
against this small interface; three implementations exist:

* :class:`ThreadComm` — N ranks as threads of one process with barrier-
  synchronised slot exchange.  The TEST harness: runs the identical SPMD
  code with real concurrency (numpy and the native OpenMP kernels drop
  the GIL) and no process-spawn cost, so bit-identity against the global
  setup is assertable in pytest.
* :class:`GlooComm` — real process boundaries: one process per rank of a
  ``torch.distributed`` process group, host objects exchanged over a gloo
  group of every rank (``all_gather_object``).  Used by the rank
  processes of `parallel.multihost`.
* :class:`PipeComm` — forked processes over pairwise pipes (the cost
  harness, no process group).

The blocked algorithms only ever exchange BOUNDARY data (ghost rows,
halo C/F states, prefix counts), so allgather-based transport is cheap at
the host counts this targets.
"""
from __future__ import annotations

import threading

import numpy as np


class BlockComm:
    """SPMD collective interface: ``rank``, ``size``, and two collectives.

    ``allgather(obj)`` -> list of every rank's object (indexed by rank).
    ``alltoall(parts)`` -> list where out[j] is rank j's ``parts[self.rank]``
    — i.e. parts[d] is addressed to rank d.
    """
    rank: int
    size: int

    def allgather(self, obj):
        raise NotImplementedError

    def alltoall(self, parts: list) -> list:
        assert len(parts) == self.size
        gathered = self.allgather(parts)
        return [gathered[src][self.rank] for src in range(self.size)]

    # -- common reductions (small scalars / arrays) -----------------------
    def allreduce_sum(self, value):
        vals = self.allgather(value)
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    def allreduce_max(self, value):
        return max(self.allgather(value))


class _ThreadGroup:
    def __init__(self, size: int):
        self.size = size
        self.slots = [None] * size
        self.barrier = threading.Barrier(size)


class ThreadComm(BlockComm):
    """N simulated hosts as threads with barrier-synchronised exchange."""

    def __init__(self, group: _ThreadGroup, rank: int):
        self._g = group
        self.rank = rank
        self.size = group.size

    def allgather(self, obj):
        g = self._g
        if g.size == 1:
            return [obj]
        g.slots[self.rank] = obj
        g.barrier.wait()            # all writes visible
        out = list(g.slots)
        g.barrier.wait()            # all reads done before slot reuse
        return out


def run_blocked(fn, n_blocks: int):
    """Run ``fn(rank, comm)`` on ``n_blocks`` simulated hosts (threads);
    returns the per-rank results.  An exception on any rank aborts the
    barrier so the others unblock, and is re-raised."""
    if n_blocks == 1:
        return [fn(0, ThreadComm(_ThreadGroup(1), 0))]
    group = _ThreadGroup(n_blocks)
    results = [None] * n_blocks
    errors = []

    def worker(r):
        try:
            results[r] = fn(r, ThreadComm(group, r))
        except BaseException as e:          # noqa: BLE001 — re-raised below
            errors.append((r, e))
            group.barrier.abort()

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(n_blocks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r, e in errors:
        if not isinstance(e, threading.BrokenBarrierError):
            raise RuntimeError(f"blocked-setup rank {r} failed") from e
    if errors:
        raise RuntimeError("blocked setup aborted") from errors[0][1]
    return results


class GlooComm(BlockComm):
    """Cross-process collectives over ``torch.distributed``.

    Objects are pickled and gathered with ``all_gather_object`` on a gloo
    group of every rank.  The group is created with
    ``new_group(backend="gloo")`` even when the device group is NCCL:
    NCCL moves device tensors only, and the setup exchanges host objects.
    Every rank must construct its GlooComm at the same point (``new_group``
    is a collective call)."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self.group = group if group is not None \
            else dist.new_group(backend="gloo")
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)

    def allgather(self, obj):
        if self.size == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


class PipeComm(BlockComm):
    """Real process boundaries without a process group: N
    forked processes exchanging over pairwise OS pipes.

    The deployment-shaped cost harness (scripts/blocked_setup_bench.py):
    ThreadComm shares one GIL, so every numpy phase of the SPMD setup
    serializes across simulated hosts and the thread simulation
    over-charges the blocked setup by up to the rank count; forked
    processes charge each rank its true single-host cost (like the
    GlooComm production path, minus the distributed-runtime spin-up).

    A background sender thread per collective avoids the classic
    all-send-first pipe deadlock (Connection.send blocks once the pipe
    buffer fills; payloads here include the gathered coarse tail).
    """

    def __init__(self, rank: int, size: int, conns: dict):
        self.rank = rank
        self.size = size
        self._conns = conns                 # peer rank -> Connection

    def _exchange(self, mine, payload_of):
        """Common send-thread/recv-loop body.  If a recv raises (EOFError
        from a dead peer) the connections are closed before re-raising so
        the background sender unblocks with BrokenPipeError instead of
        staying parked in Connection.send forever, and the thread is
        joined (ADVICE r4: no abandoned sender threads)."""
        peers = [p for p in range(self.size) if p != self.rank]

        def send_all():
            try:
                for p in peers:
                    self._conns[p].send(payload_of(p))
            except (BrokenPipeError, OSError):
                pass                        # peer died; recv side raises

        t = threading.Thread(target=send_all)
        t.start()
        out = [None] * self.size
        out[self.rank] = mine
        try:
            for p in peers:
                out[p] = self._conns[p].recv()
        except BaseException:
            for p in peers:
                self._conns[p].close()
            t.join()
            raise
        t.join()
        return out

    def allgather(self, obj):
        if self.size == 1:
            return [obj]
        return self._exchange(obj, lambda p: obj)

    def alltoall(self, parts: list) -> list:
        # point-to-point: rank d receives only parts[d] (the allgather
        # fallback would ship every rank's full send list to everyone)
        assert len(parts) == self.size
        if self.size == 1:
            return [parts[0]]
        return self._exchange(parts[self.rank], lambda p: parts[p])


def run_blocked_procs(fn, n_blocks: int, omp_threads: int | None = None):
    """Run ``fn(rank, comm)`` on ``n_blocks`` forked processes with
    pairwise pipes; returns the per-rank results (pickled back through a
    result pipe).  ``omp_threads`` caps each rank's OpenMP parallelism
    (deployment: each host owns its cores; simulation: cores/n_blocks)."""
    import multiprocessing as mp
    ctx = mp.get_context("fork")
    if n_blocks == 1:
        return [fn(0, PipeComm(0, 1, {}))]
    from .._native import get_lib
    _lib = get_lib()
    if _lib is not None:
        _lib.omp_fork_prepare()    # release the libgomp team: forking a
        # process whose OpenMP pool has run deadlocks children's first
        # parallel region; the team respawns lazily after fork
    pipes = {}
    for a in range(n_blocks):
        for b in range(a + 1, n_blocks):
            pipes[(a, b)] = ctx.Pipe()
    res_pipes = [ctx.Pipe(duplex=False) for _ in range(n_blocks)]

    def worker(rank):
        conns = {}
        for (a, b), (ca, cb) in pipes.items():
            # keep only this rank's ends; CLOSE every inherited copy of
            # the others — a third rank holding an open copy would
            # otherwise keep a dead peer's connection from ever EOFing
            if a == rank:
                conns[b] = ca
                cb.close()
            elif b == rank:
                conns[a] = cb
                ca.close()
            else:
                ca.close()
                cb.close()
        for rr, (rd, wr) in enumerate(res_pipes):
            rd.close()
            if rr != rank:
                wr.close()
        if omp_threads is not None:
            from .._native import get_lib
            lib = get_lib()
            if lib is not None:
                lib.set_omp_threads(int(omp_threads))
            try:
                # OpenBLAS (scipy LAPACK: the tail's dense coarse
                # inverse) spawns a SPIN-WAITING pthread pool per child;
                # n_blocks children x 4 spinning threads on 4 cores made
                # identical tail freezes vary 10-140 s.  The pool is
                # inherited pre-sized through fork, so the env vars are
                # too late — resize it through threadpoolctl.
                import threadpoolctl
                threadpoolctl.threadpool_limits(int(omp_threads))
            except Exception:
                pass
        try:
            out = fn(rank, PipeComm(rank, n_blocks, conns))
        except BaseException as e:          # noqa: BLE001 — re-raised in
            import traceback                # the parent below
            res_pipes[rank][1].send(
                ("__blocked_rank_error__", rank,
                 "".join(traceback.format_exception(e))))
            raise
        res_pipes[rank][1].send(out)

    procs = [ctx.Process(target=worker, args=(r,), daemon=True)
             for r in range(n_blocks)]
    for p in procs:
        p.start()
    # close the parent's copies of the pairwise pipes and of the result
    # write ends: recv() below then sees EOF if a child dies before
    # sending (instead of blocking forever — a rank failure must raise,
    # like run_blocked's barrier abort)
    for ca, cb in pipes.values():
        ca.close()
        cb.close()
    for _, w in res_pipes:
        w.close()
    results = [None] * n_blocks
    errors = []
    for r in range(n_blocks):
        try:
            out = res_pipes[r][0].recv()
        except EOFError:
            errors.append((r, "process died before sending a result"))
            continue
        if (isinstance(out, tuple) and len(out) == 3
                and out[0] == "__blocked_rank_error__"):
            errors.append((out[1], out[2]))
        else:
            results[r] = out
    for p in procs:
        p.join()
    if errors:
        r, detail = errors[0]
        raise RuntimeError(
            f"blocked-setup rank {r} failed:\n{detail}")
    return results
