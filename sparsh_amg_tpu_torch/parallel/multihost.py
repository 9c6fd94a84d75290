"""Rank processes (the port of ``sparsh_amg_tpu/parallel/multihost.py``).

The reference launches one MPI rank per GPU.  The port does the same with
``torch.distributed``: one process per rank, each holding its row block
on its own device (rank r on card ``r % device_count``; on the CPU for
tests).  The JAX package's ``devices_per_process`` folds into ranks: one
rank per device is the PyTorch idiom, and several ranks may share a card
through the gloo backend.

* ``init_process_group`` joins the group from ``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (``tcp://`` rendezvous) and
  returns this rank's device; ``destroy_process_group`` (also run at
  exit) releases the CUDA graphs of this process's distributed solvers
  before it destroys the group.
* ``start_ranks`` starts N rank processes of a command with those
  variables set and returns a ``Ranks`` handle to talk to them while
  they run (JSON lines in and out), which stops them all when one fails;
  ``spawn_ranks`` starts them and waits for all of them to exit;
  ``launch_processes`` runs the distributed solve below in them
  and collects each rank's JSON result, as the JAX package's launcher
  does (``python -m sparsh_amg_tpu_torch.parallel.multihost --worker``).
"""
from __future__ import annotations

import atexit
import copy
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_backend(device) -> str:
    """nccl on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_env() -> tuple | None:
    """(rank, world size) when this process was started as a rank."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return None


def init_process_group(backend: str | None = None, device=None,
                       rank: int | None = None,
                       world_size: int | None = None) -> torch.device:
    """Join the default process group and return this rank's device.

    Rank and size come from the arguments or from ``RANK`` and
    ``WORLD_SIZE``; the rendezvous is ``tcp://MASTER_ADDR:MASTER_PORT``
    (a free local port when a single rank starts without one).  `device`
    is "cuda" (card ``rank % device_count``) or "cpu"; `backend` defaults
    to nccl on the card and gloo on the CPU.  NCCL with more ranks than
    cards raises (see ``solver.check_backend``)."""
    import torch.distributed as dist
    from .solver import check_backend
    env = rank_env()
    if rank is None:
        rank = env[0] if env else 0
    if world_size is None:
        world_size = env[1] if env else 1
    device = torch.device(device or os.environ.get("SPARSH_DIST_DEVICE")
                          or "cuda")
    backend = backend or os.environ.get("SPARSH_DIST_BACKEND") \
        or default_backend(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda, but torch sees no CUDA device")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    check_backend(backend, world_size, device)
    if backend == "nccl":
        # NCCL's support for mixing captured and uncaptured collectives
        # puts an event wait node at the head of every captured collective
        # and event record nodes after it; a CUDA graph's WHILE body holds
        # neither, so the pass graph would not instantiate.  Without it, a
        # captured and an uncaptured collective on one communicator must
        # not be in flight together, in either order.  An uncaptured
        # collective before a launch: the launch's stream waits for it.
        # A launch before an uncaptured collective: the stream does not
        # help; the host reads every pass graph launch back before it goes
        # on (``PassGraph.run``).  Read when the communicator is created,
        # after this.
        os.environ.setdefault("NCCL_GRAPH_MIXING_SUPPORT", "0")
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT") or str(free_port())
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world_size)
    atexit.unregister(destroy_process_group)     # once a process
    atexit.register(destroy_process_group)
    return device


def destroy_process_group() -> None:
    """Release the CUDA graphs of every distributed solver of this
    process (``DistAMGSolver.live``), then destroy the default process
    group (if it still exists).  A graph that captured NCCL collectives
    holds the communicator until the graph is destroyed, and the group's
    teardown waits for it: a rank whose solver still held its graphs when
    the group was destroyed never exited.  ``init_process_group`` also
    runs this at exit, so a rank that raises exits with its error."""
    import torch.distributed as dist
    from .solver import DistAMGSolver
    for s in list(DistAMGSolver.live):
        s.release_graphs()
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """Rank processes that ``start_ranks`` started, talked to while they
    run: ``send`` writes a JSON line to every rank's standard input,
    ``expect`` reads the JSON line each rank prints with a given
    ``"phase"``, ``wait`` waits for all of them to exit, ``stop`` kills
    every rank still running (also run at this process's exit).  Each
    rank's standard output and error go to files, read from the start
    by ``outputs``.  When a rank fails or the time runs out, every rank is
    stopped and RuntimeError carries the failing rank's output."""

    def __init__(self, procs: list, logs: list, tmp: str):
        self.procs, self._logs, self._tmp = procs, logs, tmp
        self._read = [0] * len(procs)      # bytes of stdout parsed
        self._lines = [[] for _ in procs]   # JSON lines not yet expected
        atexit.register(self.stop)

    def __len__(self) -> int:
        return len(self.procs)

    def outputs(self) -> list:
        """(stdout, stderr) of each rank so far."""
        out = []
        for paths in self._logs:
            texts = []
            for path in paths:
                with open(path, errors="replace") as f:
                    texts.append(f.read())
            out.append(tuple(texts))
        return out

    def failed(self) -> int | None:
        """The first rank that exited non-zero, or None."""
        return next((r for r, p in enumerate(self.procs)
                     if p.poll() not in (None, 0)), None)

    def fail(self, rank: int, why: str) -> RuntimeError:
        """Stop every rank; the error naming `rank` with its output."""
        self.stop()
        o, e = self.outputs()[rank]
        return RuntimeError(f"rank {rank} of {len(self)} failed ({why}):\n"
                            f"{o[-3000:]}\n{e[-6000:]}")

    def _check(self, deadline: float, timeout: float) -> None:
        bad = self.failed()
        if bad is not None:
            raise self.fail(bad, f"rc={self.procs[bad].returncode}")
        if time.monotonic() > deadline:
            late = next((r for r, p in enumerate(self.procs)
                         if p.poll() is None), 0)
            raise self.fail(late, f"timed out after {timeout:.0f} s")

    def send(self, obj) -> None:
        """One JSON line to every rank's standard input."""
        line = (json.dumps(obj) + "\n").encode()
        for r, p in enumerate(self.procs):
            try:
                p.stdin.write(line)
                p.stdin.flush()
            except (BrokenPipeError, OSError, AttributeError) as e:
                raise self.fail(r, f"its input is closed: {e!r}") from e

    def _take(self, r: int) -> None:
        with open(self._logs[r][0], "rb") as f:
            f.seek(self._read[r])
            chunk = f.read()
        end = chunk.rfind(b"\n") + 1          # whole lines only
        self._read[r] += end
        for line in chunk[:end].decode(errors="replace").splitlines():
            if line.startswith("{"):
                try:
                    self._lines[r].append(json.loads(line))
                except ValueError:
                    pass

    def expect(self, phase: str, timeout: float) -> list:
        """Each rank's next JSON line whose ``"phase"`` is `phase`, in
        rank order, waiting at most `timeout` s for all of them."""
        deadline = time.monotonic() + timeout
        got = [None] * len(self)
        while True:
            for r in range(len(self)):
                if got[r] is None:
                    self._take(r)
                    for k, line in enumerate(self._lines[r]):
                        if line.get("phase") == phase:
                            got[r] = line
                            del self._lines[r][:k + 1]
                            break
            if all(g is not None for g in got):
                return got
            self._check(deadline, timeout)
            time.sleep(0.01)

    def wait(self, timeout: float) -> list:
        """Each rank's standard output once every rank has exited 0."""
        deadline = time.monotonic() + timeout
        while not all(p.poll() == 0 for p in self.procs):
            self._check(deadline, timeout)
            time.sleep(0.02)
        return [o for o, _ in self.outputs()]

    def stop(self) -> None:
        """Kill every rank still running and wait for each to exit."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            if p.stdin is not None:
                try:
                    p.stdin.close()
                except OSError:
                    pass

    def close(self) -> None:
        """stop(), then delete the output files."""
        self.stop()
        atexit.unregister(self.stop)
        shutil.rmtree(self._tmp, ignore_errors=True)


def start_ranks(num: int, argv: list, *, backend: str, device="cuda",
                threads: int | None = None, env: dict | None = None,
                stdin: bool = False) -> Ranks:
    """Start ``python argv...`` as ranks 0..num-1 of one process group
    and return at once.  Every rank gets MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE, SPARSH_DIST_BACKEND and SPARSH_DIST_DEVICE; `threads`
    caps each rank's torch and OpenMP threads (default: this machine's
    cores shared out).  With `stdin` each rank reads what ``send``
    writes; otherwise it inherits this process's input."""
    from .solver import check_backend
    check_backend(backend, num, torch.device(device))
    base = dict(os.environ, **(env or {}))
    base.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(num), SPARSH_DIST_BACKEND=backend,
                SPARSH_DIST_DEVICE=str(torch.device(device).type),
                PYTHONPATH=REPO + os.pathsep + base.get("PYTHONPATH", ""))
    # the ranks share this machine's cores
    threads = threads or max(1, (os.cpu_count() or 1) // num)
    base.update(OMP_NUM_THREADS=str(threads),
                SPARSH_RANK_THREADS=str(threads))
    tmp = tempfile.mkdtemp(prefix="sparsh_ranks_")
    logs, procs = [], []
    try:
        for r in range(num):
            paths = tuple(os.path.join(tmp, f"{r}.{k}") for k in "oe")
            logs.append(paths)
            with open(paths[0], "wb") as out, open(paths[1], "wb") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, *argv], cwd=REPO, stdout=out,
                    stderr=err, stdin=subprocess.PIPE if stdin else None,
                    env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
    except BaseException:
        Ranks(procs, logs[:len(procs)], tmp).close()
        raise
    return Ranks(procs, logs, tmp)


def spawn_ranks(num: int, argv: list, *, backend: str, device="cuda",
                timeout: float = 900.0, threads: int | None = None,
                env: dict | None = None) -> list:
    """Run ``python argv...`` as ranks 0..num-1 of one process group
    (``start_ranks``) and return each rank's standard output once all
    have exited.  When a rank fails or the time runs out, every rank is
    stopped and RuntimeError carries the failing rank's output."""
    ranks = start_ranks(num, argv, backend=backend, device=device,
                        threads=threads, env=env)
    try:
        return ranks.wait(timeout)
    finally:
        ranks.close()


def launch_or_join(n: int, cmd: list, backend: str | None, device,
                   timeout: float = 1800.0) -> tuple:
    """An entry point's ``--dist n``.  In the launching process (n > 1 and
    no RANK in the environment) start n ranks of ``python cmd...`` and
    return (rank 0's standard output, None, True).  In a rank, or for
    n == 1 in this process, join the group and return (None, this rank's
    device, whether it is rank 0)."""
    backend = backend or default_backend(device)
    env = rank_env()
    if env is None and n > 1:
        outs = spawn_ranks(n, cmd, backend=backend, device=device,
                           timeout=timeout)
        return outs[0], None, True
    if env is not None and env[1] != n:
        raise ValueError(f"--dist {n} in a group of {env[1]} ranks")
    device = init_process_group(backend, device, world_size=n)
    return None, device, env is None or env[0] == 0


def last_json(text: str) -> dict:
    """The last line of `text` that is a JSON object."""
    lines = [l for l in text.splitlines() if l.startswith("{")]
    if not lines:
        raise ValueError(f"no JSON line in:\n{text[-2000:]}")
    return json.loads(lines[-1])


def pin_threads() -> None:
    """Cap this rank's torch and OpenMP threads at SPARSH_RANK_THREADS."""
    n = os.environ.get("SPARSH_RANK_THREADS")
    if n:
        torch.set_num_threads(int(n))
        from .._native import get_lib
        lib = get_lib()
        if lib is not None:
            lib.set_omp_threads(int(n))


def launch_processes(num_processes: int, problem: str = "poisson3d",
                     m: int = 24, setup: str = "blocked", device="cuda",
                     backend: str | None = None, krylov_method: str = "cg",
                     row_align: int | None = None, timeout: float = 900.0,
                     threads: int | None = None,
                     compare_eager: bool = False) -> list:
    """Run the distributed solve of ``_worker_main`` on `num_processes`
    ranks and return their result dicts (the JAX launcher's keys, plus
    the rank's backend, device, times, kernel launches, collectives
    (``dist.COLLECTIVES``) and what its loop did: whether it captured,
    host reads, the captured step's node kinds, the pass graphs' device
    ms and their share of the solve's wall).

    ``setup="blocked"`` is the process-local path: each rank assembles
    only its row block, coarsens through the blocked setup and returns
    its own rows.  ``setup="global"`` builds the global matrix and
    hierarchy in every rank.  The solver is warmed (``AMGSolver.warm``)
    before the timed solve.  With `compare_eager`
    each rank also solves on a copy that runs the loop eagerly, from the
    same state, and reports its counts, collectives, time and whether
    its x has the same bits (``"eager"``, ``"same_bits"``)."""
    backend = backend or default_backend(device)
    cmd = ["-m", "sparsh_amg_tpu_torch.parallel.multihost", "--worker",
           "--m", str(m), "--setup", setup, "--problem", problem,
           "--krylov", krylov_method]
    if row_align is not None:
        cmd += ["--row-align", str(row_align)]
    if compare_eager:
        cmd.append("--compare-eager")
    outs = spawn_ranks(num_processes, cmd, backend=backend, device=device,
                       timeout=timeout, threads=threads)
    return [last_json(o) for o in outs]


def _flagship_params():
    from ..params import AMGParams
    return AMGParams(smoother="chebyshev", coarsening="pmis",
                     interpolation="extpi", interp_max=4,
                     rap_drop_tol=0.01, agg_levels=1,
                     interp_max_composed=5, intermediate_drop_tol=0.02,
                     aggressive="pmis2", band_dtype="bfloat16",
                     dense_size=2048, cheby_degree_coarse=1,
                     cheby_coarse_from=1)


def _elasticity_sa_params(row_align: int = 6144):
    """The RBM-SA elasticity recipe (CONFIGS elasticity3d row), with the
    node/nullspace row alignment the blocked setup requires: row blocks
    must not split a node's 3 dofs or an aggregate's 6 coarse dofs
    (lcm(2048, 3, 6) = 6144)."""
    from ..params import AMGParams
    return AMGParams(coarsening="aggregation", interpolation="smoothed",
                     smoother="chebyshev", coarse_size=200,
                     agg_blocksize=3, p_smooth_filter=False,
                     row_align=row_align)


def _problem_spec(problem: str, m: int, row_align: int | None = None):
    """(n_glob, make_rows, make_nullspace, params) for a worker."""
    if problem == "poisson3d":
        from ..models.poisson import poisson3d_rows
        return (m ** 3,
                lambda r0, r1: poisson3d_rows(m, r0, r1),
                None, _flagship_params())
    if problem == "elasticity3d":
        from ..models.elasticity import (elasticity3d_nullspace_rows,
                                         elasticity3d_rows)
        n_glob = 3 * (m + 1) ** 2 * m       # x == 0 face clamped
        params = _elasticity_sa_params(row_align or 6144)
        return (n_glob,
                lambda r0, r1: elasticity3d_rows(m, r0, r1),
                lambda r0, r1: elasticity3d_nullspace_rows(m, r0, r1),
                params)
    raise ValueError(f"unknown problem {problem!r}")


def _worker_main(argv=None) -> None:
    import argparse
    import resource
    import torch.distributed as dist
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--m", type=int, default=24)
    ap.add_argument("--setup", choices=("blocked", "global"),
                    default="blocked")
    ap.add_argument("--problem", choices=("poisson3d", "elasticity3d"),
                    default="poisson3d")
    ap.add_argument("--row-align", type=int, default=None)
    ap.add_argument("--krylov", default="cg")
    ap.add_argument("--compare-eager", action="store_true")
    args = ap.parse_args(argv)

    pin_threads()
    device = init_process_group()
    from ..ops import counted
    from ..params import KrylovParams
    from .dist import COLLECTIVES
    from .solver import DistAMGSolver

    n_glob, make_rows, make_ns, params = _problem_spec(
        args.problem, args.m, args.row_align)
    krylov = KrylovParams(method=args.krylov, tol=1e-8,
                          maxiter=60 if args.problem == "poisson3d"
                          else 200)
    b = np.random.default_rng(0).standard_normal(n_glob)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)

    def ready(solver):
        """Warm the solver; its eager twin (from the same state) or None."""
        t = time.perf_counter()
        solver.warm()
        sync()
        eager = None
        if args.compare_eager:
            eager = copy.copy(solver)
            eager.capture = False
            # its loop is built now, as warm() built the captured one: a
            # loop's construction issues collectives of its own (the
            # initial Krylov state), which neither solve below counts
            eager._loop()
        return eager, time.perf_counter() - t

    if args.setup == "blocked":
        solver = DistAMGSolver.from_blocked(
            make_rows, n_glob, params=params, krylov=krylov,
            make_nullspace=make_ns, device=device)
        r0, r1 = solver.row_range
        b_loc = np.ascontiguousarray(b[r0:r1])
        del b                       # steady state holds only the block
        eager, warm_s = ready(solver)
        rhs = solver.prepare_rhs(b_loc)
        sync()
        c0 = COLLECTIVES.launches
        res, launches = counted(lambda: solver.solve(rhs))
        collectives = COLLECTIVES.launches - c0
        x_loc = np.asarray(res.x, dtype=np.float64)
        # the true residual on the owned rows against the gathered
        # solution (the one O(n) array, for this check only)
        x_glob = solver.gather_global(res)
        A_own = solver.blocked.levels[0].A
        r_own = A_own @ x_glob - b_loc
        rn = float(solver.comm.allreduce_sum(float(np.dot(r_own, r_own))))
        bn = float(solver.comm.allreduce_sum(float(np.dot(b_loc, b_loc))))
        true_relres = float(np.sqrt(rn / bn))
        local_rows, local_nnz = int(A_own.shape[0]), int(A_own.nnz)
        blk_nnz = int(sum(l.A.nnz for l in solver.blocked.levels))
        tail_nnz = int(sum(l.nnz for l in solver.blocked.tail.levels))
        holds_global_fine = False
    else:
        if args.problem == "elasticity3d":
            from ..models.elasticity import (elasticity3d,
                                             elasticity3d_nullspace)
            A, ns = elasticity3d(args.m), elasticity3d_nullspace(args.m)
        else:
            from ..models.poisson import poisson3d
            A, ns = poisson3d(args.m), None
        solver = DistAMGSolver(A, params=params, krylov=krylov,
                               nullspace=ns, device=device)
        eager, warm_s = ready(solver)
        rhs = solver.prepare_rhs(b)
        sync()
        c0 = COLLECTIVES.launches
        res, launches = counted(lambda: solver.solve(rhs))
        collectives = COLLECTIVES.launches - c0
        r0, r1 = 0, n_glob
        x_loc = np.asarray(res.x, dtype=np.float64)
        true_relres = float(np.linalg.norm(A @ x_loc - b)
                            / np.linalg.norm(b))
        local_rows, local_nnz = int(A.shape[0]), int(A.nnz)
        blk_nnz = tail_nnz = 0
        holds_global_fine = True

    out = {
        "process_id": solver.ranks.rank,
        "process_count": solver.ranks.size,
        "n_devices": solver.ranks.size, "n_local_devices": 1,
        "backend": dist.get_backend(), "device": str(device),
        "n": n_glob, "problem": args.problem, "setup": args.setup,
        "krylov": args.krylov, "iterations": res.iterations,
        "passes": res.refine_passes, "relres": res.relres,
        "converged": bool(res.converged), "true_relres": true_relres,
        "row_range": [int(r0), int(r1)],
        "local_rows": local_rows, "local_nnz": local_nnz,
        "blocked_levels_nnz": blk_nnz, "tail_nnz": tail_nnz,
        "holds_global_fine": holds_global_fine,
        "setup_s": float(solver.setup_time), "solve_s": res.solve_time,
        "warm_s": warm_s, "capture_s": solver.graph_seconds()[0],
        "pass_graph_s": solver.pass_graph_seconds(),
        "pass_ms": res.pass_ms,
        "pass_share": sum(res.pass_ms) / 1e3 / res.solve_time,
        "levels": [type(l.A).__name__ for l in solver.dist.levels],
        "launches": launches, "collectives": collectives,
        "capture": solver._loop().capture, "host_reads": res.host_reads,
        "step_node_kinds": (solver._loop().step.node_kinds()
                            if solver._loop().capture else None),
        "maxrss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        "x_norm": float(np.linalg.norm(x_loc)),
        "x_head": x_loc[:8].tolist(),
    }
    if eager is not None:
        c0 = COLLECTIVES.launches
        want = eager.solve(rhs)
        out["eager"] = {"iterations": want.iterations,
                        "passes": want.refine_passes,
                        "host_reads": want.host_reads,
                        "collectives": COLLECTIVES.launches - c0,
                        "solve_s": want.solve_time}
        out["same_bits"] = bool(np.array_equal(
            np.asarray(want.x, dtype=np.float64), x_loc))
    print(json.dumps(out), flush=True)
    destroy_process_group()


if __name__ == "__main__":
    _worker_main()
