"""Rank processes (the port of ``sparsh_amg_tpu/parallel/multihost.py``).

The reference launches one MPI rank per GPU.  The port does the same with
``torch.distributed``: one process per rank, each holding its row block
on its own device (rank r on card ``r % device_count``; on the CPU for
tests).  The JAX package's ``devices_per_process`` folds into ranks: one
rank per device is the PyTorch idiom, and several ranks may share a card
through the gloo backend.

* ``init_process_group`` joins the group from ``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (``tcp://`` rendezvous) and
  returns this rank's device.
* ``spawn_ranks`` starts N rank processes of a command with those
  variables set, waits for all of them, and stops the others when one
  fails; ``launch_processes`` runs the distributed solve below in them
  and collects each rank's JSON result, as the JAX package's launcher
  does (``python -m sparsh_amg_tpu_torch.parallel.multihost --worker``).
"""
from __future__ import annotations

import contextlib
import json
import os
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
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT") or str(free_port())
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world_size)
    return device


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(num: int, argv: list, *, backend: str, device="cuda",
                timeout: float = 900.0, threads: int | None = None,
                env: dict | None = None) -> list:
    """Run ``python argv...`` as ranks 0..num-1 of one process group and
    return each rank's standard output.  Every rank gets MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE, SPARSH_DIST_BACKEND and
    SPARSH_DIST_DEVICE; `threads` caps each rank's torch and OpenMP
    threads (default: this machine's cores shared out).  When a rank fails or the time runs out, every rank is
    stopped and RuntimeError carries the failing rank's output."""
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
    with tempfile.TemporaryDirectory(prefix="sparsh_ranks_") as tmp, \
            contextlib.ExitStack() as files:
        logs, procs = [], []
        try:
            for r in range(num):
                out, err = (files.enter_context(open(
                    os.path.join(tmp, f"{r}.{k}"), "w+")) for k in "oe")
                logs.append((out, err))
                procs.append(subprocess.Popen(
                    [sys.executable, *argv], cwd=REPO, stdout=out,
                    stderr=err, env=dict(base, RANK=str(r),
                                         LOCAL_RANK=str(r))))
            deadline = time.monotonic() + timeout
            failed, timed_out = None, False
            while failed is None:
                codes = [p.poll() for p in procs]
                failed = next((r for r, c in enumerate(codes)
                               if c not in (None, 0)), None)
                if failed is None and all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    failed = next(r for r, c in enumerate(codes)
                                  if c is None)
                    timed_out = True
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
    if failed is not None:
        o, e = outs[failed]
        why = f"timed out after {timeout:.0f} s" if timed_out \
            else f"rc={procs[failed].returncode}"
        raise RuntimeError(f"rank {failed} of {num} failed ({why}):\n"
                           f"{o[-3000:]}\n{e[-6000:]}")
    return [o for o, _ in outs]


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
                     threads: int | None = None) -> list:
    """Run the distributed solve of ``_worker_main`` on `num_processes`
    ranks and return their result dicts (the JAX launcher's keys, plus
    the rank's backend, device, solve time and kernel launches).

    ``setup="blocked"`` is the process-local path: each rank assembles
    only its row block, coarsens through the blocked setup and returns
    its own rows.  ``setup="global"`` builds the global matrix and
    hierarchy in every rank."""
    backend = backend or default_backend(device)
    cmd = ["-m", "sparsh_amg_tpu_torch.parallel.multihost", "--worker",
           "--m", str(m), "--setup", setup, "--problem", problem,
           "--krylov", krylov_method]
    if row_align is not None:
        cmd += ["--row-align", str(row_align)]
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
    args = ap.parse_args(argv)

    pin_threads()
    device = init_process_group()
    from ..ops import counted
    from ..params import KrylovParams
    from .solver import DistAMGSolver

    n_glob, make_rows, make_ns, params = _problem_spec(
        args.problem, args.m, args.row_align)
    krylov = KrylovParams(method=args.krylov, tol=1e-8,
                          maxiter=60 if args.problem == "poisson3d"
                          else 200)
    b = np.random.default_rng(0).standard_normal(n_glob)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)

    if args.setup == "blocked":
        solver = DistAMGSolver.from_blocked(
            make_rows, n_glob, params=params, krylov=krylov,
            make_nullspace=make_ns, device=device)
        r0, r1 = solver.row_range
        b_loc = np.ascontiguousarray(b[r0:r1])
        del b                       # steady state holds only the block
        rhs = solver.prepare_rhs(b_loc)
        sync()
        res, launches = counted(lambda: solver.solve(rhs))
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
        rhs = solver.prepare_rhs(b)
        sync()
        res, launches = counted(lambda: solver.solve(rhs))
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
        "levels": [type(l.A).__name__ for l in solver.dist.levels],
        "launches": launches,
        "maxrss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        "x_norm": float(np.linalg.norm(x_loc)),
        "x_head": x_loc[:8].tolist(),
    }
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker_main()
