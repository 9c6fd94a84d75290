#!/usr/bin/env python3
"""Dry runs of the port's distributed solver (the counterpart of
``__graft_entry__.py``'s ``dryrun_multichip`` and ``dryrun_multiprocess``).

    python3 graft_entry_torch.py [--ranks N] [--device cuda|cpu]
                                 [--backend nccl|gloo]

``dryrun_multichip(n)`` starts n rank processes of one process group and
runs a full distributed AMG-PCG solve twice on poisson3d(64) with the
flagship parameters: once from the global setup (every rank builds the
hierarchy and freezes its block), once from the process-local blocked
pipeline (each rank generates only its rows, runs the blocked setup with
the others, freezes its block, and holds no global fine matrix), wrapped
with ``DistAMGSolver.from_frozen``.  The hierarchy crosses every
distributed operator: a DistDia fine level (halo exchange), DistEll coarse
levels, the GatherOut/ReplSrc replication boundary, replicated dense
levels and the dense coarse inverse; dots are all-reduces, and the fp64
refinement runs on top.  ``dryrun_multiprocess(n)`` runs the process-local
solve of ``parallel/multihost.py`` on n ranks at 24^3.

Both run on the card unless the caller asks for the CPU; several ranks
share one card through ``backend="gloo"``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

M = 64                     # poisson3d(64): 262,144 unknowns


def _rank_multichip(m: int) -> None:
    """One rank of dryrun_multichip: both passes, one JSON line."""
    import torch
    import torch.distributed as dist
    from sparsh_amg_tpu_torch.models.poisson import poisson3d, poisson3d_rows
    from sparsh_amg_tpu_torch.ops import counted
    from sparsh_amg_tpu_torch.params import KrylovParams
    from sparsh_amg_tpu_torch.parallel import multihost
    from sparsh_amg_tpu_torch.parallel.blocked_dist import (
        blocked_to_dist, fine_fp64_blocked)
    from sparsh_amg_tpu_torch.parallel.dist import GatherOut
    from sparsh_amg_tpu_torch.parallel.solver import DistAMGSolver
    from sparsh_amg_tpu_torch.setup.blocked import (blocked_amg_setup,
                                                    partition_bounds)
    from sparsh_amg_tpu_torch.setup.comm import GlooComm
    from sparsh_amg_tpu_torch.solve.device import DeviceLevel
    multihost.pin_threads()
    device = multihost.init_process_group()
    rank, size = dist.get_rank(), dist.get_world_size()
    params = multihost._flagship_params()
    krylov = KrylovParams(tol=1e-8, maxiter=60)
    n_glob = m ** 3
    b = np.random.default_rng(0).standard_normal(n_glob)

    def run(solver):
        rhs = solver.prepare_rhs(b)
        res, launches = counted(lambda: solver.solve(rhs))
        x = solver.gather_global(res)
        levels = solver.dist.levels
        return {
            "iterations": res.iterations, "passes": res.refine_passes,
            "relres": res.relres, "converged": bool(res.converged),
            "relres_host_fp64": float(np.linalg.norm(b - A @ x)
                                      / np.linalg.norm(b)),
            "kinds": [type(l).__name__ for l in levels],
            "ops": [type(l.A).__name__ for l in levels],
            "replicated": any(isinstance(l, DeviceLevel) for l in levels),
            "gather_out": any(isinstance(getattr(l, "R", None), GatherOut)
                              for l in levels),
            "setup_s": solver.setup_time, "solve_s": res.solve_time,
            "launches": launches}

    A = poisson3d(m)
    out = {"rank": rank, "ranks": size, "backend": dist.get_backend(),
           "device": str(device),
           "global": run(DistAMGSolver(A, params=params, krylov=krylov,
                                       device=device))}

    # blocked provenance: this rank generates only its rows
    bounds = partition_bounds(n_glob, size, size)
    r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
    A_own = poisson3d_rows(m, r0, r1)
    comm = GlooComm()
    bh = blocked_amg_setup(
        A_own, bounds, comm, params,
        bounds_fn=lambda nc: partition_bounds(nc, size, size))
    dh = blocked_to_dist(bh, comm, params, device=device)
    A64 = fine_fp64_blocked(bh.levels[0].A, r0, dh.parts[0], comm, params,
                            dh.ranks, device=device)
    solver = DistAMGSolver.from_frozen(dh, A64, params, krylov,
                                       device=device)
    out["blocked"] = run(solver)
    out["blocked"]["holds_global_fine"] = A_own.shape[0] >= n_glob \
        and size > 1
    print(json.dumps(out), flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    multihost.destroy_process_group()


def dryrun_multichip(n: int = 4, device: str = "cuda",
                     backend: str | None = None, m: int = M,
                     threads: int | None = None,
                     timeout: float = 900.0) -> list:
    """Both passes on n ranks; asserts every rank converged to 1e-8 with
    the same counts, replicated coarse levels, a GatherOut boundary and
    no global fine matrix in the blocked pass.  Returns the ranks'
    results."""
    from sparsh_amg_tpu_torch.parallel import multihost
    backend = backend or multihost.default_backend(device)
    outs = multihost.spawn_ranks(
        n, [__file__, "--rank-multichip", "--m", str(m)], backend=backend,
        device=device, threads=threads, timeout=timeout)
    results = [multihost.last_json(o) for o in outs]
    for key in ("global", "blocked"):
        runs = [r[key] for r in results]
        r0 = runs[0]
        assert all(r["converged"] and r["relres_host_fp64"] <= 1e-8
                   for r in runs), runs
        assert len({(r["iterations"], r["passes"]) for r in runs}) == 1
        assert r0["replicated"], "expected replicated coarse levels"
        assert r0["gather_out"], "expected a replication boundary"
        label = "" if key == "global" else \
            " blocked-provenance: holds_global_fine=False"
        if key == "blocked":
            assert not any(r["holds_global_fine"] for r in runs)
        print(f"dryrun_multichip({n}){label} backend={backend} "
              f"device={results[0]['device']} iters={r0['iterations']} "
              f"passes={r0['passes']} relres={r0['relres']:.2e} "
              f"levels={list(zip(r0['kinds'], r0['ops']))}", flush=True)
    return results


def dryrun_multiprocess(n: int = 2, device: str = "cuda",
                        backend: str | None = None, m: int = 24,
                        threads: int | None = None) -> list:
    """The process-local solve of parallel/multihost.py on n ranks:
    every rank converges with the same count, holds no global fine
    matrix, and the row blocks tile the domain."""
    from sparsh_amg_tpu_torch.parallel.multihost import launch_processes
    results = launch_processes(n, "poisson3d", m, setup="blocked",
                               device=device, backend=backend,
                               threads=threads)
    assert all(r["converged"] for r in results)
    assert all(r["true_relres"] <= 1e-8 for r in results)
    assert len({r["iterations"] for r in results}) == 1
    assert not any(r["holds_global_fine"] for r in results)
    hi = 0
    for r in results:
        assert r["row_range"][0] == hi
        hi = r["row_range"][1]
    assert hi == results[0]["n"]
    print(f"dryrun_multiprocess({n}): iters={results[0]['iterations']} "
          f"relres={results[0]['relres']:.2e} ranks={n} "
          f"backend={results[0]['backend']} (process-local setup)",
          flush=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--rank-multichip", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_multichip:
        _rank_multichip(args.m)
        return
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device "
                           "(pass --device cpu to run on the CPU)")
    dryrun_multichip(args.ranks, args.device, args.backend, args.m)
    dryrun_multiprocess(2, args.device, args.backend)


if __name__ == "__main__":
    main(sys.argv[1:])
