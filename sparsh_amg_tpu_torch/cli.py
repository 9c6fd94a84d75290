"""Command-line front end of the port (the port of
``sparsh_amg_tpu/cli.py``): build or read a matrix, pick the strategy,
smoother, cycle and Krylov method from argv, solve, and print the
results.

    python -m sparsh_amg_tpu_torch.cli --problem poisson3d --n 8000000 \\
        --smoother chebyshev --cycle V --krylov cg --tol 1e-8 --json

The solve runs on the GPU (``--device cuda``, the default) and raises when
there is none; ``--device cpu`` runs the kernels' plain PyTorch versions.
Each refinement pass is one device-resident loop (one CUDA graph launch
with a WHILE node on the card, read once per pass; eager on the CPU): the
JAX CLI's ``--loop-mode device``, with its exact counts.

``--dist N`` row-shards the solve over N ranks, one process each
(``parallel/``): with N > 1 this process starts N rank processes of the
same command and prints rank 0's output.  ``--dist-backend`` is nccl (one
card per rank; the default on cuda) or gloo (ranks may share a card, or
run on the CPU; the default on cpu):

    python -m sparsh_amg_tpu_torch.cli --problem poisson3d --n 262144 \
        --dist 4 --dist-backend gloo --json
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .models import get_problem
from .params import AMGParams, KrylovParams


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sparsh_amg_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--problem", default="poisson2d",
                   help="poisson2d|poisson3d|anisotropic|elasticity|"
                        "elasticity3d|jump|convection|convection3d|"
                        "anisotropic3d or a path to a MatrixMarket .mtx file")
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--rhs", default=None, metavar="PATH",
                   help="right-hand-side file (.mtx array or plain text); "
                        "default is a seeded random vector")
    p.add_argument("--theta", type=float, default=0.25)
    p.add_argument("--coarsening", default="rs",
                   choices=["rs", "pmis", "hmis", "aggregation"])
    p.add_argument("--interpolation", default=None,
                   choices=[None, "direct", "extpi", "tentative", "smoothed"])
    p.add_argument("--interp-max", type=int, default=6,
                   help="max interpolation entries per row (truncation)")
    p.add_argument("--agg-levels", type=int, default=0,
                   help="aggressive (composed double) coarsening on the "
                        "first k levels")
    p.add_argument("--aggressive", default="composed",
                   choices=["composed", "pmis2"],
                   help="aggressive-step scheme: composed = two full "
                        "rounds via an intermediate RAP; pmis2 = second "
                        "PMIS on the distance-2 C-C graph + smoothed "
                        "multipass interpolation")
    p.add_argument("--rap-drop-tol", type=float, default=0.0,
                   help="Galerkin operator drop/lump filter threshold")
    p.add_argument("--agg-blocksize", type=int, default=1,
                   help="dofs per node for node-amalgamated aggregation "
                        "(2 = 2-D elasticity)")
    p.add_argument("--no-p-smooth-filter", action="store_true",
                   help="SA: smooth P with the unfiltered operator "
                        "(systems recipe, with --agg-blocksize)")
    p.add_argument("--smoother", default="jacobi",
                   choices=["jacobi", "l1jacobi", "chebyshev", "gs2"])
    p.add_argument("--cycle", default="V", choices=["V", "W", "F"])
    p.add_argument("--nu1", type=int, default=1)
    p.add_argument("--nu2", type=int, default=1)
    p.add_argument("--krylov", default="cg",
                   choices=["cg", "bicgstab", "amg"],
                   help="amg = standalone cycle iteration (no Krylov)")
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--maxiter", type=int, default=500)
    p.add_argument("--no-refine", action="store_true")
    p.add_argument("--coarse-size", type=int, default=1024)
    p.add_argument("--dense-size", type=int, default=2048)
    p.add_argument("--band-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--reorder", default="auto",
                   choices=["auto", "rcm", "none"])
    p.add_argument("--dist", type=int, default=0, metavar="N",
                   help="row-shard over N ranks, one process each (0 = "
                        "the serial solver)")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend of --dist: nccl needs one "
                        "card per rank (default on cuda), gloo shares cards "
                        "or runs on the CPU (default on cpu)")
    p.add_argument("--save-hierarchy", default=None, metavar="PATH.npz",
                   help="serialize the host hierarchy after setup")
    p.add_argument("--load-hierarchy", default=None, metavar="PATH.npz",
                   help="reuse a saved hierarchy instead of running setup")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the solve into DIR")
    p.add_argument("--coarse-solver", default="lu",
                   choices=["lu", "cholesky", "smooth"])
    p.add_argument("--device", default="cuda",
                   help="torch device of the solve (default cuda; cpu runs "
                        "the kernels' plain versions)")
    p.add_argument("--verbose", action="store_true",
                   help="debug logging of the port's modules")
    p.add_argument("--json", action="store_true",
                   help="print one JSON line with the results")
    return p


def _profiled(fn, out_dir: str, device):
    """fn() under torch.profiler, its Chrome trace written into out_dir."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(out_dir, "solve_trace.json"))
    return out


def run(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device "
                           "(pass --device cpu to solve on the CPU)")
    rank0 = True
    if args.dist:
        from .parallel import multihost
        out0, device, rank0 = multihost.launch_or_join(
            args.dist, ["-m", "sparsh_amg_tpu_torch.cli", *argv],
            args.dist_backend, device)
        if out0 is not None:
            sys.stdout.write(out0)
            return multihost.last_json(out0) if args.json else {}
    if args.verbose:
        import logging
        from .utils.logging import get_logger
        get_logger().setLevel(logging.DEBUG)
    interp = args.interpolation or (
        "smoothed" if args.coarsening == "aggregation" else "direct")
    params = AMGParams(theta=args.theta, coarsening=args.coarsening,
                       interpolation=interp, smoother=args.smoother,
                       cycle=args.cycle, nu1=args.nu1, nu2=args.nu2,
                       coarse_size=args.coarse_size, reorder=args.reorder,
                       dense_size=args.dense_size,
                       band_dtype=args.band_dtype,
                       coarse_solver=args.coarse_solver,
                       interp_max=args.interp_max,
                       agg_levels=args.agg_levels,
                       aggressive=args.aggressive,
                       agg_blocksize=args.agg_blocksize,
                       p_smooth_filter=not args.no_p_smooth_filter,
                       rap_drop_tol=args.rap_drop_tol)
    krylov = KrylovParams(method=args.krylov, tol=args.tol,
                          maxiter=args.maxiter, refine=not args.no_refine)

    if args.problem.endswith((".mtx", ".mm")):
        from .utils.io import read_matrix, read_rhs
        A = read_matrix(args.problem)
        if args.rhs:
            b = read_rhs(args.rhs, n=A.shape[0])
        else:
            rng = np.random.default_rng(0)
            b = rng.standard_normal(A.shape[0])
        name = args.problem
        nullspace = None
    else:
        prob = get_problem(args.problem, n=args.n)
        A, b, name = prob.A, prob.b, prob.name
        nullspace = prob.nullspace
        if args.rhs:
            from .utils.io import read_rhs
            b = read_rhs(args.rhs, n=A.shape[0])

    from .solve.solver import AMGSolver
    hierarchy = None
    if args.load_hierarchy:
        from .utils.serialize import load_hierarchy
        hierarchy = load_hierarchy(args.load_hierarchy)
    if args.dist:
        from .parallel.solver import DistAMGSolver
        solver = DistAMGSolver(A, params=params, krylov=krylov,
                               hierarchy=hierarchy, nullspace=nullspace,
                               device=device)
    else:
        solver = AMGSolver(A, params, krylov, hierarchy=hierarchy,
                           nullspace=nullspace, device=device)
    if args.save_hierarchy and rank0:
        from .utils.serialize import save_hierarchy
        save_hierarchy(args.save_hierarchy, solver.hierarchy)

    if args.profile:
        res = _profiled(lambda: solver.solve(b), args.profile, device)
    else:
        res = solver.solve(b)
    nnz = A.nnz
    out = {
        "problem": name, "n": A.shape[0], "nnz": int(nnz),
        "levels": solver.hierarchy.n_levels,
        "operator_complexity": solver.hierarchy.operator_complexity(),
        "converged": bool(res.converged), "relres": res.relres,
        "iterations": res.iterations, "refine_passes": res.refine_passes,
        "setup_time_s": res.setup_time, "solve_time_s": res.solve_time,
        "dof_per_s": A.shape[0] * max(res.iterations, 1)
        / max(res.solve_time, 1e-12),
    }
    if args.dist:
        import torch.distributed as dist
        from .parallel.multihost import destroy_process_group
        out.update(dist_ranks=args.dist, dist_backend=dist.get_backend())
        destroy_process_group()
    if not rank0:
        return out
    if args.json:
        print(json.dumps(out))
    else:
        print(solver.hierarchy)
        print(res)
        for k, v in out.items():
            print(f"{k:>22s}: {v}")
    return out


if __name__ == "__main__":
    run()
