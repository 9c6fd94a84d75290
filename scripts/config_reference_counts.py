#!/usr/bin/env python
"""Reference counts of the seven scalar configurations (configs.py) and
the two elasticity ones (systems.py: elasticity3d, elasticity2d) on the
CPU: the JAX package's solver, or with ``--port`` the PyTorch port (its
plain versions on the CPU, its CUDA kernels with ``--device cuda``), at
full size, both in the loop placement of ``--loop-mode`` (default
device, the references' placement and the port's only one) and
``--chunk`` (default the configuration's; the JAX package's host mode
alone reads it).  Each run primes the solver at tol 1e-2 and then
solves to the configured 1e-8, as ``scripts/run_configs_tpu.py:167-168``
does, and prints one JSON line: iterations, refinement passes, the
per-pass history and relres recomputed in fp64.

    JAX_PLATFORMS=cpu python scripts/config_reference_counts.py NAME \\
        [--port [--device cuda]] [--seed S] [--compensated-dots] [--size M]
        [--loop-mode host|device] [--chunk K]

A full-size configuration needs 1-4 GB of host memory and minutes of CPU
(the W-cycle BiCGStab ones most); run one configuration per process.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name")
    ap.add_argument("--port", action="store_true",
                    help="the port's plain versions instead of the JAX "
                         "package")
    ap.add_argument("--device", default="cpu",
                    help="the port's device (with --port): cpu or cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="rng seed of the right-hand side (0: the "
                         "configured one)")
    ap.add_argument("--compensated-dots", action="store_true")
    ap.add_argument("--size", type=int, default=None,
                    help="grid side (default: the configuration's)")
    ap.add_argument("--loop-mode", default="device",
                    choices=["device", "host"])
    ap.add_argument("--chunk", type=int, default=None)
    args = ap.parse_args()
    if args.device != "cpu" and not args.port:
        ap.error("--device applies to the port (--port) only")
    from sparsh_amg_tpu_torch import configs, systems
    dims = {"elasticity3d": 3, "elasticity2d": 2}
    if args.name in dims:
        dim = dims[args.name]
        A, ns = systems.problem(dim, args.size)
        p, kr = systems.params(dim), systems.krylov()
    else:
        A, ns = configs.problem(args.name, args.size)
        p, kr = configs.params(args.name), configs.krylov(args.name)
    kr = dataclasses.replace(kr, compensated_dots=args.compensated_dots,
                             loop_mode=args.loop_mode,
                             chunk=args.chunk or kr.chunk)
    b = np.random.default_rng(args.seed).standard_normal(A.shape[0])
    t0 = time.perf_counter()
    if args.port:
        from sparsh_amg_tpu_torch import AMGSolver
        solver = AMGSolver(A, p, kr, nullspace=ns, device=args.device)
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        from sparsh_amg_tpu import params as jparams
        from sparsh_amg_tpu.solve.solver import AMGSolver as JaxSolver
        solver = JaxSolver(A, jparams.AMGParams(**dataclasses.asdict(p)),
                           jparams.KrylovParams(**dataclasses.asdict(kr)),
                           nullspace=ns)
    setup_s = time.perf_counter() - t0
    rhs = solver.prepare_rhs(b)
    solver.solve(rhs, tol=1e-2)
    res = solver.solve(rhs)
    print(json.dumps({
        "name": args.name,
        "solver": f"port {args.device}" if args.port else "jax cpu",
        "seed": args.seed, "compensated_dots": args.compensated_dots,
        "loop_mode": kr.loop_mode, "chunk": kr.chunk,
        "n": A.shape[0], "nnz": int(A.nnz), "iterations": res.iterations,
        "refine_passes": res.refine_passes, "history": res.history,
        "relres": float(np.linalg.norm(b - A @ res.x) / np.linalg.norm(b)),
        "levels": solver.hierarchy.n_levels, "setup_s": setup_s}),
        flush=True)


if __name__ == "__main__":
    main()
