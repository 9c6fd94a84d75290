#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``sparsh_amg_tpu_torch``) on one
NVIDIA GPU: the counterpart of ``bench.py`` for the port.

    python3 bench_torch.py                       # flagship, poisson3d(192)
    python3 bench_torch.py --config NAME [--n M] # an acceptance configuration
    python3 bench_torch.py --n 16 --device cpu   # plain versions, CPU
    python3 bench_torch.py --dist N [--dist-backend nccl|gloo]

The flagship is ``bench.py``'s (``flagship.py``): 3-D 7-point Poisson,
PMIS with a pmis2 aggressive first level, ext+i interpolation, bf16
matrix data, Chebyshev V-cycle, AMG-PCG to 1e-8 with fp64 iterative
refinement.  ``--config`` takes any name of ``configs.NAMES`` or
``elasticity3d`` / ``elasticity2d`` (``systems.py``); ``--n`` is the grid
side (for delaunay the side of the point lattice).

Sequence: generate; the host setup (``amg_setup_s``, RCM where the
parameters ask for it) and the freeze and upload (``to_device_s``) timed
apart; ``AMGSolver.warm()`` (kernel builds, first launches); the
right-hand side uploaded (``rhs_upload_s``); a priming solve at tol 1e-2;
then the best of two solves, each the first solve after priming (on a
copy of the primed solver), with the kernels' launches counted over both.

Prints ONE JSON line, ``bench.py``'s keys (without its relay keys
``loop_mode``, ``loop_mode_ab_s``, ``dispatch_rtt_ms``) plus
``relres_host_fp64`` (recomputed with scipy from ``res.x``), the card's
``device_name`` and ``power_limit_w`` (nvidia-smi), ``setup_peak_bytes``
and ``solve_peak_bytes`` (each from a reset just before its phase),
``history``, ``launches``, ``bytes_per_nnz``, ``reference`` and ``ok``.
``value`` is nnz/s over every SpMV of the solve (``utils/accounting.py``);
``vs_baseline`` and ``vs_spec`` divide it by the copy-rate and data-sheet
speeds of light (memory rate / ``bytes_per_nnz`` of the fp32 Krylov
operator).  Device numbers (copy rate, fractions, peaks) are null on the
CPU.

``ok`` is ``converged`` and ``relres_host_fp64 <= tol``, and, where a
reference count exists (the flagship at 192, each configuration at its
own size, tol 1e-8), the reference's refinement passes and its iterations
within the slack of PERF.md §2; on the card also a measured copy rate no
higher than the data sheet's.  A failed check prints the line with
``"ok": false`` and exits 1.

``--dist N`` (the counterpart of ``bench.py --dist``) solves with
``DistAMGSolver`` on N ranks, one process each: with N > 1 this process
starts N rank processes of the same command, and rank 0 prints the line,
with ``dist_ranks`` and ``dist_backend`` (nccl, one card per rank, the
default on cuda; gloo, ranks sharing a card or the CPU).  Every rank
holds the global matrix and runs the global setup, then freezes its own
block.  The checks and reference are the serial line's; byte counts and
the memory-rate keys are priced on rank 0's layouts with one rank, and
null with several (as ``bench.py``'s distributed line prices nnz only).
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np

SYSTEMS = {"elasticity3d": 3, "elasticity2d": 2}
FLAGSHIP_N = 192
FLAGSHIP_METRIC = "amg_pcg_poisson3d_spmv_throughput"


def build_argparser() -> argparse.ArgumentParser:
    from sparsh_amg_tpu_torch import configs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None,
                    help="grid side (flagship: n^3 unknowns, default 192; "
                         "--config: default the configuration's)")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--dist", type=int, default=0, metavar="N",
                    help="row-shard over N ranks, one process each")
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="--dist process-group backend (default nccl on "
                         "cuda, gloo on cpu)")
    ap.add_argument("--coarsening", default=None,
                    choices=["rs", "pmis", "aggregation"],
                    help="flagship only: rs and pmis both run the PMIS "
                         "flagship; aggregation runs smoothed aggregation")
    ap.add_argument("--dense-size", type=int, default=None,
                    help="densify levels at/below this n (default 2048, "
                         "or the configuration's)")
    ap.add_argument("--aggressive", default=None,
                    choices=["composed", "pmis2"],
                    help="flagship only: aggressive-step scheme (default "
                         "pmis2)")
    ap.add_argument("--config", default=None,
                    choices=[*configs.NAMES, *SYSTEMS],
                    help="an acceptance configuration instead of the "
                         "flagship")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def _case(args, ap):
    """(label, build() -> (A, nullspace), params, krylov, reference or
    None, metric) for the flagship or args.config."""
    from sparsh_amg_tpu_torch import configs, flagship, systems
    from sparsh_amg_tpu_torch.params import AMGParams
    ds = args.dense_size
    full_tol = args.tol == 1e-8
    if args.config is None:
        n = FLAGSHIP_N if args.n is None else args.n
        if args.coarsening == "aggregation":
            params = AMGParams(smoother="chebyshev", cycle="V",
                               band_dtype="bfloat16",
                               coarsening="aggregation",
                               interpolation="smoothed",
                               dense_size=2048 if ds is None else ds,
                               cheby_degree_coarse=1, cheby_coarse_from=1)
        else:
            params = flagship.params(2048 if ds is None else ds).replace(
                aggressive=args.aggressive or "pmis2")
        ref = None
        if (n == FLAGSHIP_N and full_tol and ds in (None, 2048)
                and args.coarsening != "aggregation"
                and args.aggressive in (None, "pmis2")):
            r = flagship.REFERENCE_192
            ref = {"iterations": r["iterations"],
                   "refine_passes": r["refine_passes"], "iteration_slack": 1,
                   "source": "flagship.REFERENCE_192 (BENCH_r05.json)"}

        def build():
            from sparsh_amg_tpu_torch.models import poisson3d
            return poisson3d(n), None
        return (f"poisson3d({n})", build, params, flagship.krylov(args.tol),
                ref, FLAGSHIP_METRIC)

    if args.coarsening or args.aggressive:
        ap.error("--coarsening and --aggressive apply to the flagship only")
    name = args.config
    dense = {} if ds is None else {"dense_size": ds}
    if name in SYSTEMS:
        dim = SYSTEMS[name]
        m = systems.SIZES[dim] if args.n is None else args.n
        label = f"elasticity{dim}d({m})"
        params = systems.params(dim, **dense)
        krylov = systems.krylov(args.tol)
        ref = None
        if m == systems.SIZES[dim] and full_tol and ds is None:
            r = systems.REFERENCE[label]["cpu"]
            # e2d's four passes sit at the fp32 floor, hence +-2 there
            ref = {"iterations": r["iterations"],
                   "refine_passes": r["refine_passes"],
                   "iteration_slack": 1 if dim == 3 else 2,
                   "source": f"systems.REFERENCE[{label!r}]['cpu']"}
        build = lambda: systems.problem(dim, m)
    else:
        m = configs.SIZES[name] if args.n is None else args.n
        label = name
        params = configs.params(name, **dense)
        krylov = configs.krylov(name, args.tol)
        ref = None
        if m == configs.SIZES[name] and full_tol and ds is None:
            r = configs.held_counts(name)
            held = configs.REFERENCE[name].get("hold", "cpu")
            ref = {"iterations": r["iterations"],
                   "refine_passes": r["refine_passes"],
                   "iteration_slack": configs.iteration_slack(name),
                   "source": f"configs.REFERENCE[{name!r}][{held!r}]"}
        build = lambda: configs.problem(name, m)
    method = {"cg": "pcg"}.get(krylov.method, krylov.method)
    return (label, build, params, krylov, ref,
            f"amg_{method}_{name}_spmv_throughput")


def checks(out: dict, tol: float) -> dict:
    """Each check of the line: converged, host relres <= tol, the
    reference's passes and iterations (where there is a reference), and a
    measured copy rate no higher than the data sheet's (on the card)."""
    got = {"converged": bool(out["converged"]),
           "relres_host_fp64": out["relres_host_fp64"] <= tol}
    ref = out["reference"]
    if ref is not None:
        got["refine_passes"] = out["refine_passes"] == ref["refine_passes"]
        got["iterations"] = (abs(out["iterations"] - ref["iterations"])
                             <= ref["iteration_slack"])
    if out["hbm_bw_GBs"] is not None:
        got["copy_bw_plausible"] = out["hbm_bw_GBs"] <= out["hbm_bw_spec_GBs"]
    return got


def main(argv=None) -> dict:
    ap = build_argparser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    import torch
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device "
                           "(pass --device cpu to run on the CPU)")
    rank0 = True
    if args.dist:
        from sparsh_amg_tpu_torch.parallel import multihost
        out0, dev, rank0 = multihost.launch_or_join(
            args.dist, [__file__, *argv], args.dist_backend, dev)
        if out0 is not None:
            sys.stdout.write(out0)
            return multihost.last_json(out0)
    from sparsh_amg_tpu_torch import AMGSolver, configs
    from sparsh_amg_tpu_torch.ops import counted
    from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
    from sparsh_amg_tpu_torch.setup.reorder import maybe_reorder
    from sparsh_amg_tpu_torch.utils import accounting, meminfo
    from sparsh_amg_tpu_torch.utils.timing import copy_bandwidth

    label, build, params, krylov, ref, metric = _case(args, ap)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)

    t0 = time.perf_counter()
    A, ns = build()
    A = A.tocsr()
    gen_s = time.perf_counter() - t0
    b = configs.rhs(A.shape[0])

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    A, perm = maybe_reorder(A, params.reorder)
    if perm is not None:
        b = b[perm]
        ns = None if ns is None else np.asarray(ns)[perm]
    hier = amg_setup(A, params, nullspace=ns)
    amg_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if args.dist:
        from sparsh_amg_tpu_torch.parallel import DistAMGSolver
        solver = DistAMGSolver(A, params=params, krylov=krylov,
                               hierarchy=hier, device=dev)
        # byte prices from this rank's layouts stand for the whole solve
        # only when it is the only rank
        priced = solver.ranks.size == 1
    else:
        solver = AMGSolver(A, params, krylov, hierarchy=hier, device=dev)
        priced = True
    to_device_s = time.perf_counter() - t0
    setup_peak = meminfo.device_memory_stats(dev).get("peak_bytes_in_use")

    t0 = time.perf_counter()
    solver.warm()
    sync()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rhs = solver.prepare_rhs(b)
    sync()
    rhs_upload_s = time.perf_counter() - t0
    solver.solve(rhs, tol=1e-2)                 # prime, as bench.py does
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    # Each timed solve runs on a shallow copy of the primed solver: the
    # solver carries one value from solve to solve (its fp32 floor
    # estimate, AMGSolver._note_pass_slack), so without the copy the
    # second solve could take other counts.  Both are then the first
    # solve after priming, the solve the reference counts describe.
    runs, launches = counted(
        lambda: [copy.copy(solver).solve(rhs) for _ in range(2)])
    res = min(runs, key=lambda r: r.solve_time)
    solve_peak = meminfo.device_memory_stats(dev).get("peak_bytes_in_use")
    relres_host = float(np.linalg.norm(b - A @ res.x) / np.linalg.norm(b))

    nnz = int(A.nnz)
    work = accounting.work_per_iteration(
        solver.hierarchy, solver.device if priced else None, params,
        method=krylov.method, mv_op=solver._krylov_op if priced else None)
    eff_nnz = work.effective_nnz(res.iterations, res.refine_passes)
    solve_s = max(res.solve_time, 1e-12)
    nnz_per_s = eff_nnz / solve_s
    bytes_per_nnz = (accounting.op_bytes(solver._krylov_op).real / nnz
                     if priced else None)

    bw = bw_spec = name = watts = None
    if cuda and rank0:
        bw = copy_bandwidth(dev)
        bw_spec = meminfo.hbm_spec_bw(dev)
        name, watts, _ = meminfo.card_name_and_power_limit()
    ratio = lambda num, den: (None if num is None or den is None
                              else num / den)
    bytes_rate = (work.bytes_per_iter * max(res.iterations, 1) / solve_s
                  if priced else None)
    nnz_rate = None if bytes_per_nnz is None else nnz_per_s * bytes_per_nnz
    stats = meminfo.device_memory_stats(dev)

    out = {
        "metric": metric, "value": nnz_per_s, "unit": "nnz/s",
        "vs_baseline": ratio(nnz_rate, bw),
        "gflops": 2.0 * eff_nnz / solve_s / 1e9,
        "problem": label, "n": int(A.shape[0]), "nnz": nnz,
        "iterations": res.iterations, "refine_passes": res.refine_passes,
        "converged": bool(res.converged), "relres": res.relres,
        "relres_host_fp64": relres_host, "tol": args.tol,
        "history": [list(h) for h in res.history],
        "solve_s": res.solve_time,
        "solve_s_runs": [r.solve_time for r in runs],
        "setup_s": amg_setup_s + to_device_s,
        "amg_setup_s": amg_setup_s, "to_device_s": to_device_s,
        "warm_s": warm_s, "problem_gen_s": gen_s,
        "rhs_upload_s": rhs_upload_s,
        "levels": solver.hierarchy.n_levels,
        "operator_complexity": solver.hierarchy.operator_complexity(),
        "hbm_bw_GBs": ratio(bw, 1e9), "hbm_bw_spec_GBs": ratio(bw_spec, 1e9),
        "bytes_per_nnz": bytes_per_nnz,
        "speed_of_light_nnz_per_s": ratio(bw, bytes_per_nnz),
        "vs_spec": ratio(nnz_rate, bw_spec),
        "spmv_equiv_per_iter": work.spmv_equiv,
        "bytes_per_iter": work.bytes_per_iter if priced else None,
        "hbm_fraction": ratio(bytes_rate, bw),
        "hbm_fraction_spec": ratio(bytes_rate, bw_spec),
        "backend": dev.type, "device_name": name, "power_limit_w": watts,
        "device_bytes": solver.device_bytes(),
        "device_bytes_by_level": accounting.footprint_table(
            solver.device, solver.A64, solver.A32),
        "setup_peak_bytes": setup_peak, "solve_peak_bytes": solve_peak,
        "bytes_in_use": stats.get("bytes_in_use"),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "bytes_limit": stats.get("bytes_limit"),
        "launches": launches,
        "reference": ref,
    }
    if args.config is not None:
        out["config"] = args.config
        out["device_ops"] = [type(l.A).__name__
                             for l in solver.device.levels]
    if args.dist:
        import torch.distributed as dist
        out.update(dist_ranks=solver.ranks.size,
                   dist_backend=dist.get_backend(),
                   device_ops=[type(l.A).__name__
                               for l in solver.device.levels])
        dist.destroy_process_group()
    out["checks"] = checks(out, args.tol)
    out["ok"] = all(out["checks"].values())
    if rank0:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
