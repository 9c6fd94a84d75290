#!/usr/bin/env python3
"""Time and profile warm solves of the PyTorch/CUDA port on one GPU.

    python3 scripts/torch_profile_solve.py [--root DIR] [--configs e3d e2d p3d]
    python3 scripts/torch_profile_solve.py --configs aniso2d_2048_eps1e-3_rot45_aggW_bicgstab

For each configuration (e3d: elasticity3d(40), e2d: elasticity2d(512), p3d:
the flagship poisson3d(192), or the name of one of configs.py's seven) it
sets the solver up, primes it as chip_smoke.py does (tol 1e-2, and one
full solve for the flagship), times SOLVES warm solves of the same device-resident rhs (the
first of them is the one chip_smoke.py counts), then runs one more under
torch.profiler and reads the device events: the span from the first
device event's start to the last one's end, the device busy time (the
union of the events' intervals), the number of events and the device time
by kernel name, and counts the kernel wrappers' launches in that solve.
One JSON line per configuration.

--root names the checkout whose ``sparsh_amg_tpu_torch`` is imported
(default: the one holding this script), so one call can time a parent
commit unpacked in a directory beside the tree, in turns with the tree.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SOLVES = 7
TOP_KERNELS = 12


def _problem(cfg):
    """(A, nullspace, params, krylov, prime) for a configuration."""
    from sparsh_amg_tpu_torch import configs, flagship, systems
    if cfg in configs.NAMES:
        A, ns = configs.problem(cfg)
        return A, ns, configs.params(cfg), configs.krylov(cfg), 1e-2
    if cfg == "p3d":
        from sparsh_amg_tpu_torch.models import poisson3d
        return (poisson3d(192), None, flagship.params(), flagship.krylov(),
                None)
    dim = 3 if cfg == "e3d" else 2
    A, ns = systems.problem(dim)
    return A, ns, systems.params(dim), systems.krylov(), 1e-2


def _busy(intervals):
    """Union length of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _wrappers():
    """The kernel wrappers, whose `launches` count their kernel launches."""
    from sparsh_amg_tpu_torch.ops import dia_spmv
    from sparsh_amg_tpu_torch.ops.block_ell import block_ell_spmv
    from sparsh_amg_tpu_torch.ops.ell_spmv import ell_spmv
    return (*dia_spmv.WRAPPERS, ell_spmv, block_ell_spmv)


def profile_one(cfg, dev):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sparsh_amg_tpu_torch import AMGSolver
    A, ns, p, kr, prime = _problem(cfg)
    solver = AMGSolver(A, p, kr, nullspace=ns, device=dev)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    rhs = solver.prepare_rhs(b)
    solver.solve(rhs, tol=prime)
    torch.cuda.synchronize()
    runs = []
    for _ in range(SOLVES):
        res = solver.solve(rhs)
        runs.append((res.solve_time, res.iterations, res.refine_passes))
    relres = float(np.linalg.norm(b - A @ res.x) / np.linalg.norm(b))
    torch.cuda.synchronize()
    wrappers = _wrappers()
    for w in wrappers:
        w.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solver.solve(rhs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    dev_events = [e for e in prof.events()
                  if getattr(e.device_type, "name", "") == "CUDA"]
    out = {"config": cfg, "setup_s": solver.setup_time,
           "iterations": [r[1] for r in runs],
           "passes": [r[2] for r in runs], "relres_host_fp64": relres,
           "solve_s_first": runs[0][0],
           "solve_s_median": statistics.median(r[0] for r in runs),
           "solve_s_all": [r[0] for r in runs],
           "profiled_solve_s": wall, "profiled_iterations": res.iterations,
           "launches": launches}
    if not dev_events:
        out["profile"] = "not measured: no device events in the trace"
        return out
    iv = [(e.time_range.start, e.time_range.end) for e in dev_events]
    span = max(e for _, e in iv) - min(s for s, _ in iv)
    busy = _busy(iv)
    by_name = {}
    for e in dev_events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    out["profile"] = {
        "span_ms": span / 1e3, "busy_ms": busy / 1e3,
        "busy_share": busy / span if span else None,
        "device_events": len(dev_events),
        "kernels": [{"name": n[:120], "ms": t / 1e3, "count": c}
                    for n, (t, c) in top]}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--configs", nargs="+", default=["e3d", "e2d", "p3d"],
                    help="e3d, e2d, p3d, or names from configs.NAMES")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    import sparsh_amg_tpu_torch
    assert sparsh_amg_tpu_torch.__file__.startswith(root), \
        sparsh_amg_tpu_torch.__file__
    for cfg in args.configs:
        rec = profile_one(cfg, "cuda")
        rec.update(root=root, gpu=gpu)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
