#!/usr/bin/env python3
"""Time and profile warm solves of the PyTorch/CUDA port on one GPU.

    python3 scripts/torch_profile_solve.py [--root DIR] [--configs e3d e2d p3d]
    python3 scripts/torch_profile_solve.py --configs aniso2d_2048_eps1e-3_rot45_aggW_bicgstab
    python3 scripts/torch_profile_solve.py --configs p3d --modes device eager
    python3 scripts/torch_profile_solve.py --configs p3d --while-cost

For each configuration (e3d: elasticity3d(40), e2d: elasticity2d(512), p3d:
the flagship poisson3d(192), or the name of one of configs.py's seven) it
sets the solver up, primes it as chip_smoke.py does (tol 1e-2, and one
full solve for the flagship), times SOLVES warm solves of the same device-resident rhs (the
first of them is the one chip_smoke.py counts), then runs one more under
torch.profiler and reads the device events: the span from the first
device event's start to the last one's end, the device busy time (the
union of the events' intervals), the number of events and the device time
by kernel name, and counts the kernel wrappers' launches in that solve.

--modes runs the Krylov loop for each run in turn as ``device`` (each
refinement pass one launch of a graph with a WHILE node) or ``eager``
(the same passes launched from Python, uncaptured, one read per step).
Each mode runs on a
shallow copy of the freshly set-up solver with graphs and estimates of
its own (the hierarchy is shared; the copy and its graphs are freed
before the next mode, so the peaks are the mode's alone), is warmed
(``warm()``: its graphs' capture and instantiation seconds and the pass
graphs' build seconds are reported), primed and timed alike, with the
allocator's peaks (in use and reserved, graph pools included) over its
timed solves, and ``host_reads``.  The profiler reports
the kernels of a WHILE node's body once per launch, not once per
iteration, so in the device mode its busy time misses the later
iterations: there ``pass_device_ms`` (CUDA events around each pass graph
launch of the profiled solve) and ``pass_device_share`` (their sum over
the solve's wall time) give the device's busy time and share instead.
One JSON line per configuration and mode.

--while-cost measures the WHILE node's own cost per iteration: with the
budget binding (tol 1e-30), the device time of one pass graph with K1 and
K2 iterations against the same pass replayed as its pieces (start, one
graph of the step captured K times, finish); the difference of the two
slopes over K
is what the loop adds per iteration (the guard kernel node and the
conditional node).  One JSON line per configuration.

--root names the checkout whose ``sparsh_amg_tpu_torch`` is imported
(default: the one holding this script), so one call can time a parent
commit unpacked in a directory beside the tree, in turns with the tree.
"""
import argparse
import copy
import gc
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
    """The kernel wrappers, whose `launches` count their kernel launches
    (an older checkout has no loop guard)."""
    from sparsh_amg_tpu_torch.ops import dia_spmv
    from sparsh_amg_tpu_torch.ops.block_ell import block_ell_spmv
    from sparsh_amg_tpu_torch.ops.ell_spmv import ell_spmv
    try:
        from sparsh_amg_tpu_torch.solve.graphs import loop_guard
    except ImportError:
        return (*dia_spmv.WRAPPERS, ell_spmv, block_ell_spmv)
    return (*dia_spmv.WRAPPERS, ell_spmv, block_ell_spmv, loop_guard)


def profile_all(cfg, modes, dev):
    """One record per mode of `modes` ("device", "eager") on one solver
    of configuration `cfg`."""
    import torch
    from sparsh_amg_tpu_torch import AMGSolver
    A, ns, p, kr, prime = _problem(cfg)
    fresh = AMGSolver(A, p, kr, nullspace=ns, device=dev)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    rhs = fresh.prepare_rhs(b)
    for spec in modes:
        solver = copy.copy(fresh)
        solver._reset_loop_state()
        solver.capture = spec == "device"
        graphs0 = solver.graph_seconds()
        t0 = time.perf_counter()
        solver.warm()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        graphs1 = solver.graph_seconds()
        rec = profile_one(solver, A, b, rhs, prime)
        rec.update(config=cfg, mode=spec, warm_s=warm_s,
                   capture_s=graphs1[0] - graphs0[0],
                   instantiate_s=graphs1[1] - graphs0[1],
                   pass_graph_s=getattr(solver, "pass_graph_seconds",
                                        lambda: None)(),
                   setup_s=solver.setup_time)
        del solver
        gc.collect()
        torch.cuda.empty_cache()
        yield rec


def profile_one(solver, A, b, rhs, prime):
    import torch
    from torch.profiler import ProfilerActivity, profile
    if prime is not None:
        solver.solve(rhs, tol=prime)
    else:
        solver.solve(rhs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(SOLVES):
        res = solver.solve(rhs)
        runs.append((res.solve_time, res.iterations, res.refine_passes,
                     res.host_reads))
    relres = float(np.linalg.norm(b - A @ res.x) / np.linalg.norm(b))
    torch.cuda.synchronize()
    peaks = (torch.cuda.max_memory_allocated(),
             torch.cuda.max_memory_reserved())
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
    pass_ms = _pass_device_ms(solver, rhs)
    dev_events = [e for e in prof.events()
                  if getattr(e.device_type, "name", "") == "CUDA"]
    out = {"iterations": [r[1] for r in runs], "history": res.history,
           "passes": [r[2] for r in runs], "host_reads": [r[3] for r in runs],
           "relres_host_fp64": relres,
           "solve_peak_bytes": peaks[0], "solve_peak_reserved_bytes": peaks[1],
           "solve_s_first": runs[0][0],
           "solve_s_median": statistics.median(r[0] for r in runs),
           "solve_s_all": [r[0] for r in runs],
           "profiled_solve_s": wall, "profiled_iterations": res.iterations,
           "launches": launches}
    if pass_ms is not None:
        out["pass_device_ms"] = pass_ms[0]
        out["pass_device_share"] = sum(pass_ms[0]) / (pass_ms[1] * 1e3)
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


def _pass_device_ms(solver, rhs):
    """([device ms of each pass graph], wall s) of one more solve, from
    CUDA events around each pass graph launch; None when the solve runs
    no pass graph (eager)."""
    import torch
    from sparsh_amg_tpu_torch.solve.graphs import PassGraph
    if not solver.capture:
        return None
    events = []
    launch = PassGraph.launch

    def timed_launch(self):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        launch(self)
        ev[1].record()
        events.append(ev)
    PassGraph.launch = timed_launch
    try:
        t0 = time.perf_counter()
        solver.solve(rhs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        PassGraph.launch = launch
    return [a.elapsed_time(b) for a, b in events], wall


def interleaved(cfg, modes, rounds, dev):
    """{mode: [(solve s, iterations, passes)]} of `rounds` rounds of one
    solve in each mode, in turn, on copies of one solver (see
    --interleave)."""
    import torch
    from sparsh_amg_tpu_torch import AMGSolver
    A, ns, p, kr, prime = _problem(cfg)
    fresh = AMGSolver(A, p, kr, nullspace=ns, device=dev)
    rhs = fresh.prepare_rhs(np.random.default_rng(0).standard_normal(
        A.shape[0]))
    solvers = {}
    for spec in modes:
        solver = copy.copy(fresh)
        solver.capture = spec == "device"
        solver.warm()
        solver.solve(rhs, tol=prime or 1e-2)
        solvers[spec] = solver
    torch.cuda.synchronize()
    runs = {spec: [] for spec in modes}
    for _ in range(rounds):
        for spec, solver in solvers.items():
            res = copy.copy(solver).solve(rhs)
            runs[spec].append((res.solve_time, res.iterations,
                               res.refine_passes))
    return {"config": cfg, "interleaved": runs,
            "median_s": {k: statistics.median(t for t, _, _ in v)
                         for k, v in runs.items()}}


WHILE_KS = (4, 12)
WHILE_REPS = 10


def while_cost(cfg, dev):
    """The WHILE node's cost per iteration on configuration `cfg` (see
    --while-cost)."""
    import torch
    from sparsh_amg_tpu_torch import AMGSolver
    from sparsh_amg_tpu_torch.solve.graphs import ChunkGraph
    A, ns, p, kr, _ = _problem(cfg)
    solver = AMGSolver(A, p, kr, nullspace=ns, device=dev)
    solver.warm()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    loop = solver._loop()
    loop.b64.copy_(solver.prepare_rhs(b).b)
    pg = loop.pass_graph(True)

    def steps(k):
        """One graph of the loop's step captured k times."""
        def fn(bufs):
            for _ in range(k):
                loop.step.fn(bufs)
            return ()
        return ChunkGraph(fn, (), True, loop.pool)
    pieces = {k: [loop.cast, loop.init, steps(k), loop.finish]
              for k in WHILE_KS}
    for gs in pieces.values():
        for g in gs:
            g.run()                     # instantiate outside the timing

    def device_ms(fn):
        torch.cuda.synchronize()
        a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(WHILE_REPS):
            fn()
        z.record()
        torch.cuda.synchronize()
        return a.elapsed_time(z) / WHILE_REPS

    rec = {"config": cfg, "method": kr.method, "reps": WHILE_REPS}
    for k in WHILE_KS:
        loop.set_limits(1e-30, k)
        pg.launch()
        iters = int(loop.prog[1].item())
        assert iters == k, (iters, k)
        rec[f"pass_graph_ms_k{k}"] = device_ms(pg.launch)
        rec[f"pieces_ms_k{k}"] = device_ms(
            lambda gs=pieces[k]: [g.graph.replay() for g in gs])
    k1, k2 = WHILE_KS
    slope = lambda key: (rec[f"{key}_ms_k{k2}"] - rec[f"{key}_ms_k{k1}"]) \
        / (k2 - k1)
    rec["pass_graph_ms_per_iter"] = slope("pass_graph")
    rec["chunk_ms_per_step"] = slope("pieces")
    rec["while_ms_per_iter"] = rec["pass_graph_ms_per_iter"] \
        - rec["chunk_ms_per_step"]
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--configs", nargs="+", default=["e3d", "e2d", "p3d"],
                    help="e3d, e2d, p3d, or names from configs.NAMES")
    ap.add_argument("--modes", nargs="+", default=["device"],
                    choices=["device", "eager"],
                    help="run the loop's passes as pass graphs (device) "
                         "or launched from Python (eager), in turn")
    ap.add_argument("--interleave", type=int, default=0, metavar="R",
                    help="R rounds of one solve per mode in turn, in one "
                         "process, instead of profiling")
    ap.add_argument("--while-cost", action="store_true",
                    help="measure the WHILE node's cost per iteration "
                         "instead of profiling solves")
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
        if args.while_cost:
            recs = [while_cost(cfg, "cuda")]
        elif args.interleave:
            recs = [interleaved(cfg, args.modes, args.interleave, "cuda")]
        else:
            recs = profile_all(cfg, args.modes, "cuda")
        for rec in recs:
            rec.update(root=root, gpu=gpu)
            print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
