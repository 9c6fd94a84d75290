"""Traffic kind ``rhs_stream``: one client in a closed loop on one matrix.

Set-up: the port's set-up of the configuration's matrix, a pool of
``pool`` distinct seeded standard-normal right-hand sides uploaded once
with ``prepare_rhs``, a priming solve at ``prime_tol`` and
``warm_solves`` solves at the configuration's tol.  The window: solve
after solve on the same solver, each on the next right-hand side of the
pool, x from zero and left on the device; a request runs from the
``solve`` call to its return.

Checked: ``kept`` solutions, each the first solve to start after one of
``kept`` instants drawn from the seed before the window (one in each
``seconds / kept`` of it), kept on the device until the window closes.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from amgbench.harness import build_problem, derive_seed
from amgbench.reference.residual import relres
from amgbench.work import levels_of, solve_bytes

RHS_STREAM = 1          # seed streams of this kind's inputs
KEEP_STREAM = 2


def prepare(run) -> None:
    t = run.traffic
    spans = run.setup_spans
    run.solver, run.perm = run.build_solver(run.A, run.nullspace, spans)
    run.work = solve_bytes(levels_of(run.solver.hierarchy),
                           run.cfg["amg"], run.cfg["krylov"])
    t0 = time.perf_counter()
    run.b = run.normal_vectors(RHS_STREAM, int(t["pool"]), run.A.shape[0])
    run.pool = [run.solver.prepare_rhs(run.permuted(b, run.perm))
                for b in run.b]
    run.sync()
    spans["rhs_upload"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run.solver.solve(run.pool[0], tol=float(t["prime_tol"]))
    for j in range(int(t["warm_solves"])):
        run.solver.solve(run.pool[j % len(run.pool)])
    run.sync()
    spans["prime"] = time.perf_counter() - t0
    rng = np.random.default_rng(derive_seed(run.seed, KEEP_STREAM))
    kept = int(t["kept"])
    run.keep_at = (np.arange(kept) + rng.random(kept)) * run.seconds / kept
    if run.device.type == "cuda":
        # what the card has to hold from here on: the solver, its graphs,
        # the pool and the kept solutions.  Set-up's free blocks go back,
        # and the blocks of the solutions the window keeps (each solve
        # returns a fresh copy of x) are reserved now, so the window's
        # peak does not depend on when they are taken
        torch.cuda.empty_cache()
        blocks = [torch.empty(run.solver.n_pad, dtype=torch.float64,
                              device=run.device) for _ in range(kept + 2)]
        del blocks


def window(run, seconds: float) -> None:
    solver, pool = run.solver, run.pool
    keep_at = list(run.keep_at)
    run.kept = []
    misses = 0
    i = 0
    start = time.perf_counter()
    end = start + seconds
    last = start
    while True:
        t0 = time.perf_counter()
        if t0 >= end:
            break
        j = i % len(pool)
        try:
            res = solver.solve(pool[j])
        except Exception as e:      # counted as failed; the run goes on
            last = time.perf_counter()
            run.requests.append({"ok": False, "wall_s": last - t0,
                                 "error": repr(e)})
            misses += 1
            if misses >= 3:
                break
            i += 1
            continue
        last = time.perf_counter()
        misses = 0
        run.requests.append(run.solve_record(res, last - t0, rhs=j))
        if keep_at and t0 - start >= keep_at[0]:
            keep_at.pop(0)
            run.kept.append((res, j, len(run.requests) - 1))
        i += 1
    run.window_s = last - start


def check(run) -> tuple:
    """The kept solutions against the reference's fp64 residual from the
    benchmark's own matrix (built again) and right-hand sides; no kept
    solution reads as an infinite residual."""
    xs = [(run.unpermuted(res.x, run.perm), j, i) for res, j, i in run.kept]
    release(run)
    A, _ = build_problem(run.cfg, run.bench_dir)
    values = [(relres(A, x, run.b[j]), i) for x, j, i in xs]
    worst = max((v if np.isfinite(v) else np.inf for v, _ in values),
                default=np.inf)
    failed = {i for v, i in values if not v <= run.tol}
    return [{"name": "relres_max", "value": float(worst),
             "limit": run.tol}], failed


def release(run) -> None:
    """Drop the program's state: its graphs first."""
    run.kept = []
    run.pool = []
    if getattr(run, "solver", None) is not None:
        run.solver.release_graphs()
        run.solver = None


def breakdown(record: dict) -> dict:
    """Device time by pass graph (the first and the later passes of each
    solve, from the CUDA events around each launch, which time every
    iteration) and the rest of the window, when the host ran solve()'s
    own code between launches."""
    first = later = 0.0
    for r in record["requests"]:
        ms = r.get("pass_ms", [])
        first += sum(ms[:1]) / 1e3
        later += sum(ms[1:]) / 1e3
    busy = first + later
    return {"device_ops": [["pass_graph.first", first],
                           ["pass_graph.later", later]],
            "idle_gaps": [["host.between_pass_graphs",
                           record["window_s"] - busy]]}
