"""Traffic kind ``resetup``: one client in a closed loop over new matrices
of one pattern.

Request k solves A_k x = b_k with A_k = K + c_k * mean(diag K) * I, K the
configuration's matrix: ``maybe_reorder`` and ``amg_setup`` with the
configuration's near-nullspace (span ``host_setup``), ``AMGSolver(...)``
(``freeze``), ``warm()`` (``warm``), ``prepare_rhs`` and one solve to the
configuration's tol with x read back to the host (``solve``), then
``release_graphs`` and the solver dropped (``release``).

Set-up makes a pool of ``pool`` matrices (one copy of K's values each,
K's index arrays shared) and right-hand sides, and carries one request
through on a matrix of its own, so the window holds only the port's work.
The shifts c_k are log-uniform on [``shift_min``, ``shift_max``], one in
each of ``pool`` equal strata in an order drawn from the seed, so every
seed sees the same spread of shifts.  Every request of the window is
checked.
"""
from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp

from amgbench.harness import build_problem, derive_seed
from amgbench.reference.residual import mean_diagonal, relres
from amgbench.work import levels_of, solve_bytes

RHS_STREAM = 1          # seed streams of this kind's inputs
SHIFT_STREAM = 3


def shifts(run) -> np.ndarray:
    t = run.traffic
    pool = int(t["pool"])
    rng = np.random.default_rng(derive_seed(run.seed, SHIFT_STREAM))
    u = (rng.permutation(pool) + rng.random(pool)) / pool
    lo, hi = float(t["shift_min"]), float(t["shift_max"])
    return lo * (hi / lo) ** u


def _shifted(K, diag_pos: np.ndarray, shift: float):
    data = K.data.copy()
    data[diag_pos] += shift
    A = sp.csr_matrix((data, K.indices, K.indptr), shape=K.shape)
    A.has_sorted_indices = True
    return A


def prepare(run) -> None:
    t = run.traffic
    K = run.A
    t0 = time.perf_counter()
    rows = np.repeat(np.arange(K.shape[0]), np.diff(K.indptr))
    diag_pos = np.flatnonzero(K.indices == rows)
    if diag_pos.size != K.shape[0]:
        raise ValueError("resetup needs a stored diagonal in every row")
    run.dbar = float(K.data[diag_pos].mean())
    run.shifts = shifts(run)
    run.pool = [_shifted(K, diag_pos, c * run.dbar) for c in run.shifts]
    run.b = run.normal_vectors(RHS_STREAM, len(run.pool), K.shape[0])
    run.setup_spans["pool"] = time.perf_counter() - t0
    # one request outside the window, on a matrix of its own (the
    # geometric middle of the shifts): the kernels' loading, the first
    # captures and the allocator's growth
    lo, hi = float(t["shift_min"]), float(t["shift_max"])
    warm_A = _shifted(K, diag_pos, np.sqrt(lo * hi) * run.dbar)
    spans = {}
    _, _, levels = _request(run, warm_A, run.b[0], spans)
    run.setup_spans.update({f"first_{k}": v for k, v in spans.items()})
    run.work = solve_bytes(levels, run.cfg["amg"], run.cfg["krylov"])
    run.xs = {}


def _request(run, A, b, spans: dict) -> tuple:
    """One request on matrix A and right-hand side b: (its record, the
    solution on the host, the solver's host hierarchy as plain numbers)."""
    t0 = time.perf_counter()
    solver, perm = run.build_solver(A, run.nullspace, spans)
    t1 = time.perf_counter()
    res = solver.solve(solver.prepare_rhs(run.permuted(b, perm)))
    x = run.unpermuted(res.x, perm)
    t2 = time.perf_counter()
    levels = levels_of(solver.hierarchy)
    solver.release_graphs()
    del solver
    t3 = time.perf_counter()
    spans.update(solve=t2 - t1, release=t3 - t2)
    return run.solve_record(res, t3 - t0), x, levels


def window(run, seconds: float) -> None:
    misses = 0
    k = 0
    start = time.perf_counter()
    end = start + seconds
    last = start
    while True:
        t0 = time.perf_counter()
        if t0 >= end:
            break
        j = k % len(run.pool)
        spans = {}
        try:
            rec, x, _ = _request(run, run.pool[j], run.b[j], spans)
        except Exception as e:      # counted as failed; the run goes on
            last = time.perf_counter()
            run.requests.append({"ok": False, "wall_s": last - t0,
                                 "error": repr(e)})
            misses += 1
            if misses >= 3:
                break
            k += 1
            continue
        last = time.perf_counter()
        misses = 0
        run.xs[len(run.requests)] = (x, j)
        rec.update(spans=spans, matrix=j)
        run.requests.append(rec)
        k += 1
    run.window_s = last - start


def check(run) -> tuple:
    """Every request's solution against the reference's fp64 residual of
    (K + c_k mean(diag K) I) x - b_k, from the benchmark's own K (built
    again) and right-hand sides."""
    run.pool = []
    K, _ = build_problem(run.cfg, run.bench_dir)
    dbar = mean_diagonal(K)
    values = [(relres(K, x, run.b[j], run.shifts[j] * dbar), i)
              for i, (x, j) in run.xs.items()]
    worst = max((v if np.isfinite(v) else np.inf for v, _ in values),
                default=np.inf)
    failed = {i for v, i in values if not v <= run.tol}
    return [{"name": "relres_max", "value": float(worst),
             "limit": run.tol}], failed


def breakdown(record: dict) -> dict:
    """The window's time by host phase (the benchmark's spans, summed
    over requests) and the pass graphs' device time."""
    phases = {}
    for r in record["requests"]:
        for name, s in r.get("spans", {}).items():
            phases[name] = phases.get(name, 0.0) + s
    busy = sum(sum(r.get("pass_ms", ())) for r in record["requests"]) / 1e3
    gaps = sorted(phases.items(), key=lambda kv: -kv[1])
    return {"device_ops": [["pass_graphs", busy]],
            "idle_gaps": [[f"host.{k}", v] for k, v in gaps][:10]}
