"""Traffic kind ``rhs_stream_ranks``: ``rhs_stream``'s one client in a
closed loop, on the port's distributed solver: ``ranks`` rank processes,
each holding a block of the matrix's rows on its own card.

Set-up (``prepare``) starts the rank processes
(``multihost.start_ranks``; ``backend`` on the card, gloo on the CPU).
Each, in its own process:

* draws its rows of the seed's pool of ``pool`` right-hand sides, the
  draw ``rhs_stream`` and the check make (``Run.normal_vectors``: the
  same call on its own device, cut to its rows there);
* builds its rows r0:r1 of the configuration's matrix
  (``gen/<generator>_rows.py``, the generator's formula on those rows
  alone) and the port's process-local set-up over them
  (``DistAMGSolver.from_blocked``; ``setup`` ``blocked``): no rank holds
  the global matrix or hierarchy;
* warms the solver, uploads its rows of the pool (``prepare_rhs``),
  primes at ``prime_tol``, runs ``warm_solves`` solves, and resets its
  card's peak.

``prepare`` returns once every rank is ready.  A solve's bytes
(``work.solve_bytes``) are priced on the ranks' block levels summed
(rows, nnz and the transfers' nnz; the gathered coarse tail once).

The window: before each request rank 0 decides, outside the request's
time, whether the loop goes on and whether this request's solution is
kept, and broadcasts that (the process group's backend); every rank then
solves on the next
entry of the pool, x from zero.  A request's ``wall_s`` is rank 0's, from
its ``solve`` call to the return; its ``pass_ms`` the ranks' mean; its
``collectives`` rank 0's ``dist.collectives`` over the solve.
``window_s`` is rank 0's.  Each rank reports its card
(``harness.card_report``) into ``run.cards``.

Checked: ``kept`` solutions, chosen as ``rhs_stream`` chooses them.  The
ranks write their rows of each; the harness assembles x and holds it to
tol with the reference, against the benchmark's matrix and the same b.
Then the ranks release their graphs, leave the group and exit.  A rank
that fails, or a phase that outlasts its time, stops every rank, and the
run raises.

Optional keys, absent from the mix files: ``threads`` caps each rank's
threads (default: the host's cores shared out); ``trace_dir`` turns the
port's tracer on in every rank and has each write what it kept there
(``scripts/torch_trace_cell.py``).

Run as a script, this file is one rank: ``--rank JOB``.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.environ.get("AMGBENCH_ROOT", ""))

from amgbench.harness import derive_seed, load_module  # noqa: E402
from amgbench.reference.residual import relres  # noqa: E402
from amgbench.work import levels_of, solve_bytes  # noqa: E402

_rhs = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "rhs_stream.py"),
                   "amgbench_traffic_rhs_stream")
RHS_STREAM, KEEP_STREAM = _rhs.RHS_STREAM, _rhs.KEEP_STREAM
breakdown = _rhs.breakdown

SETUP_S = 1800.0        # the most each phase may take, s
WINDOW_SPARE_S = 600.0
CHECK_S = 600.0


# --- the harness's side ---------------------------------------------------

def _guarded(run, fn):
    """fn(); on any failure every rank is stopped and its files go."""
    try:
        return fn()
    except BaseException:
        _close(run)
        raise


def _close(run) -> None:
    ranks = getattr(run, "ranks", None)
    if ranks is not None:
        ranks.close()
        run.ranks = None
    if getattr(run, "rank_dir", None):
        shutil.rmtree(run.rank_dir, ignore_errors=True)
        run.rank_dir = None


def summed_levels(ready: list) -> list:
    """The distributed hierarchy as ``work.levels_of`` gives a serial one:
    each blocked level's rows, nnz and transfers' nnz summed over the
    ranks, then the gathered tail's levels once."""
    out = []
    for per in zip(*(r["levels"] for r in ready)):
        lev = {"n": sum(l["n"] for l in per),
               "nnz": sum(l["nnz"] for l in per)}
        p0, r0 = per[0]["P"], per[0]["R"]
        lev["P"] = (sum(l["P"][0] for l in per), p0[1],
                    sum(l["P"][2] for l in per))
        lev["R"] = (sum(l["R"][0] for l in per), r0[1],
                    sum(l["R"][2] for l in per))
        out.append(lev)
    return out + list(ready[0]["tail"])


def prepare(run) -> None:
    from sparsh_amg_tpu_torch.parallel import multihost
    t = run.traffic
    if t["setup"] != "blocked":
        raise ValueError(f"setup {t['setup']!r}: this kind runs the "
                         f"process-local blocked setup only")
    rng = np.random.default_rng(derive_seed(run.seed, KEEP_STREAM))
    kept = int(t["kept"])
    run.keep_at = (np.arange(kept) + rng.random(kept)) * run.seconds / kept
    run.rank_dir = tempfile.mkdtemp(prefix="amgbench_ranks_")
    job = os.path.join(run.rank_dir, "job.json")
    with open(job, "w") as f:
        json.dump({"config": run.cfg, "traffic": t, "seed": run.seed,
                   "n": int(run.A.shape[0]), "bench_dir": run.bench_dir},
                  f)
    cuda = run.device.type == "cuda"
    t0 = time.perf_counter()
    run.ranks = _guarded(run, lambda: multihost.start_ranks(
        int(t["ranks"]), [os.path.abspath(__file__), "--rank", job],
        backend=t["backend"] if cuda else "gloo", device=run.device.type,
        threads=t.get("threads"), stdin=True,
        env={"AMGBENCH_ROOT": os.path.dirname(run.bench_dir)}))
    ready = _guarded(run, lambda: run.ranks.expect("ready", SETUP_S))
    spans = run.setup_spans
    spans["ranks"] = time.perf_counter() - t0
    for k in ready[0]["spans"]:         # the slowest rank's
        spans["rank." + k] = max(r["spans"][k] for r in ready)
    run.rank_rows = [r["row_range"] for r in ready]
    run.rank_b_sums = [r["b_sums"] for r in ready]
    run.work = solve_bytes(summed_levels(ready), run.cfg["amg"],
                           run.cfg["krylov"])
    print("amgbench: ranks ready " + json.dumps(
        [{k: r[k] for k in ("rank", "row_range", "spans", "maxrss_gib")}
         for r in ready]), file=sys.stderr, flush=True)


def _merge(outs: list) -> list:
    """The requests as the harness keeps them: rank 0's, each with the
    ranks' mean pass_ms; a request on which the ranks disagree fails."""
    reqs = [o["requests"] for o in outs]
    if len({len(r) for r in reqs}) != 1:
        raise RuntimeError(f"the ranks ran {[len(r) for r in reqs]} "
                           f"requests: not in lockstep")
    merged = []
    for per in zip(*reqs):
        rec = dict(per[0])
        counts = {(p["iterations"], p["passes"], len(p["pass_ms"]))
                  for p in per}
        rec["pass_ms"] = [float(np.mean(ms))
                          for ms in zip(*(p["pass_ms"] for p in per))]
        rec["converged"] = all(p["converged"] for p in per)
        if len(counts) != 1:
            rec.update(ok=False, error=f"the ranks disagree on (iterations,"
                       f" passes, pass graphs): {sorted(counts)}")
        merged.append(rec)
    return merged


def window(run, seconds: float) -> None:
    def go():
        run.ranks.send({"cmd": "window", "seconds": seconds,
                        "keep_at": [float(k) for k in run.keep_at]})
        return run.ranks.expect("window", seconds + WINDOW_SPARE_S)
    outs = _guarded(run, go)
    kept = [[tuple(k) for k in o["kept"]] for o in outs]
    if any(k != kept[0] for k in kept):
        _close(run)
        raise RuntimeError(f"the ranks kept {kept}: not in lockstep")
    run.requests = _guarded(run, lambda: _merge(outs))
    run.window_s = outs[0]["window_s"]
    run.kept_at = kept[0]
    run.cards = [o["card"] for o in outs if o["card"] is not None]


def check(run) -> tuple:
    """The kept solutions, assembled from the ranks' rows, against the
    reference's fp64 residual from the benchmark's matrix and the same
    right-hand sides; no kept solution reads as an infinite residual."""
    def finish():
        run.ranks.send({"cmd": "check", "dir": run.rank_dir})
        outs = run.ranks.expect("checked", CHECK_S)
        run.ranks.wait(CHECK_S)
        return outs
    outs = _guarded(run, finish)
    try:
        found = sorted({m for o in outs for m in o["jax"]})
        if found:
            raise RuntimeError(f"a rank loaded {', '.join(found)}")
        n = run.A.shape[0]
        b = run.normal_vectors(RHS_STREAM, int(run.traffic["pool"]), n)
        for r, ((r0, r1), sums) in enumerate(zip(run.rank_rows,
                                                 run.rank_b_sums)):
            if np.ascontiguousarray(b[:, r0:r1]).sum(axis=1).tolist() \
                    != sums:
                raise RuntimeError(f"rank {r}'s right-hand sides are not "
                                   f"rows {r0}:{r1} of the seed's draw")
        values = []
        for i, j in run.kept_at:
            x = np.concatenate([np.load(os.path.join(
                run.rank_dir, f"x{i}.r{r}.npy")) for r in range(len(outs))])
            values.append((relres(run.A, x, b[j]), i))
    finally:
        _close(run)
    worst = max((v if np.isfinite(v) else np.inf for v, _ in values),
                default=np.inf)
    failed = {i for v, i in values if not v <= run.tol}
    return [{"name": "relres_max", "value": float(worst),
             "limit": run.tol}], failed


# --- one rank --------------------------------------------------------------

def draw_rows(seed: int, stream: int, count: int, n: int, r0: int, r1: int,
              device) -> np.ndarray:
    """Rows r0:r1 of ``Run.normal_vectors(stream, count, n)``'s draw: the
    same call on `device`, cut to the rows there."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, stream))
    v = torch.randn((count, n), generator=g, dtype=torch.float64,
                    device=device)
    out = np.ascontiguousarray(v[:, r0:r1].cpu().numpy())
    del v
    return out


def _emit(**line) -> None:
    print(json.dumps(line), flush=True)


def _command() -> dict:
    line = sys.stdin.readline()
    if not line:                # the harness is gone
        os._exit(3)
    return json.loads(line)


def _block_levels(solver) -> list:
    def shape(M):
        return (M.shape[0], M.shape[1], int(M.nnz))
    return [{"n": bl.r1 - bl.r0, "nnz": int(bl.A.nnz), "P": shape(bl.P),
             "R": shape(bl.R)} for bl in solver.blocked.levels]


def _maxrss_gib() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def rank_main(job_path: str) -> None:
    import torch
    import torch.distributed as dist

    from amgbench.harness import card_report, jax_modules
    from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
    from sparsh_amg_tpu_torch.parallel import multihost
    from sparsh_amg_tpu_torch.parallel.dist import COLLECTIVES
    from sparsh_amg_tpu_torch.parallel.solver import DistAMGSolver
    from sparsh_amg_tpu_torch.setup.blocked import partition_bounds
    from sparsh_amg_tpu_torch.utils import trace

    with open(job_path) as f:
        job = json.load(f)
    cfg, t, seed, n = job["config"], job["traffic"], job["seed"], job["n"]
    trace_dir = t.get("trace_dir")
    if trace_dir:
        trace.enable()
    multihost.pin_threads()
    device = multihost.init_process_group()
    cuda = device.type == "cuda"
    rank, size = dist.get_rank(), dist.get_world_size()
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else \
        (lambda: None)
    params = AMGParams(**cfg["amg"])
    krylov = KrylovParams(**cfg["krylov"])
    spans = {}

    # this rank's rows of the pool first: the whole draw is made on the
    # card, and its memory goes back before the solver's is taken
    t0 = time.perf_counter()
    bounds = partition_bounds(n, size, size, align=params.row_align)
    r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
    b = draw_rows(seed, RHS_STREAM, int(t["pool"]), n, r0, r1, device)
    if cuda:
        torch.cuda.empty_cache()
    spans["rhs_draw"] = time.perf_counter() - t0

    gen = load_module(os.path.join(job["bench_dir"], "gen",
                                   cfg["generator"] + "_rows.py"),
                      "amgbench_gen_rows_" + cfg["generator"])
    made = {}

    def make_rows(a, z):
        t1 = time.perf_counter()
        block = gen.rows(cfg["size"], a, z)
        made["s"] = time.perf_counter() - t1
        return block

    solver = DistAMGSolver.from_blocked(make_rows, n, params=params,
                                        krylov=krylov, device=device)
    if solver.row_range != (r0, r1):
        raise RuntimeError(f"rank {rank} owns rows {solver.row_range}, "
                           f"its right-hand sides are rows {r0}:{r1}")
    spans.update(rows=made["s"], blocked=solver.setup_phases["blocked"],
                 freeze=solver.setup_phases["freeze"])
    t0 = time.perf_counter()
    solver.warm()
    sync()
    spans["warm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pool = [solver.prepare_rhs(v) for v in b]
    sync()
    spans["rhs_upload"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver.solve(pool[0], tol=float(t["prime_tol"]))
    for j in range(int(t["warm_solves"])):
        solver.solve(pool[j % len(pool)])
    sync()
    spans["prime"] = time.perf_counter() - t0
    kept_n = int(t["kept"])
    setup_peak = 0
    if cuda:
        # as rhs_stream: set-up's free blocks go back, and the kept
        # solutions' blocks are reserved now
        torch.cuda.empty_cache()
        blocks = [torch.empty(solver.n_pad, dtype=torch.float64,
                              device=device) for _ in range(kept_n + 2)]
        del blocks
        setup_peak = torch.cuda.max_memory_reserved(device)
        torch.cuda.reset_peak_memory_stats(device)
    _emit(phase="ready", rank=rank, row_range=[r0, r1], spans=spans,
          b_sums=b.sum(axis=1).tolist(), levels=_block_levels(solver),
          tail=levels_of(solver.blocked.tail) if rank == 0 else None,
          maxrss_gib=_maxrss_gib())
    del b

    cmd = _command()
    if trace_dir:
        setup_trace = trace.export()
        trace.reset()
        trace.anchor()
    # the decision travels as the solve's collectives do (NCCL on the
    # card): the other ranks wait for it in a device sync, not asleep in a
    # socket, so they launch their first pass graph as rank 0 does.  The
    # host has read every launch of the last solve back by now, so no
    # captured collective is in flight beside it
    flags = torch.zeros(2, dtype=torch.int32, device=device)
    keep_at = list(cmd["keep_at"])
    requests, kept = [], []
    i = 0
    start = time.perf_counter()
    end = start + float(cmd["seconds"])
    last = start
    while True:
        if rank == 0:
            now = time.perf_counter()
            keep = now < end and bool(keep_at) and now - start >= keep_at[0]
            if keep:
                keep_at.pop(0)
            flags.copy_(torch.tensor([now < end, keep], dtype=torch.int32))
        dist.broadcast(flags, src=0)
        go, keep = flags.tolist()
        if not go:
            break
        j = i % len(pool)
        c0 = COLLECTIVES.launches
        t0 = time.perf_counter()
        res = solver.solve(pool[j])
        last = time.perf_counter()
        requests.append({"ok": True, "wall_s": last - t0,
                         "converged": bool(res.converged),
                         "iterations": int(res.iterations),
                         "passes": int(res.refine_passes),
                         "host_reads": int(res.host_reads),
                         "pass_ms": [float(x) for x in res.pass_ms],
                         "collectives": COLLECTIVES.launches - c0, "rhs": j})
        if keep:
            kept.append((len(requests) - 1, j, res))
        i += 1
    window_s = last - start
    card = None
    if cuda:
        sync()
        card = card_report(device, setup_peak,
                           torch.cuda.max_memory_reserved(device))
    if trace_dir:
        trace.anchor()
        with open(os.path.join(trace_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"rank": rank, "setup": setup_trace,
                       "window": trace.export(), "requests": requests,
                       "levels": _block_levels(solver),
                       "tail": levels_of(solver.blocked.tail)}, f)
    _emit(phase="window", rank=rank, requests=requests, window_s=window_s,
          kept=[[i, j] for i, j, _ in kept], card=card)

    cmd = _command()
    for i, j, res in kept:
        np.save(os.path.join(cmd["dir"], f"x{i}.r{rank}.npy"),
                np.asarray(res.x, dtype=np.float64))
    kept.clear()
    solver.release_graphs()
    _emit(phase="checked", rank=rank, jax=jax_modules(),
          maxrss_gib=_maxrss_gib())
    multihost.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] != ["--rank"] or len(sys.argv) != 3:
        sys.exit("usage: rhs_stream_ranks.py --rank JOB")
    try:
        rank_main(sys.argv[2])
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)         # no teardown: a peer may wait in a collective
