#!/usr/bin/env python3
"""Run one cell of ``amgbench`` with the port's tracer on, and say where
its time went.

    python3 scripts/torch_trace_cell.py --workload CELL --seed N --seconds S
    python3 scripts/torch_trace_cell.py --resolution

From the root of a checkout, on a CUDA card.  The cell runs through
``amgbench/harness.py::run_cell`` unchanged, with
``sparsh_amg_tpu_torch.utils.trace`` enabled before the traffic's ``prepare``;
set-up's trace is taken apart from the window's, and the window is
bracketed by two anchors that put the device's intervals on the host
clock.  Prints one JSON line: the harness's result (the cell's
``per_layer`` metrics, as ``--trace 1`` gives them, with the tracer's
cost inside), and under ``trace`` what the tracer found:

* rhs cells: the stamped device time of each level of the cycle, the
  Krylov work and the rest of the pass graphs (their start, finish, guard
  and the stamps' own cost) against the pass graphs' CUDA events;
  ``fine_cycle_roofline_pct`` (level 0's bytes of a cycle, priced as
  ``amgbench/work.py`` prices them, over its stamped time at the
  data-sheet rate), ``coarse_cycle_ms_per_iter``, ``krylov_ms_per_iter``
  and ``solve_host_idle_ms`` (time inside ``solve`` spans with no device
  interval running); the device's idle gaps by the innermost host span
  open across them;
* resetup cells: host set-up by phase and by level, the freeze's packing
  and uploads, the warm-up's captures, and ``setup_prolongator_s``,
  ``setup_rap_s``, ``freeze_pack_s``, ``freeze_upload_s`` a request;
* cells of rank processes (traffic kind ``rhs_stream_ranks``): each rank
  traces itself (the mix's ``trace_dir``), and each rank's window is
  taken apart as an rhs cell's on its own block levels at one card's
  rate, its set-up by blocked level, tail and freeze.

``--resolution`` times back-to-back stamps on the card instead: the
smallest nonzero delta of the global timer between two of them.

A stopgap: it leans on the harness's private details (it swaps
``harness.load_module`` for the whole process, wraps each traffic
driver's ``prepare`` and ``window``, and tells an rhs cell from a resetup
cell by ``run.solver``).  Once ``amgbench/harness.py`` enables the tracer
itself and the benchmark's readers take over ``rhs_report``,
``resetup_report`` and ``idle_gaps`` (PERF.md, Open questions), this
script is deleted.  Its pure functions are tested on synthetic records
(``tests/test_torch_trace.py``), the whole run beside the benchmark's
own tests (``amgbench/tests/test_trace_cell.py``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHASES = {"prolongator": ("setup.strength", "setup.coarsen", "setup.interp"),
          "rap": ("setup.rap", "setup.transpose")}


def level_bytes(levels: list, amg: dict) -> list:
    """Bytes of one cycle on each level (``amgbench/work.py``'s rule:
    operator applications, one R and one P a visit, the coarse solve)."""
    from amgbench.work import VALUE_BYTES, count_cycle, spmv_bytes
    vb = VALUE_BYTES[amg["band_dtype"]]
    acc = [{"A": 0.0, "T": 0.0, "C": 0.0} for _ in levels]
    count_cycle(len(levels), 0, amg["cycle"], amg, acc)
    out = []
    for lev, c in zip(levels, acc):
        n, nnz = lev["n"], lev["nnz"]
        b = c["A"] * spmv_bytes(nnz, n, n, vb)
        if c["T"] and lev["P"] is not None:
            for rows, cols, t_nnz in (lev["P"], lev["R"]):
                b += c["T"] / 2 * spmv_bytes(t_nnz, rows, cols, vb)
        if c["C"]:
            if n <= amg["coarse_inv_max"] and amg["coarse_solver"] != "smooth":
                b += c["C"] * spmv_bytes(n * n, n, n, 4)
            else:
                b += c["C"] * amg["coarse_smooth_sweeps"] \
                    * spmv_bytes(nnz, n, n, vb)
        out.append(b)
    return out


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(busy: list, starts: list, s: float, e: float) -> float:
    """Length of [s, e] inside the sorted disjoint intervals `busy`."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    got = 0.0
    while i < len(busy) and busy[i][0] < e:
        got += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
        i += 1
    return got


def device_split(stamps: dict, pass_ms: float) -> dict:
    """Stamped ns of each level, the Krylov work and the pass graphs'
    remainder (start, finish, guard, the stamps' cost)."""
    L = sum(1 for k in stamps if k.startswith("enter["))
    ns = {k: v["ns"] for k, v in stamps.items()}
    levels = [ns.get(f"enter[{l + 1}]", 0) + ns.get(f"leave[{l}]", 0)
              if l < L - 1 else ns.get(f"leave[{l}]", 0) for l in range(L)]
    krylov = ns.get("enter[0]", 0) + ns.get("step.end", 0)
    stamped = sum(ns.values())
    return {"levels_ns": levels, "krylov_ns": krylov, "stamped_ns": stamped,
            "pass_ns": pass_ms * 1e6,
            "remainder_ns": pass_ms * 1e6 - stamped,
            "cycles": stamps.get("enter[0]", {}).get("count", 0)}


def idle_gaps(window: dict) -> tuple:
    """(the device's idle time by the innermost host span open across it,
    host idle ns inside each ``solve`` span) on the anchored clock, between
    the window's two anchors.  Each idle piece goes to the deepest span
    that holds it, ``host.outside_solve`` where no span does."""
    spans = window["spans"]
    a0 = window["anchors"][0]["host_ns"]
    a1 = window["anchors"][-1]["host_ns"]
    busy = _union([(d["start_ns"], d["end_ns"]) for d in window["device"]])
    starts = [b[0] for b in busy]
    gaps, t = [], a0
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, a1)))
        t = max(t, e)
    if t < a1:
        gaps.append((t, a1))
    kids = {}
    for i, sp in enumerate(spans):
        kids.setdefault(sp["parent"], []).append(i)
    by_name = {}

    def attribute(parent, name, s, e):
        """Charge [s, e] to the children of `parent` it overlaps, the rest
        to `name`."""
        inside = 0.0
        for k in kids.get(parent, ()):
            sp = spans[k]
            cs, ce = max(s, sp["start_ns"]), min(e, sp["end_ns"] or a1)
            if ce > cs:
                attribute(k, "host." + sp["name"], cs, ce)
                inside += ce - cs
        by_name[name] = by_name.get(name, 0.0) + (e - s) - inside

    roots = kids.get(None, [])
    root_starts = [spans[i]["start_ns"] for i in roots]
    for s, e in gaps:
        # the root spans that can overlap [s, e] (roots do not overlap)
        j = max(bisect.bisect_right(root_starts, s) - 1, 0)
        k = bisect.bisect_left(root_starts, e)
        kids[-1] = roots[j:k + 1]
        attribute(-1, "host.outside_solve", s, e)
    idle = [(sp["end_ns"] - sp["start_ns"])
            - _covered(busy, starts, sp["start_ns"], sp["end_ns"])
            for sp in spans if sp["name"] == "solve" and sp["end_ns"]]
    gaps_s = sorted(((k, v / 1e9) for k, v in by_name.items() if v > 0),
                    key=lambda kv: -kv[1])
    return gaps_s, idle


def rhs_report(record: dict, window: dict, levels: list, amg: dict,
               peak: float) -> dict:
    done = [r for r in record["requests"] if r["ok"]]
    iters = sum(r["iterations"] for r in done)
    pass_ms = sum(sum(r["pass_ms"]) for r in done)
    split = device_split(window["stamps"], pass_ms)
    lb = level_bytes(levels, amg)
    lv = split["levels_ns"]
    gaps, idle = idle_gaps(window) if window["anchors"] else (None, [])
    ops = {}
    for d in window["device"]:
        ops[d["name"]] = ops.get(d["name"], 0.0) + d["ms"] / 1e3
    device_ops = [[f"level[{l}]", ns / 1e9] for l, ns in enumerate(lv)]
    device_ops += [["krylov", split["krylov_ns"] / 1e9],
                   ["pass.start_finish_guard", split["remainder_ns"] / 1e9]]
    device_ops += [[k, v] for k, v in sorted(ops.items())
                   if k != "pass_graph"]
    return {
        "metrics": {
            "fine_cycle_roofline_pct": 100.0 * lb[0] * split["cycles"]
            / peak / (lv[0] / 1e9) if lv and lv[0] else None,
            "coarse_cycle_ms_per_iter": sum(lv[1:]) / 1e6 / iters,
            "krylov_ms_per_iter": split["krylov_ns"] / 1e6 / iters,
            "solve_host_idle_ms": statistics.fmean(idle) / 1e6
            if idle else None},
        "split": split, "level_bytes": lb,
        "level_ms_per_iter": [ns / 1e6 / iters for ns in lv],
        "level_roofline_pct": [100.0 * b * split["cycles"] / peak
                               / (ns / 1e9) if ns else None
                               for b, ns in zip(lb, lv)],
        "breakdown": {"device_ops": device_ops, "idle_gaps": gaps},
        "host_spans": _totals(window["spans"], len(done)),
        "solves": len(done), "iterations": iters,
        "anchors": window["anchors"]}


def _totals(spans: list, per: int) -> dict:
    from sparsh_amg_tpu_torch.utils.trace import span_totals
    return {k: {"count": v["count"], "s": v["ns"] / 1e9 / per,
                "self_s": v["self_ns"] / 1e9 / per}
            for k, v in sorted(span_totals(spans).items())}


def resetup_report(record: dict, window: dict) -> dict:
    from sparsh_amg_tpu_torch.utils.trace import span_totals
    done = [r for r in record["requests"] if r["ok"]]
    n = len(done)
    tot = span_totals(window["spans"])

    def mean_s(*names):
        return sum(tot.get(k, {"ns": 0})["ns"] for k in names) / 1e9 / n

    spans = window["spans"]
    by_level = {}
    for i, s in enumerate(spans):
        if s["name"] != "setup.level":
            continue
        lev = by_level.setdefault(s["attrs"]["level"], {})
        lev["level"] = lev.get("level", 0.0) + (s["end_ns"] - s["start_ns"])
        for c in spans:
            if c["parent"] == i:
                lev[c["name"]] = lev.get(c["name"], 0.0) \
                    + (c["end_ns"] - c["start_ns"])
    bench = {k: statistics.fmean(r["spans"][k] for r in done)
             for k in ("host_setup", "freeze", "warm")}
    return {
        "metrics": {
            "setup_prolongator_s": mean_s(*PHASES["prolongator"]),
            "setup_rap_s": mean_s(*PHASES["rap"]),
            "freeze_pack_s": mean_s("freeze") - mean_s("freeze.upload"),
            "freeze_upload_s": mean_s("freeze.upload")},
        "against_benchmark_spans": {
            "setup.reorder+setup": mean_s("setup.reorder", "setup"),
            "host_setup_s": bench["host_setup"],
            "freeze": mean_s("freeze"), "freeze_s": bench["freeze"],
            "warm": mean_s("warm"), "warm_s": bench["warm"]},
        "by_level_s": {lv: {k: v / 1e9 / n for k, v in d.items()}
                       for lv, d in sorted(by_level.items())},
        "host_spans": _totals(spans, n),
        "counters": {k: v / n for k, v in window["counters"].items()},
        "requests": n}


def blocked_setup_report(setup: dict) -> dict:
    """A rank's process-local set-up from its trace: the blocked setup by
    level (its rows and nnz of the level), the gathered tail, the freeze,
    and the bytes its set-up exchanges sent."""
    spans = setup["spans"]
    s = lambda sp: (sp["end_ns"] - sp["start_ns"]) / 1e9
    out = {"levels": [dict(sp["attrs"], s=s(sp)) for sp in spans
                      if sp["name"] == "setup.blocked.level"]}
    for name in ("setup.blocked", "setup.blocked.tail", "freeze.dist",
                 "warm"):
        got = [s(sp) for sp in spans if sp["name"] == name and sp["end_ns"]]
        if got:
            out[name] = sum(got)
    out["counters"] = setup["counters"]
    return out


def run_ranks(spec: dict, seed: int, seconds: float, device: str) -> dict:
    """A cell of rank processes (``rhs_stream_ranks``): each rank traces
    itself (the mix's ``trace_dir``) and writes its set-up and window;
    each rank's window is taken apart as an rhs cell's, on its own block
    levels at one card's rate."""
    import tempfile
    from amgbench import harness
    from amgbench.work import peak_bytes_per_s
    import torch
    with tempfile.TemporaryDirectory(prefix="trace_ranks_") as tmp:
        spec = dict(spec, traffic=dict(spec["traffic"], trace_dir=tmp))
        result, record = harness.run_cell(spec, seed, seconds, True, device,
                                          T_START)
        files = sorted(f for f in os.listdir(tmp) if f.startswith("rank"))
        ranks = []
        for f in files:
            with open(os.path.join(tmp, f)) as fh:
                ranks.append(json.load(fh))
    peak = peak_bytes_per_s(torch.cuda.get_device_name()) \
        if device == "cuda" else 3.35e12
    end_to_end = harness.read_metrics(spec["end_to_end"], record)
    out = {"ranks": []}
    for r in ranks:
        rep = rhs_report({"requests": r["requests"]}, r["window"],
                         r["levels"] + r["tail"], spec["config"]["amg"],
                         peak)
        rep["rank"] = r["rank"]
        rep["setup"] = blocked_setup_report(r["setup"])
        out["ranks"].append(rep)
    out["end_to_end"] = {k: v["value"] for k, v in end_to_end.items()}
    result["trace"] = out
    return result


def run(spec: dict, seed: int, seconds: float, device: str = "cuda") -> dict:
    """The cell `spec` (``harness.load_cell``) run with the tracer on: the
    harness's result with the tracer's findings under ``trace``."""
    if spec["traffic"]["kind"] == "rhs_stream_ranks":
        return run_ranks(spec, seed, seconds, device)
    from amgbench import harness
    from amgbench.work import levels_of, peak_bytes_per_s
    from sparsh_amg_tpu_torch.utils import trace
    import torch
    got = {}
    load = harness.load_module

    def traced_load(path, name):
        mod = load(path, name)
        # the cell's own kind alone: a kind built on another (one that
        # loads rhs_stream and calls its window) is traced once
        if name != "amgbench_traffic_" + spec["traffic"]["kind"]:
            return mod
        prepare, window = mod.prepare, mod.window

        def traced_prepare(run):
            prepare(run)
            if getattr(run, "solver", None) is not None:
                got["levels"] = levels_of(run.solver.hierarchy)

        def traced_window(run, seconds):
            run.sync()
            got["setup"] = trace.export()
            trace.reset()
            trace.anchor()
            window(run, seconds)
            trace.anchor()
            got["window"] = trace.export()
        mod.prepare, mod.window = traced_prepare, traced_window
        return mod

    harness.load_module = traced_load
    trace.enable()
    try:
        result, record = harness.run_cell(spec, seed, seconds, True, device,
                                          T_START)
    finally:
        trace.disable()
        harness.load_module = load
    window = got["window"]
    end_to_end = harness.read_metrics(spec["end_to_end"], record)
    if "levels" in got:
        peak = peak_bytes_per_s(torch.cuda.get_device_name()) \
            if device == "cuda" else 3.35e12
        out = rhs_report(record, window, got["levels"], spec["config"]["amg"],
                         peak)
    else:
        out = resetup_report(record, window)
    out["setup_trace"] = {"host_spans": _totals(got["setup"]["spans"], 1),
                          "counters": got["setup"]["counters"]}
    out["end_to_end"] = {k: v["value"] for k, v in end_to_end.items()}
    result["trace"] = out
    return result


def resolution(reps: int = 200) -> dict:
    """Back-to-back stamps, eagerly and inside one captured graph: the
    smallest nonzero and the median delta of the global timer (ns)."""
    import torch
    from sparsh_amg_tpu_torch.utils import trace
    dev = torch.device("cuda")
    S = trace.STAMP_SLOTS
    buf = torch.zeros(2 * S + 1, dtype=torch.int64, device=dev)
    out = {}
    for how in ("eager", "graph"):
        def burst():
            trace.trace_stamp(buf, 0, True)
            for k in range(S):
                trace.trace_stamp(buf, k, False)
        burst()
        graph = None
        if how == "graph":
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                burst()
        deltas = []
        for _ in range(reps // 10):
            buf.zero_()
            if graph is None:
                burst()
            else:
                graph.replay()
            torch.cuda.synchronize()
            deltas += buf[:S].tolist()
        nz = [d for d in deltas if d > 0]
        out[how] = {"stamps": len(deltas), "zero": len(deltas) - len(nz),
                    "min_nonzero_ns": min(nz) if nz else None,
                    "median_ns": statistics.median(deltas),
                    "distinct_ns": sorted(set(deltas))[:12]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--resolution", action="store_true")
    args = ap.parse_args(argv)
    if sys.path[0] != ROOT:
        sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("torch_trace_cell: needs a CUDA card", file=sys.stderr)
        return 2
    if args.resolution:
        out = {"resolution": resolution()}
    else:
        if args.workload is None or args.seed is None:
            ap.error("--workload and --seed are needed")
        from amgbench import harness
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
        out = run(harness.load_cell(bench, args.workload), args.seed,
                  args.seconds)
    out["card"] = torch.cuda.get_device_name()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
