"""The port's tracer (``sparsh_amg_tpu_torch/utils/trace.py``): spans,
counters, device intervals and the step graph's level stamps.

The stamps run here in their plain version; the stamp kernel inside
captured graphs, and the anchors, are held on the card by
``tests/test_torch_gpu.py`` (``-k trace``)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from sparsh_amg_tpu_torch.models import poisson2d
from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
from sparsh_amg_tpu_torch.solve.solver import AMGSolver
from sparsh_amg_tpu_torch.utils import trace

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "sparsh_amg_tpu_torch")


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


def _solver(device="cpu", cycle="V", method="cg", **amg):
    A = poisson2d(32)
    p = AMGParams(coarse_size=40, cycle=cycle, **amg)
    s = AMGSolver(A, p, KrylovParams(method=method, loop_mode="device"),
                  device=device)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    return s, b


def _visits(n_levels: int, shape: str) -> list:
    """Visits of each level in one cycle of `shape`."""
    acc = [0] * n_levels

    def visit(l, shape):
        acc[l] += 1
        if l == n_levels - 1:
            return
        if shape == "V":
            visit(l + 1, "V")
        elif shape == "W":
            visit(l + 1, "W")
            visit(l + 1, "W")
        else:
            visit(l + 1, "F")
            visit(l + 1, "V")
    visit(0, shape)
    return acc


def _children(e: dict, i: int) -> list:
    return [s["name"] for s in e["spans"] if s["parent"] == i]


def test_off_records_nothing():
    """Off: one shared no-op context, no span, counter, device interval
    or stamp over a set-up and an eager solve, and no stamp launched."""
    trace.disable()
    trace.reset()
    assert trace.span("a") is trace.span("b", x=1)
    assert trace.stamping(torch.device("cpu")) is trace.span("c")
    before = trace.trace_stamp.launches
    s, b = _solver()
    res = s.solve(b)
    assert res.converged and res.iterations > 0
    e = trace.export()
    assert e["spans"] == [] and e["counters"] == {} and e["device"] == []
    trace.anchor()
    assert trace.export()["anchors"] == []
    assert e["stamps"] == {}
    assert trace.trace_stamp.launches == before
    with trace.timed("t") as t:
        sum(range(1000))
    assert t.seconds > 0 and trace.export()["spans"] == []


def test_spans_nest_with_self_time_requests_and_counters(tracing):
    """Spans keep their parent and a request id shared under one root;
    self time is the duration less the children's; counters add."""
    with trace.span("a", k=1):
        with trace.span("b"):
            trace.count("n")
            trace.count("n", 2)
        with trace.span("c") as c:
            c.set(x=3)
            with trace.timed("t") as t:
                sum(range(1000))
    with trace.span("d"):
        pass
    e = trace.export()
    assert [s["name"] for s in e["spans"]] == ["a", "b", "c", "t", "d"]
    assert [s["parent"] for s in e["spans"]] == [None, 0, 0, 2, None]
    req = [s["request"] for s in e["spans"]]
    assert req[:4] == [req[0]] * 4 and req[4] != req[0]
    assert e["spans"][0]["attrs"] == {"k": 1}
    assert e["spans"][2]["attrs"] == {"x": 3}
    assert e["counters"] == {"n": 3}
    sp = e["spans"][3]
    assert round(t.seconds * 1e9) == sp["end_ns"] - sp["start_ns"]
    tot = trace.span_totals(e["spans"])
    dur = {s["name"]: s["end_ns"] - s["start_ns"] for s in e["spans"]}
    assert tot["a"]["self_ns"] == dur["a"] - dur["b"] - dur["c"] >= 0
    assert tot["c"]["self_ns"] == dur["c"] - dur["t"]
    assert tot["d"] == {"count": 1, "ns": dur["d"], "self_ns": dur["d"]}
    trace.reset()
    assert trace.export()["spans"] == [] and trace.export()["counters"] == {}


def test_spanned_makes_each_call_a_span():
    """A ``spanned`` function returns what it returns, with tracing off
    as the plain function and no span; on, each call is one span, nested
    where it is called, with the attributes of its result."""
    @trace.spanned("f", lambda r: {"twice": 2 * r})
    def f(x, y=1):
        with trace.span("inner"):
            return x + y

    assert f.__name__ == "f"
    trace.disable()
    trace.reset()
    assert f(2, y=3) == 5 and trace.export()["spans"] == []
    trace.enable()
    try:
        with trace.span("outer"):
            assert f(1) == 2
        e = trace.export()
    finally:
        trace.disable()
        trace.reset()
    assert [(s["name"], s["parent"]) for s in e["spans"]] == [
        ("outer", None), ("f", 0), ("inner", 1)]
    assert e["spans"][1]["attrs"] == {"twice": 4}


@pytest.mark.parametrize("cycle,method", [("V", "cg"), ("W", "cg"),
                                          ("F", "cg"), ("V", "bicgstab")])
def test_eager_stamps_count_each_level_visit(tracing, cycle, method):
    """An eager device-mode solve: each slot counts the iterations times
    its visits a step (two cycles a BiCGStab step), the stamped time is at
    most the passes' and the solve's spans hold the passes."""
    s, b = _solver(cycle=cycle, method=method)
    trace.reset()
    res = s.solve(b)
    assert res.converged
    e = trace.export()
    L = len(s.device.levels)
    per_step = 2 if method == "bicgstab" else 1
    steps = res.iterations
    want = {"step.end": steps}
    for l, v in enumerate(_visits(L, cycle)):
        want[f"enter[{l}]"] = want[f"leave[{l}]"] = v * steps * per_step
    assert {k: v["count"] for k, v in e["stamps"].items()} == want
    tot = trace.span_totals(e["spans"])
    stamped = sum(v["ns"] for v in e["stamps"].values())
    assert 0 < stamped <= tot["solve.pass"]["ns"]
    assert tot["solve.pass"]["count"] == res.refine_passes
    root = e["spans"][0]
    assert root["name"] == "solve" and root["attrs"] == {
        "passes": res.refine_passes, "iterations": res.iterations}
    assert set(_children(e, 0)) == {"solve.prologue", "solve.pass",
                                    "solve.epilogue"}


@pytest.mark.parametrize("case", ["rs", "flagship", "composed", "sa"])
def test_setup_spans_by_level(tracing, monkeypatch, case):
    """amg_setup: one ``setup.level`` a coarsening step, each with its
    strength, coarsening, interpolation, transpose and RAP spans and the
    level's rows and nnz; ``setup.rap_products`` counts every Galerkin
    call, ``setup.rap_discarded`` the throwaway ones rebuilt."""
    from sparsh_amg_tpu_torch import flagship
    from sparsh_amg_tpu_torch.models.elasticity import (
        elasticity2d, elasticity2d_nullspace)
    from sparsh_amg_tpu_torch.setup import hierarchy as H
    from sparsh_amg_tpu_torch.setup.reorder import maybe_reorder
    ns = None
    A = poisson2d(48)
    if case == "rs":
        p = AMGParams(coarse_size=40)
    elif case == "flagship":
        p = dataclasses.replace(flagship.params(dense_size=64),
                                coarse_size=40)
    elif case == "composed":
        # the first coarse level is below coarse_size: no second round, so
        # the hard-filtered intermediate product is rebuilt
        p = AMGParams(coarse_size=1500, coarsening="pmis", agg_levels=1,
                      interp_max_composed=5, intermediate_drop_tol=0.02)
    else:
        A, ns = elasticity2d(24), elasticity2d_nullspace(24)
        p = AMGParams(coarse_size=40, coarsening="aggregation",
                      interpolation="smoothed", agg_blocksize=2)
    calls = []
    real = H.galerkin_product
    monkeypatch.setattr(H, "galerkin_product",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    A, _ = maybe_reorder(A, "auto")
    h = H.amg_setup(A, p, nullspace=ns)
    e = trace.export()
    names = [s["name"] for s in e["spans"]]
    assert names[0] == "setup.reorder" and e["spans"][0]["parent"] is None
    root = names.index("setup")
    assert e["spans"][root]["parent"] is None
    levels = [i for i, s in enumerate(e["spans"])
              if s["name"] == "setup.level"]
    assert len(levels) == h.n_levels - 1 >= 1
    for li, i in enumerate(levels):
        sp = e["spans"][i]
        assert sp["parent"] == root
        assert sp["attrs"] == {"level": li, "rows": h.levels[li].n,
                               "nnz": h.levels[li].nnz}
        assert {"setup.strength", "setup.coarsen", "setup.interp",
                "setup.transpose", "setup.rap"} <= set(_children(e, i))
    assert e["counters"]["setup.rap_products"] == len(calls) >= len(levels)
    assert e["counters"].get("setup.rap_discarded", 0) \
        == (1 if case == "composed" else 0)


@pytest.mark.parametrize("prefer_dia", [False, True])
def test_freeze_spans_and_upload_bytes(tracing, prefer_dia):
    """The freeze: ``freeze.fine`` then one ``freeze.level`` a level, and
    ``freeze.upload_bytes`` the bytes of every tensor it uploaded: all of
    the hierarchy's and the fp64 operator's, less what the card casts (the
    fine band_dtype operator of a DIA level is cast from the Krylov one)."""
    from sparsh_amg_tpu_torch.ops.formats import DiaMatrix
    from sparsh_amg_tpu_torch.utils.meminfo import tree_device_bytes
    s, _ = _solver(prefer_dia=prefer_dia, dense_size=64)
    e = trace.export()
    tot = trace.span_totals(e["spans"])
    assert tot["freeze"]["count"] == 1 and tot["freeze.fine"]["count"] == 1
    assert tot["freeze.level"]["count"] == len(s.device.levels)
    assert tot["freeze.upload"]["ns"] <= tot["freeze"]["ns"]
    fine = s.device.levels[0].A
    cast = fine.bands.numel() * fine.bands.element_size() \
        if isinstance(fine, DiaMatrix) else 0
    assert isinstance(fine, DiaMatrix) == prefer_dia
    assert e["counters"]["freeze.upload_bytes"] \
        == tree_device_bytes((s.device, s.A64)) - cast


def test_setup_profile_variable_and_timer_are_gone():
    """Nothing in the port reads SPARSH_SETUP_PROFILE, and utils/timing.py
    has no phase timer: the tracer's spans replace both."""
    from sparsh_amg_tpu_torch.utils import timing
    found = []
    for d, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith((".py", ".cpp", ".cu", ".cuh")):
                with open(os.path.join(d, f)) as fh:
                    if "SPARSH_SETUP_PROFILE" in fh.read():
                        found.append(f)
    assert found == [] and not hasattr(timing, "Timer")


def test_stamp_plain_version_and_bad_slots():
    """The plain stamp adds the time since the last stamp to its slot and
    1 to its count; a reset stamp only sets the time; slots outside the
    buffer raise."""
    S = 4
    buf = torch.zeros(2 * S + 1, dtype=torch.int64)
    trace.trace_stamp(buf, 0, True)
    t0 = int(buf[2 * S])
    trace.trace_stamp(buf, 2, False)
    trace.trace_stamp(buf, 2, False)
    assert buf[S + 2] == 2 and buf[:S].sum() == buf[2] == buf[2 * S] - t0
    assert buf[S + 0] == 0
    for bad in (-1, S):
        with pytest.raises(ValueError):
            trace.trace_stamp(buf, bad, False)


# --------------------------------------------------------------------------
# scripts/torch_trace_cell.py: a benchmark cell run with the tracer on
# --------------------------------------------------------------------------

ROOT = os.path.dirname(PACKAGE)


def _load(path: str, name: str):
    import importlib.util
    import sys
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cell_tool():
    return _load(os.path.join(ROOT, "scripts", "torch_trace_cell.py"),
                 "torch_trace_cell")


def test_idle_gaps_go_to_the_innermost_span(cell_tool):
    """Idle device time between two anchors goes to the deepest span that
    holds each piece, outside every span to ``host.outside_solve``; the
    host idle time of each solve is its span less the device's busy
    time inside it."""
    sp = [("solve", 10, 100, None), ("solve.pass", 20, 50, 0),
          ("solve.launch", 20, 25, 1), ("solve.read", 25, 50, 1),
          ("solve.pass", 60, 90, 0), ("solve", 110, 150, None)]
    window = {"spans": [{"name": n, "start_ns": s, "end_ns": e,
                         "parent": p} for n, s, e, p in sp],
              "device": [{"start_ns": s, "end_ns": e}
                         for s, e in ((22, 48), (65, 88), (115, 140))],
              "anchors": [{"host_ns": 0}, {"host_ns": 160}]}
    gaps, idle = cell_tool.idle_gaps(window)
    got = {k: round(v * 1e9) for k, v in gaps}
    assert got == {"host.solve": 45, "host.outside_solve": 30,
                   "host.solve.pass": 7, "host.solve.launch": 2,
                   "host.solve.read": 2}
    assert idle == [41, 15]


@pytest.mark.parametrize("config", ["poisson3d-192", "elasticity3d-40"])
def test_level_bytes_add_up_to_the_benchmarks_cycle(cell_tool, config):
    """The per-level bytes of one cycle sum to the cycle that
    ``amgbench/work.py`` prices an iteration with."""
    from amgbench import harness
    from amgbench.work import VALUE_BYTES, levels_of, solve_bytes, spmv_bytes
    from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
    cfg = harness.load_json(os.path.join(ROOT, "amgbench", "configs",
                                         config + ".json"))
    cfg["size"] = {"n": 12} if config.startswith("poisson") else {"m": 4}
    cfg["cache"] = False
    A, ns = harness.build_problem(cfg)
    amg = dict(cfg["amg"], dense_size=64, coarse_size=40)
    levels = levels_of(amg_setup(A, AMGParams(**amg), nullspace=ns))
    assert len(levels) >= 2
    per = cell_tool.level_bytes(levels, amg)
    work = solve_bytes(levels, amg, cfg["krylov"])
    mv = spmv_bytes(levels[0]["nnz"], levels[0]["n"], levels[0]["n"],
                    VALUE_BYTES[amg["dtype"]])
    assert sum(per) == pytest.approx(work["iteration"] - mv, rel=1e-12)


def _stamps(L: int) -> dict:
    """Stamp slots of a step on `L` levels, as ``trace.export()`` gives
    them: slot k holds (k + 1) * 1000 ns over 10 counts."""
    names = [f"enter[{l}]" for l in range(L)] \
        + [f"leave[{l}]" for l in range(L)] + ["step.end"]
    return {k: {"ns": (i + 1) * 1000, "count": 10}
            for i, k in enumerate(names)}


@pytest.mark.parametrize("L", [2, 4])
def test_device_split_parts_add_up_to_the_pass_time(cell_tool, L):
    """Each level takes the delta that ends at the next level's entry and
    the one that ends at its own return (the coarsest level its return
    alone), the Krylov work the deltas ending at ``enter[0]`` and
    ``step.end``; with the remainder they make the pass graphs' time."""
    st = _stamps(L)
    ns = {k: v["ns"] for k, v in st.items()}
    got = cell_tool.device_split(st, pass_ms=1.0)
    want = [ns[f"enter[{l + 1}]"] + ns[f"leave[{l}]"] for l in range(L - 1)]
    assert got["levels_ns"] == want + [ns[f"leave[{L - 1}]"]]
    assert got["krylov_ns"] == ns["enter[0]"] + ns["step.end"]
    assert got["cycles"] == 10
    assert sum(got["levels_ns"]) + got["krylov_ns"] == got["stamped_ns"]
    assert got["stamped_ns"] + got["remainder_ns"] == got["pass_ns"] == 1e6


def test_rhs_report_reads_a_synthetic_window(cell_tool):
    """The four rhs quantities from a record and a window made by hand."""
    from amgbench import harness
    cfg = harness.load_json(os.path.join(ROOT, "amgbench", "configs",
                                         "poisson3d-192.json"))
    amg = cfg["amg"]
    levels = [{"n": 1000, "nnz": 6400, "P": (1000, 120, 1500),
               "R": (120, 1000, 1500)},
              {"n": 120, "nnz": 1800, "P": (120, 20, 200),
               "R": (20, 120, 200)},
              {"n": 20, "nnz": 300, "P": None, "R": None}]
    record = {"requests": [{"ok": True, "iterations": 6, "pass_ms": [0.4]},
                           {"ok": True, "iterations": 4, "pass_ms": [0.2]},
                           {"ok": False, "iterations": 99,
                            "pass_ms": [9.0]}]}
    spans = [{"name": "solve", "start_ns": 100, "end_ns": 1100,
              "parent": None}]
    window = {"stamps": _stamps(3), "spans": spans, "counters": {},
              "device": [{"name": "pass_graph", "ms": 0.0006,
                          "start_ns": 200, "end_ns": 800}],
              "anchors": [{"host_ns": 0, "bracket_ns": 10},
                          {"host_ns": 2000, "bracket_ns": 10}]}
    out = cell_tool.rhs_report(record, window, levels, amg, peak=1e12)
    m, split = out["metrics"], out["split"]
    assert split["pass_ns"] == pytest.approx(0.6e6)
    lv = split["levels_ns"]
    lb = cell_tool.level_bytes(levels, amg)
    assert m["fine_cycle_roofline_pct"] == pytest.approx(
        100 * lb[0] * 10 / 1e12 / (lv[0] / 1e9))
    assert m["coarse_cycle_ms_per_iter"] == pytest.approx(
        (lv[1] + lv[2]) / 1e6 / 10)
    assert m["krylov_ms_per_iter"] == pytest.approx(
        split["krylov_ns"] / 1e6 / 10)
    assert m["solve_host_idle_ms"] == pytest.approx(400 / 1e6)
    assert out["solves"] == 2 and out["iterations"] == 10


def test_resetup_report_reads_a_synthetic_window(cell_tool):
    """The four resetup quantities, and the in-program spans set beside
    the benchmark's own, from two requests made by hand."""
    sp = []

    def add(name, start, end, parent=None, **attrs):
        sp.append({"name": name, "start_ns": start, "end_ns": end,
                   "parent": parent, "request": 0, "attrs": attrs})
        return len(sp) - 1

    for r in range(2):
        t = r * 10 ** 9
        add("setup.reorder", t, t + 10)
        root = add("setup", t + 10, t + 1010)
        lev = add("setup.level", t + 20, t + 1000, root, level=0)
        for k, (name, d) in enumerate((("setup.strength", 100),
                                       ("setup.coarsen", 150),
                                       ("setup.interp", 200),
                                       ("setup.transpose", 50),
                                       ("setup.rap", 400))):
            add(name, t + 30 + 200 * k, t + 30 + 200 * k + d, lev)
        fr = add("freeze", t + 2000, t + 2600)
        add("freeze.upload", t + 2100, t + 2250, fr)
        add("warm", t + 3000, t + 3100)
    record = {"requests": [{"ok": True,
                            "spans": {"host_setup": 1010e-9,
                                      "freeze": 600e-9, "warm": 100e-9}}
                           for _ in range(2)]}
    window = {"spans": sp, "counters": {"setup.rap_products": 2}}
    out = cell_tool.resetup_report(record, window)
    m = out["metrics"]
    assert m["setup_prolongator_s"] == pytest.approx(450e-9)
    assert m["setup_rap_s"] == pytest.approx(450e-9)
    assert m["freeze_upload_s"] == pytest.approx(150e-9)
    assert m["freeze_pack_s"] == pytest.approx(450e-9)
    b = out["against_benchmark_spans"]
    assert b["setup.reorder+setup"] == pytest.approx(b["host_setup_s"])
    assert b["freeze"] == pytest.approx(b["freeze_s"])
    assert out["by_level_s"][0]["setup.rap"] == pytest.approx(400e-9)
    assert out["counters"] == {"setup.rap_products": 1.0}
