"""``scripts/torch_trace_cell.py`` run whole: a cell at a test size
through the harness with the port's tracer on.  The script wraps the
harness's loader and the traffic drivers, so it lives or dies with them;
it is deleted once the harness enables the tracer itself."""
from __future__ import annotations

import importlib.util
import os

import pytest
import torch
from conftest import ROOT, small_spec


def _tool():
    path = os.path.join(ROOT, "scripts", "torch_trace_cell.py")
    spec = importlib.util.spec_from_file_location("torch_trace_cell", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", ["p3d192.rhs", "e3d40.rhs",
                                  "e3d40.resetup"])
def test_trace_cell_runs_a_cell_on_the_cpu(cell):
    """The stamps split a rhs cell's steps by level (one cycle an
    iteration), and a resetup cell's in-program spans time what the
    benchmark's own spans time."""
    from sparsh_amg_tpu_torch.utils import trace
    # one thread: the rhs check keeps the first solve after each of 8
    # instants, so the window must hold several solves even when other
    # processes share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = _tool().run(small_spec(cell), 2 ** 33 + 7, 2.0, "cpu")
    finally:
        torch.set_num_threads(threads)
        trace.disable()
        trace.reset()
    assert out["correct"], {k: out[k]
                            for k in ("attempted", "failed", "compared")}
    tr = out["trace"]
    if cell.endswith(".rhs"):
        assert tr["split"]["cycles"] == tr["iterations"] > 0
        assert len(tr["level_ms_per_iter"]) == len(tr["level_bytes"]) >= 2
        assert tr["metrics"]["krylov_ms_per_iter"] > 0
        assert set(tr["host_spans"]) >= {"solve", "solve.pass"}
        assert "setup" in tr["setup_trace"]["host_spans"]
    else:
        m, b = tr["metrics"], tr["against_benchmark_spans"]
        assert b["setup.reorder+setup"] == pytest.approx(b["host_setup_s"],
                                                         rel=0.02)
        assert b["freeze"] == pytest.approx(b["freeze_s"], rel=0.02)
        assert m["freeze_pack_s"] + m["freeze_upload_s"] \
            == pytest.approx(b["freeze"], rel=1e-9)
        assert m["setup_prolongator_s"] > 0 and m["setup_rap_s"] > 0
        assert tr["counters"]["setup.rap_products"] >= 1
    assert out["trace"]["end_to_end"]["setup_s"] > 0
