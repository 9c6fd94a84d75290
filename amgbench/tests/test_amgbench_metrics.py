"""The metric readers' arithmetic on a fake run record."""
from __future__ import annotations

import os

import numpy as np
import pytest
from conftest import ROOT

from amgbench import harness

METRICS = os.path.join(ROOT, "amgbench", "metrics")


def read(name, record):
    return harness.load_module(os.path.join(METRICS, name + ".py"),
                               "m_" + name).read(record)


def solve(wall_s, iterations=12, passes=2, pass_ms=(9.0, 1.0), ok=True,
          spans=None):
    r = {"ok": ok, "wall_s": wall_s, "converged": ok,
         "iterations": iterations, "passes": passes, "host_reads": passes,
         "pass_ms": list(pass_ms)}
    if spans is not None:
        r["spans"] = spans
    return r


@pytest.fixture
def record():
    walls = [0.02] * 19 + [0.04]
    return {"setup_s": 12.5, "window_s": 0.5,
            "requests": [solve(w) for w in walls] + [
                {"ok": False, "wall_s": 0.1, "error": "x"}],
            "device_peak_bytes": 3 * 2 ** 30,
            "work": {"iteration": 1e9, "pass": 0.5e9},
            "peak_bytes_per_s": 2e12}


def test_window_means(record):
    assert read("solve_ms", record) == pytest.approx(1e3 * 0.5 / 20)
    assert read("resetup_s", record) == pytest.approx(0.5 / 20)
    assert read("iterations_per_solve", record) == 12
    assert read("host_reads_per_solve", record) == 2
    assert read("setup_s", record) == 12.5
    assert read("device_peak_gib", record) == 3.0


def test_p95_takes_every_request(record):
    walls = [r["wall_s"] for r in record["requests"]]
    assert read("solve_p95_ms", record) == pytest.approx(
        1e3 * np.percentile(walls, 95))
    assert read("solve_p95_ms", record) >= 40.0   # the failed request counts


def test_idle_and_roofline(record):
    busy = 20 * 0.010 + 0.0
    assert read("device_idle_pct", record) == pytest.approx(
        100 * (1 - busy / 0.5))
    need = 20 * (12 * 1e9 + 2 * 0.5e9)
    assert read("solve_roofline_pct", record) == pytest.approx(
        100 * need / 2e12 / 0.2)


def test_nothing_to_read_returns_nothing(record):
    for r in record["requests"]:
        r["pass_ms"] = []
    assert read("solve_roofline_pct", record) is None
    assert read("device_idle_pct", record) is None
    assert read("host_setup_s", record) is None
    record["peak_bytes_per_s"] = None
    assert read("solve_roofline_pct", record) is None
    record["requests"] = []
    assert read("solve_ms", record) is None
    assert read("solve_p95_ms", record) is None


def test_span_means():
    spans = [{"host_setup": 2.0, "freeze": 0.5, "warm": 0.25},
             {"host_setup": 3.0, "freeze": 1.5, "warm": 0.75}]
    record = {"requests": [solve(4.0, spans=s) for s in spans]
              + [{"ok": False, "wall_s": 1.0, "error": "x"}]}
    assert read("host_setup_s", record) == 2.5
    assert read("freeze_s", record) == 1.0
    assert read("warm_s", record) == 0.5


def test_read_metrics_leaves_out_what_has_nothing(record):
    metrics = [{"name": "solve_ms", "unit": "ms"},
               {"name": "host_setup_s", "unit": "s"}]
    out = harness.read_metrics(metrics, record)
    assert list(out) == ["solve_ms"]
    assert out["solve_ms"]["unit"] == "ms"
