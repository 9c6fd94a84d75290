"""Shared pieces of the tests of the benchmark's four-rank cell
``p3d304x4.rhs`` (traffic kind ``rhs_stream_ranks``) on the CPU: the cell
cut to poisson3d(24) on four gloo ranks of one thread each."""
from __future__ import annotations

import copy
import json
import os

from amgbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "amgbench")
CELL = "p3d304x4.rhs"
N = 24


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def small_spec() -> dict:
    """The cell at poisson3d(24): no cache, levels replicated below 600
    rows and dense below 64, a short iteration budget, one thread a
    rank."""
    spec = copy.deepcopy(harness.load_cell(load_bench(), CELL))
    cfg = spec["config"]
    cfg["size"] = {"n": N}
    cfg["cache"] = False
    cfg["amg"].update(dense_size=64, replicate_size=600, coarse_size=64)
    cfg["krylov"]["maxiter"] = 60
    spec["traffic"]["threads"] = 1
    return spec


def traffic_kind(bench_dir: str = BENCH_DIR):
    return harness.load_module(
        os.path.join(bench_dir, "traffic", "rhs_stream_ranks.py"),
        "amgbench_traffic_rhs_stream_ranks")
