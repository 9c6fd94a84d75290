"""Shared pieces of the benchmark's CPU tests: the cells cut to a size a
test run holds, run on the CPU with the harness's look for a card
skipped."""
from __future__ import annotations

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from amgbench import harness  # noqa: E402

SMALL = {"poisson3d-192": {"n": 12}, "elasticity3d-40": {"m": 5}}


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def small_spec(workload: str, bench: dict | None = None) -> dict:
    """The cell at a test size: a small grid, no cache, dense levels
    below 64 rows, a short iteration budget."""
    spec = copy.deepcopy(harness.load_cell(bench or load_bench(), workload))
    cfg = spec["config"]
    cfg["size"] = dict(SMALL[cfg["name"]])
    cfg["cache"] = False
    cfg["amg"]["dense_size"] = 64
    cfg["krylov"]["maxiter"] = 60
    return spec


@pytest.fixture
def bench() -> dict:
    return load_bench()
