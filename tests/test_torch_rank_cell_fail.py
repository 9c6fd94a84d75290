"""A rank of the benchmark's four-rank cell that raises in the middle of
the window: the run raises, naming a failed rank, and no rank process is
left, with the others stopped in whatever collective they waited in."""
from __future__ import annotations

import shutil
import subprocess

import pytest
from ranks_cell import BENCH_DIR, small_spec

from amgbench import harness

SOLVE = "        res = solver.solve(pool[j])\n"
RAISE = ("        if rank == 1 and i == 2:\n"
         "            raise RuntimeError('injected fault')\n")


def test_a_rank_that_raises_mid_window_stops_the_run(tmp_path):
    copy = tmp_path / "amgbench"
    shutil.copytree(BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    path = copy / "traffic" / "rhs_stream_ranks.py"
    src = path.read_text()
    assert src.count(SOLVE) == 1
    path.write_text(src.replace(SOLVE, RAISE + SOLVE))
    spec = small_spec()
    with pytest.raises(RuntimeError, match=r"rank \d of 4 failed"):
        harness.run_cell(spec, 2 ** 32 + 3, 30.0, False, "cpu",
                         bench_dir=str(copy))
    left = subprocess.run(["pgrep", "-f", str(path)], capture_output=True,
                          text=True).stdout
    assert left == "", left
