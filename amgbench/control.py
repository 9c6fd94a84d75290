#!/usr/bin/env python3
"""The control of the benchmark's check: the program with its own
lower-precision path switched on, which ``correct`` has to reject.

    python3 amgbench/control.py --workload CELL --seeds N [N ...] --seconds S

The configurations state fp64 accuracy (tol 1e-8, reached through fp64
iterative refinement around fp32 Krylov passes); the nearest precision
below is fp32 alone, the port's ``KrylovParams.refine = False``: one fp32
pass to tol.  Each seed runs the cell as ``run.py`` does, at its own
size, with that one field changed, and prints a JSON line with the seed,
``correct`` and the compared numbers.  The benchmark's own runs never
run it.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lower_precision(spec: dict) -> dict:
    """The cell with the program's fp32-only path switched on."""
    spec = copy.deepcopy(spec)
    spec["config"]["krylov"]["refine"] = False
    return spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from amgbench import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    spec = lower_precision(harness.load_cell(bench, args.workload))
    for seed in args.seeds:
        result, _ = harness.run_cell(spec, seed, args.seconds, False)
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "failed": result["failed"],
                          "compared": result["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
