#!/usr/bin/env python3
"""Run one cell of the benchmark of ``sparsh_amg_tpu_torch``.

    python3 amgbench/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout.  Loads the cell's configuration and traffic
mix from ``BENCHMARK.json`` by name, makes the inputs from ``--seed``,
runs the port's set-up and warm-up, measures for ``--seconds``, checks
the window's answers against the plain reference and prints one JSON
line last on standard output: the cell's ``end_to_end`` metrics with
``--trace 0``, its ``per_layer`` metrics with ``--trace 1``.  Each
number compared is printed beside its limit as the last lines of
standard error and under ``compared``, the line's last key.

Exits 2, printing no result, without a CUDA card, when the port is not
in this checkout, when the run used fewer cards than the cell's
``chips`` (``device.count``: the distinct cards on which the harness or
a rank of the traffic driver held memory in the window), when the cards
it reports are of more than one kind, or when JAX or the JAX package
was loaded by the time the window closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"amgbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    if sys.path[0] != ROOT:
        sys.path.insert(0, ROOT)
    from amgbench import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    spec = harness.load_cell(bench, args.workload)
    chips = int(spec["cell"]["chips"])
    import torch
    if not torch.cuda.is_available():
        return fail("torch sees no CUDA device")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell needs {chips} cards, torch sees "
                    f"{torch.cuda.device_count()}")
    try:
        import sparsh_amg_tpu_torch
    except ImportError as e:
        return fail(f"the port is not in this checkout ({e})")
    where = os.path.dirname(os.path.abspath(sparsh_amg_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        return fail(f"the port was imported from {where}, not from the "
                    f"checkout {ROOT}")
    try:
        result, record = harness.run_cell(spec, args.seed, args.seconds,
                                          bool(args.trace), "cuda", T_START)
    except harness.CardError as e:
        return fail(str(e))
    used = result["device"]["count"]
    if used < chips:
        return fail(f"the run used {used} card(s), the cell asks for "
                    f"{chips}")
    found = harness.jax_modules()
    if found:
        return fail(f"loaded after the window: {', '.join(found)}")
    print("amgbench: " + json.dumps(harness.summary(record)),
          file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
