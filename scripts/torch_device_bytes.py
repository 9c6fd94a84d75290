#!/usr/bin/env python3
"""Persistent device bytes of the ten bench lines' solvers, for one
checkout of the port.

    python3 scripts/torch_device_bytes.py [--root DIR] [--lines NAME ...]

For the flagship poisson3d(192), elasticity3d(40), elasticity2d(512) and
the seven configurations of configs.py at full size, builds the solver as
bench_torch.py does (RCM first where the configuration asks for it, the
host setup, the freeze onto the card) and prints one JSON line each:
``AMGSolver.device_bytes()`` and the bytes of its ELL operators (the
layout's stored tables; levels and the fp64/fp32 fine operators).  No
solve runs.

--root names the checkout whose ``sparsh_amg_tpu_torch`` is imported
(default: the one holding this script), so one call can compare a parent
commit unpacked beside the tree with the tree.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYSTEMS = {"elasticity3d": 3, "elasticity2d": 2}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--lines", nargs="+")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import sparsh_amg_tpu_torch
    from sparsh_amg_tpu_torch import AMGSolver, configs, flagship, systems
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.ops.formats import EllMatrix
    from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
    from sparsh_amg_tpu_torch.setup.reorder import maybe_reorder
    from sparsh_amg_tpu_torch.utils.meminfo import tree_device_bytes
    assert sparsh_amg_tpu_torch.__file__.startswith(root), \
        sparsh_amg_tpu_torch.__file__
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "gpu": gpu}), flush=True)
    lines = args.lines or ["flagship", *SYSTEMS, *configs.NAMES]
    for line in lines:
        t0 = time.perf_counter()
        ns = None
        if line == "flagship":
            A = poisson3d(192)
            params = flagship.params(2048).replace(aggressive="pmis2")
        elif line in SYSTEMS:
            A, ns = systems.problem(SYSTEMS[line])
            params = systems.params(SYSTEMS[line])
        else:
            A, params = configs.problem(line)[0], configs.params(line)
        A, perm = maybe_reorder(A.tocsr(), params.reorder)
        if ns is not None and perm is not None:
            ns = np.asarray(ns)[perm]
        solver = AMGSolver(A, params, hierarchy=amg_setup(A, params,
                                                          nullspace=ns),
                           device="cuda")
        ell = {}
        for li, lev in enumerate(solver.device.levels):
            for f in ("A", "P", "R", "L", "U"):
                M = getattr(lev, f, None)
                if isinstance(M, EllMatrix):
                    ell[f"{f}{li}"] = tree_device_bytes(M)
        for f, M in (("fp64_fine", solver.A64), ("fp32_fine", solver.A32)):
            if isinstance(M, EllMatrix):
                ell[f] = tree_device_bytes(M)
        print(json.dumps({"line": line, "device_bytes": solver.device_bytes(),
                          "ell_bytes": ell,
                          "s": time.perf_counter() - t0}), flush=True)
        del solver
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
