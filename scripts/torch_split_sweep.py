#!/usr/bin/env python3
"""Device time of the ELL and block-ELL kernels under every split-row launch
shape (G lanes x S cluster blocks), at the shapes of the solves' levels.

    python3 scripts/torch_split_sweep.py [--configs e3d p3d e2d]

Builds the hierarchies of elasticity3d(40), the flagship poisson3d(192)
and elasticity2d(512) on the card, and for every ELL-T and block-ELL
operator of fewer than half the card's resident threads in rows (the only
ones the chooser may split) times the kernel's C entry at each (G, S) with G*S <=
256, queued behind a device sleep as chip_smoke.py times kernels (median
of 25 launches).  Every shape's output is held against G = S = 1's.  One
JSON line per operator, marking the shape ``split_rows.launch_shape``
picks.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RUNS = 25
SHAPES = [(g, s) for s in (1, 2, 4, 8) for g in (1, 2, 4, 8, 16, 32)
          if g * s <= 256 and (s == 1 or g == 32)]


def _ms(fn):
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    ev = []
    for _ in range(RUNS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def _launcher(M, x, y):
    """fn(g, s) launching M's kernel at that shape into y."""
    from sparsh_amg_tpu_torch import _build
    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = int(M.vals.dtype == torch.bfloat16)
    if hasattr(M, "bs"):
        return lambda g, s: _build.check(lib.block_ell_spmv_launch(
            bf16, M.bs, M.cols.data_ptr(), M.vals.data_ptr(),
            M.lens.data_ptr(), M.k, M.n_rows, M.n_pad, g, s, x.data_ptr(),
            y.data_ptr(), stream), "block_ell_spmv")
    return lambda g, s: _build.check(lib.ell_spmv_launch(
        bf16, M.cols.data_ptr(), M.vals.data_ptr(), M.lens.data_ptr(), M.k,
        M.n_rows, M.n_pad, g, s, x.data_ptr(), y.data_ptr(), stream),
        "ell_spmv")


def sweep(tag, M):
    from sparsh_amg_tpu_torch.ops.split_rows import launch_shape, limits
    if 2 * M.n_rows > limits(M.cols.device)[0]:
        return
    x = torch.randn(M.n_cols if not hasattr(M, "bs") else M.n_pad,
                    device="cuda")
    y = torch.empty(M.n_pad, device="cuda")
    ref = torch.empty_like(y)
    run = _launcher(M, x, ref)
    run(1, 1)
    torch.cuda.synchronize()
    launch = _launcher(M, x, y)
    times = {}
    for g, s in SHAPES:
        launch(g, s)
        torch.cuda.synchronize()
        err = ((y.double() - ref.double()).abs().max()
               / ref.double().abs().max().clamp_min(1e-30)).item()
        assert err <= 1e-5, (tag, g, s, err)
        times[f"{g}x{s}"] = _ms(lambda: launch(g, s))
    pick = "{}x{}".format(*launch_shape(M.n_rows, M.k, M.cols.device))
    best = min(times, key=times.get)
    print(json.dumps({"case": tag, "rows": M.n_rows, "k": M.k,
                      "dtype": str(M.vals.dtype).split(".")[1],
                      "pick": pick, "pick_ms": times[pick], "best": best,
                      "best_ms": times[best], "ms": times}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=["e3d", "p3d", "e2d"])
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    from sparsh_amg_tpu_torch import AMGSolver, flagship, systems
    from sparsh_amg_tpu_torch.models import poisson3d
    for cfg in args.configs:
        if cfg == "p3d":
            solver = AMGSolver(poisson3d(192), flagship.params(),
                               flagship.krylov(), device="cuda")
        else:
            dim = 3 if cfg == "e3d" else 2
            A, ns = systems.problem(dim)
            solver = AMGSolver(A, systems.params(dim), systems.krylov(),
                               nullspace=ns, device="cuda")
        for li, lev in enumerate(solver.device.levels):
            for f in ("A", "P", "R"):
                M = getattr(lev, f)
                if hasattr(M, "lens"):
                    sweep(f"{cfg} {f}{li}", M)
        del solver
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
