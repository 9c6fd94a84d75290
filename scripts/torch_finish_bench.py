#!/usr/bin/env python3
"""Time the refinement pass's fp64 finish on one GPU: the kernel
(``ops/fp64.py::dia_finish64``, ``csrc/dia_finish64.cu``) against its
plain composition (``finish64_plain`` and the copies into the loop's
buffers, the finish graph before the kernel).

    python3 scripts/torch_finish_bench.py

The tables are the fine operators of two main paths in fp64: the flagship
poisson3d(192)'s (7 bands, 7,077,888 rows) and elasticity2d(512)'s (21
bands, 525,312 rows), made from the matrices with scipy.  Each runs
chip_smoke.py's ``finish_case``: x64 and the fp32 rhs with the plain
version's bits, ||r||^2 within 1e-13 relative, two launches with the same
bits, and both sides timed as CUDA graph replays (``graph_ms``) beside the
byte bound.  Then one call of each side under torch.profiler: the kernels
it launches.  One JSON line per case.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernels_launched(fn):
    """{kernel name: launches} the profiler sees on the card during fn()."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = {}
    for e in prof.events():
        if getattr(e.device_type, "name", "") == "CUDA":
            seen[e.name[:60]] = seen.get(e.name[:60], 0) + 1
    return seen


def main():
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smoke = _load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    dia = _load("torch_dia_bench",
                os.path.join(HERE, "scripts", "torch_dia_bench.py"))
    from sparsh_amg_tpu_torch import systems
    from sparsh_amg_tpu_torch.ops.formats import DiaMatrix
    from sparsh_amg_tpu_torch.ops.fp64 import dia_finish64, finish64_plain
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"gpu": gpu, "torch": torch.__version__}), flush=True)
    p3d, offs, n = dia.poisson3d_bands(192)
    e2d, e2d_offs, e2d_n = dia.band_table(systems.problem(2)[0])
    rng, results = np.random.default_rng(7), []
    for tag, bands, offsets, n_rows in (("p3d L0", p3d, offs, n),
                                        ("e2d L0", e2d, e2d_offs, e2d_n)):
        A64 = DiaMatrix(bands=torch.from_numpy(bands.astype(np.float64)
                                               ).cuda(),
                        offsets=offsets, n_rows=n_rows, n_cols=n_rows)
        rec = smoke.finish_case(tag, A64, rng, results, time_it=True,
                                n_rows=n_rows)
        m = A64.n_pad
        x64 = torch.zeros(m, dtype=torch.float64, device="cuda")
        b64 = torch.ones_like(x64)
        d = torch.ones(m, device="cuda")
        b = torch.empty(m, device="cuda")
        rr = torch.empty(1, dtype=torch.float64, device="cuda")

        def plain():
            x, r, s = finish64_plain(A64, x64, d, b64, torch.dot)
            x64.copy_(x)
            b.copy_(r)
            rr.copy_(s)
        print(json.dumps({
            "case": rec["case"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "real_MB": rec["real_bytes"] / 1e6,
            "padded_MB": rec["padded_bytes"] / 1e6,
            "kernel_launches": kernels_launched(
                lambda: dia_finish64(A64, x64, d, b64, b, rr)),
            "plain_launches": kernels_launched(plain)}), flush=True)
    from sparsh_amg_tpu_torch.utils.timing import copy_bandwidth
    print(json.dumps({"copy_bw_GBs": copy_bandwidth("cuda") / 1e9}),
          flush=True)


if __name__ == "__main__":
    main()
