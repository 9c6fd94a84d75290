#!/usr/bin/env python3
"""Split the DIA kernel's device time into a fixed cost per launch and a
streaming rate, on one GPU.

    python3 scripts/torch_dia_sweep.py [--root DIR]

For three band layouts -- 3-D Poisson at 192^3 (7 bands, bf16 and fp32)
and 2-D elasticity at 512^2 (21 bands, fp32) -- it times SPMV and the
Chebyshev step on random tables of 2^17 to 2^23 rows with the layout's
offsets, L2 flushed before every launch (the device-time harness of
``sparsh_amg_tpu_torch/utils/timing.py``: median of 25 launches queued
behind a device sleep), and fits ms = fixed + bytes / rate over the
sizes.  One JSON line per layout and tail.  --root as in
torch_dia_bench.py; the harness always comes from this script's checkout.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (131072, 262144, 524288, 1048576, 2097152, 4194304, 8388608)
LAYOUTS = {
    "p3d(192)": (-36864, -192, -1, 0, 1, 192, 36864),
    "e2d(512)": (*range(-1027, -1020), *range(-3, 4), *range(1021, 1028)),
}


# vectors each tail reads or writes once: x, y; and x, d, r, dinv, and
# the three outputs of the Chebyshev step
VECTORS = {"spmv": 2, "cheb": 7}


def _timing():
    """utils/timing.py of this script's checkout, loaded by path (it
    imports nothing of the package), whichever checkout --root names."""
    spec = importlib.util.spec_from_file_location(
        "sparsh_timing", os.path.join(HERE, "sparsh_amg_tpu_torch", "utils",
                                      "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    root = os.path.abspath(ap.parse_args().root)
    timing = _timing()
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    flush = timing.l2_flush_buffer(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for layout, dt in (("p3d(192)", torch.bfloat16),
                       ("p3d(192)", torch.float32),
                       ("e2d(512)", torch.float32)):
        offs = LAYOUTS[layout]
        for tail in ("spmv", "cheb"):
            nvec = VECTORS[tail]
            sizes, times = [], []
            for n in ROWS:
                bands = torch.randn(len(offs), n, device="cuda",
                                    generator=gen).to(dt)
                x, d, r, dinv = (torch.randn(n, device="cuda", generator=gen)
                                 for _ in range(4))
                call = ((lambda: K.dia_spmv(bands, x, offs)) if tail == "spmv"
                        else (lambda: K.dia_cheb_step(bands, x, d, r, dinv,
                                                      0.3, 0.9, offs)))
                sizes.append(bands.nbytes + 4 * n * nvec)
                times.append(timing.timed_ms(call, flush=flush))
                del bands, x, d, r, dinv
            slope, fixed = np.polyfit(sizes, times, 1)
            print(json.dumps({
                "root": root, "gpu": gpu, "layout": layout,
                "bands": str(dt).split(".")[-1], "tail": tail, "rows": ROWS,
                "bytes": sizes, "ms": times, "fixed_ms": fixed,
                "TB_per_s": 1e-9 / slope}), flush=True)


if __name__ == "__main__":
    main()
