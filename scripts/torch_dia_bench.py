#!/usr/bin/env python3
"""Time the DIA kernel's cases on one GPU, for one checkout of the port.

    python3 scripts/torch_dia_bench.py [--root DIR]

The tables are the fine operators of the main paths: the flagship
poisson3d(192)'s (7 bands, 7,077,888 rows) with fp32 bands (the Krylov
matvec) and bf16 bands (the V-cycle), and elasticity2d(512)'s (21 bands,
525,312 rows, fp32).  They are made from the matrices with scipy (the
same values as `csr_to_dia`, without the native setup library), so every
checkout gets the same inputs.  Each table runs chip_smoke.py's
`dia_cases`: every tail against its plain version with the same
bits twice, device times (median of 25 launches queued behind a device
sleep, L2 flushed between launches when the table fits in L2), bound_ms
and a cuSPARSE library_ms for SPMV.  One JSON line per case.

The Chebyshev tails on a rank's block of the four-card cell's fine level
are timed by kernel_bench_torch.py (its ``_rank`` rows).

--root names the checkout whose ``sparsh_amg_tpu_torch`` is imported
(default: the one holding this script), so one call can time a parent
commit unpacked beside the tree, in turns with the tree.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """chip_smoke.py of this script's checkout (its kernel cases)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def band_table(A, pad_multiple=2048):
    """(bands (D, n_pad) float32, offsets, n): bands[d, i] = A[i, i + off_d],
    0 where i + off_d leaves the matrix, offsets ascending."""
    D = A.todia()
    n = A.shape[0]
    n_pad = -(-n // pad_multiple) * pad_multiple
    order = np.argsort(D.offsets)
    bands = np.zeros((len(order), n_pad), dtype=np.float32)
    for d, k in enumerate(order):
        off = int(D.offsets[k])
        lo, hi = max(0, -off), min(n, n - off)
        bands[d, lo:hi] = D.data[k, lo + off:hi + off]
    return bands, tuple(int(D.offsets[k]) for k in order), n


def poisson3d_bands(m, pad_multiple=2048):
    """band_table(poisson3d(m)) written out: the 7-point stencil's bands
    (6 on the diagonal, -1 towards each interior neighbour)."""
    n = m ** 3
    n_pad = -(-n // pad_multiple) * pad_multiple
    i = np.arange(n)
    ix, iy, iz = i % m, (i // m) % m, i // (m * m)
    offs = (-m * m, -m, -1, 0, 1, m, m * m)
    inside = (iz > 0, iy > 0, ix > 0, None, ix < m - 1, iy < m - 1,
              iz < m - 1)
    bands = np.zeros((7, n_pad), dtype=np.float32)
    for d, keep in enumerate(inside):
        bands[d, :n] = 6.0 if keep is None else np.where(keep, -1.0, 0.0)
    return bands, offs, n


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    smoke = _smoke()
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    import sparsh_amg_tpu_torch
    from sparsh_amg_tpu_torch import systems
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    assert sparsh_amg_tpu_torch.__file__.startswith(root), \
        sparsh_amg_tpu_torch.__file__
    if not hasattr(K, "instantiation"):   # an older checkout: one kernel
        K.instantiation = lambda bands, offsets: "one kernel"
    print(json.dumps({"root": root, "gpu": gpu}), flush=True)
    p3d, offs, n = poisson3d_bands(192)
    p3d = torch.from_numpy(p3d).cuda()
    e2d, e2d_offs, e2d_n = band_table(systems.problem(2)[0])
    rng, results = np.random.default_rng(7), []
    for tag, bands, offsets, n_rows in (
            ("p3d L0", p3d, offs, n),
            ("p3d L0", p3d.to(torch.bfloat16), offs, n),
            ("e2d L0", torch.from_numpy(e2d).cuda(), e2d_offs, e2d_n)):
        smoke.dia_cases(tag, bands, offsets, rng, results, time_it=True,
                        n_rows=n_rows)
    del p3d


if __name__ == "__main__":
    main()
