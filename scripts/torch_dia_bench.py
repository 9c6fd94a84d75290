#!/usr/bin/env python3
"""Time the DIA kernel's cases on one GPU, for one checkout of the port.

    python3 scripts/torch_dia_bench.py [--root DIR]

The tables are the fine operators of the main paths: the flagship
poisson3d(192)'s (7 bands, 7,077,888 rows) with fp32 bands (the Krylov
matvec) and bf16 bands (the V-cycle), and elasticity2d(512)'s (21 bands,
525,312 rows, fp32).  They are made from the matrices with scipy (the
same values as `csr_to_dia`, without the native setup library), so every
checkout gets the same inputs.  Each table runs chip_smoke.py's
`dia_cases`: all five tails against their plain versions with the same
bits twice, device times (median of 25 launches queued behind a device
sleep, L2 flushed between launches when the table fits in L2), bound_ms
and a cuSPARSE library_ms for SPMV.  One JSON line per case.

Then a rank's block of the four-card cell's fine level, poisson3d(304)
over four ranks (rank 1: 7,023,616 rows with both halos, bf16 bands): one
Chebyshev step as the checkout's smoother runs it on a ``DistDia``
(``cheb_step``: the local launch and the boundary launch; a checkout
without it: the SpMV and the plain tail), with the halos already
received, timed as CUDA graph replays beside the serial CHEB launch on
the same rows and the boundary launch alone.

--root names the checkout whose ``sparsh_amg_tpu_torch`` is imported
(default: the one holding this script), so one call can time a parent
commit unpacked beside the tree, in turns with the tree.
"""
import argparse
import dataclasses
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


def rank_block_case(smoke, m=304, ranks=4, rank=1):
    """One Chebyshev step on rank `rank`'s block of poisson3d(m) over
    `ranks` ranks, as the checkout's smoother runs it on a DistDia, its
    halos already received (no exchange), held to the plain step within
    chip_smoke.REL_TOL and timed as graph replays; beside it the serial
    CHEB launch on the block's rows and the boundary launch alone.  One
    JSON line."""
    import torch
    from sparsh_amg_tpu_torch.ops import counted
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    from sparsh_amg_tpu_torch.parallel.dist import DistDia, RankGroup
    from sparsh_amg_tpu_torch.utils.timing import graph_ms
    planes = m // ranks
    bands, offs = smoke.poisson3d_slab_bands(m, rank * planes,
                                             (rank + 1) * planes)
    n, h = bands.shape[1], m * m
    bands = torch.from_numpy(bands).cuda().to(torch.bfloat16)
    rng = np.random.default_rng(11)
    vec = lambda k: torch.from_numpy(
        rng.standard_normal(k).astype(np.float32)).cuda()
    x, d, r, left, right = vec(n), vec(n), vec(n), vec(h), vec(h)
    dinv = torch.full((n,), 1 / 6, device="cuda")
    a, c = 0.3, 0.9

    @dataclasses.dataclass(frozen=True)
    class Received(RankGroup):
        def halo_start(self, v, width):
            return lambda: (left, right)

    M = DistDia(bands=bands, offsets=offs, h=h, ranks=Received(rank, ranks),
                n_rows=m ** 3, n_cols=m ** 3)
    if hasattr(M, "cheb_step"):
        path = "fused"
        step = lambda: M.cheb_step(x, d, r, dinv, a, c)
    else:
        path = "spmv + plain tail"

        def step():
            r2 = r - dinv * M.spmv(d)
            return x + d, r2, a * d + c * r2
    got, launches = counted(step)
    r2 = r - dinv * M.spmv_plain(d)
    want = (x + d, r2, a * d + c * r2)
    err = max(((g - w).abs().max() / w.abs().max()).item()
              for g, w in zip(got, want))
    rec = {"case": f"p3d{m}x{ranks} rank {rank}/{ranks} L0 CHEB bf16, "
                   f"{n} rows", "path": path,
           "launches": {k: v for k, v in launches.items() if v},
           "rel_err_vs_plain": err,
           "ms": graph_ms(step),
           "serial_ms": graph_ms(
               lambda: K.dia_cheb_step(bands, x, d, r, dinv, a, c, offs)),
           # bands, d, r, dinv, x read; x', r', d' written
           "bound_ms": (2 * 7 * n + 4 * 7 * n) / 3.35e12 * 1e3}
    if hasattr(K, "dia_fused_boundary"):
        outs = [torch.empty(n, device="cuda") for _ in range(3)]
        rec["boundary_ms"] = graph_ms(lambda: K.dia_fused_boundary(
            K.CHEB, bands, offs, d, left, right, outs, True, True, b=r,
            dinv=dinv, x=x, s0=a, s1=c))
    print(json.dumps(rec), flush=True)
    if not err <= smoke.REL_TOL:
        raise AssertionError(f"{rec['case']}: rel err {err:.3e} against "
                             f"the plain step")


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
    rank_block_case(smoke)


if __name__ == "__main__":
    main()
