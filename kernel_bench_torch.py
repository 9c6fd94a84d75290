#!/usr/bin/env python3
"""Per-kernel benchmark of the PyTorch/CUDA port on one NVIDIA GPU: the
counterpart of ``kernel_bench.py`` for the port, on the flagship's
hierarchy (``flagship.py``; poisson3d(192), pmis2 by default).

    python3 kernel_bench_torch.py [--n 192] [--aggressive pmis2]
    python3 kernel_bench_torch.py --n 16 --device cpu   # rows and keys only

One JSON row per item: ``spmv_l<i>`` for each level operator (the
cycle's, in its layout: DIA, ELL-T or dense), ``P_l<i>``/``R_l<i>`` for
each ELL-T transfer, and ``vcycle`` for one full cycle.  On a DIA fine
level, a row for each tail of the Chebyshev smooth (``cheb_start_l0``,
``cheb_step_l0``, ``cheb_last_l0``; a trailing 0 in the name: the zero
start's) and for the smooth itself from a zero and a nonzero start
(``cheb_smooth0_l0``, ``cheb_smooth_l0``); on the card the same tails on
rank 1's block of the four-card cell's fine level, poisson3d(304) over
four ranks (``_rank`` rows: the local launch and the boundary launch,
halos received).  These rows add
``graph_ms`` (a launch replayed back to back in a CUDA graph),
``bound_ms`` (real bytes at the data sheet's rate) and
``launches_per_solve`` (fine-level rows: the wrapper's launches in one
flagship solve, both of its cases).  Each row has
``per_op_ms`` (device time: the median of launches between CUDA events,
queued behind a device sleep, L2 flushed before every launch where the
operands fit in L2; ``utils/timing.py``), ``nnz``, ``nnz_per_s``,
``bytes_per_op`` (real) and ``bytes_per_op_padded`` (``utils/
accounting.py``, real bytes as ``chip_smoke.py``'s bounds count them),
``hbm_frac`` (real bytes per second over the measured copy rate) and
``hbm_frac_spec`` (over the data sheet's).

The copy rate is probed before and after the rows and the larger reading
kept; if a row reads over 1.0 it is probed once more, and if a row still
reads over 1.0 the script prints ``implausible_copy_bw`` and exits 2 (no
kernel moves bytes faster than a copy).  The first line is the copy-rate
header with the card's name and power limit.  On ``--device cpu`` rows
are timed with ``perf_counter`` and every device number is null.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

CYCLE_RUNS = 5      # queued cycles: ~60 launches each must fit the sleep


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=192,
                    help="grid side (n^3 unknowns)")
    ap.add_argument("--aggressive", default="pmis2",
                    choices=["composed", "pmis2"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


# the Chebyshev smooth's tails: (row, wrapper, fp32 vectors read or
# written, reads the bands); a trailing 0: the zero start (x not read)
CHEB_TAILS = (("cheb_start", "dia_cheb_start", 5, True),
              ("cheb_start0", "dia_cheb_start", 4, False),
              ("cheb_step", "dia_cheb_step", 7, True),
              ("cheb_step0", "dia_cheb_step", 5, True),
              ("cheb_last", "dia_cheb_last", 5, True),
              ("cheb_last0", "dia_cheb_last", 4, True))


def cheb_calls(op, x, b, d, r, dinv, theta=1.0333, a=0.41, c=0.81):
    """{row: the tail's product on op}."""
    return {"cheb_start": lambda: op.cheb_start(x, b, dinv, theta),
            "cheb_start0": lambda: op.cheb_start(None, b, dinv, theta),
            "cheb_step": lambda: op.cheb_step(x, d, r, dinv, a, c),
            "cheb_step0": lambda: op.cheb_step(None, d, r, dinv, a, c),
            "cheb_last": lambda: op.cheb_last(x, d, r, dinv, a, c),
            "cheb_last0": lambda: op.cheb_last(None, d, r, dinv, a, c)}


def tail_bytes(op, rows, name):
    """Bytes a tail moves on `rows` rows of op: its bands and vectors."""
    nvec, bands = next((v, bd) for t, _, v, bd in CHEB_TAILS if t == name)
    band = op.bands.element_size() * len(op.offsets) * rows
    return (band if bands else 0) + 4 * rows * nvec


def _layout(op) -> str:
    return type(op).__name__.replace("Matrix", "").lower()


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    import torch
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device "
                           "(pass --device cpu to run on the CPU)")
    from sparsh_amg_tpu_torch import AMGSolver, flagship
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.ops import counted
    from sparsh_amg_tpu_torch.ops.formats import EllMatrix, FusedDia
    from sparsh_amg_tpu_torch.solve.smoothers import chebyshev
    from sparsh_amg_tpu_torch.utils import accounting, meminfo, timing

    params = flagship.params().replace(aggressive=args.aggressive)
    A = poisson3d(args.n)
    solver = AMGSolver(A, params, flagship.krylov(), device=dev)
    hier, levels = solver.hierarchy, solver.device.levels
    solver.warm()               # kernel builds and first launches
    rng = np.random.default_rng(0)
    vec = lambda n: torch.from_numpy(
        rng.standard_normal(n).astype(np.float32)).to(dev)

    def per_op_ms(fn, nbytes, runs=timing.TIMED_RUNS):
        if not cuda:
            return timing.benchmark_op(fn, warmup=1, iters=3) * 1e3
        return timing.timed_ms(fn, flush=timing.l2_flush_buffer(nbytes),
                               runs=runs)

    def row(kernel, op, nnz, fn, **extra):
        ob = accounting.op_bytes(op)
        ms = per_op_ms(fn, ob.padded)
        r = {"kernel": kernel, "mode": dev.type, "layout": _layout(op),
             **extra, "nnz": int(nnz), "per_op_ms": ms,
             "nnz_per_s": nnz / (ms / 1e3), "bytes_per_op": ob.real,
             "bytes_per_op_padded": ob.padded}
        print(json.dumps(r), file=sys.stderr, flush=True)
        return r

    bw_pre = timing.copy_bandwidth(dev) if cuda else None
    rows = []
    for li, lev in enumerate(levels):
        x = vec(lev.A.n_pad)
        rows.append(row(f"spmv_l{li}", lev.A, hier.levels[li].nnz,
                        lambda op=lev.A, x=x: op.spmv(x),
                        n=hier.levels[li].n, n_pad=lev.A.n_pad))
    for li, lev in enumerate(levels):
        for nm in ("P", "R"):
            op = getattr(lev, nm)
            if not isinstance(op, EllMatrix):
                continue
            hop = getattr(hier.levels[li], nm)
            x = vec(op.n_cols)
            rows.append(row(f"{nm}_l{li}", op, hop.nnz,
                            lambda op=op, x=x: op.spmv(x),
                            shape=list(hop.shape), k=op.k))
    nnz_c, real_c, padded_c = accounting.cycle_work(hier, solver.device,
                                                    params)
    b = vec(levels[0].n_pad)
    cyc = lambda: solver._cycle(levels, b)
    ms = per_op_ms(cyc, padded_c, runs=CYCLE_RUNS)
    rows.append({"kernel": "vcycle", "mode": dev.type, "n": hier.levels[0].n,
                 "levels": len(levels), "nnz": int(nnz_c), "per_op_ms": ms,
                 "nnz_per_s": nnz_c / (ms / 1e3),
                 "fine_nnz_per_s": hier.levels[0].nnz / (ms / 1e3),
                 "bytes_per_op": real_c, "bytes_per_op_padded": padded_c})

    spec = meminfo.hbm_spec_bw(dev) if cuda else None
    _, per_solve = counted(lambda: solver.solve(
        solver.prepare_rhs(rng.standard_normal(A.shape[0]))))

    def timed_row(kernel, n, nnz, fn, real, padded, wrapper=None, **extra):
        ms = per_op_ms(fn, padded)
        r = {"kernel": kernel, "mode": dev.type, "layout": "dia", **extra,
             "n": n, "nnz": int(nnz), "per_op_ms": ms,
             "graph_ms": timing.graph_ms(fn) if cuda else None,
             "nnz_per_s": nnz / (ms / 1e3), "bytes_per_op": real,
             "bytes_per_op_padded": padded,
             "bound_ms": real / spec * 1e3 if cuda else None}
        if wrapper:
            r["launches_per_solve"] = per_solve.get(wrapper, 0)
        print(json.dumps(r), file=sys.stderr, flush=True)
        return r

    L0, n0, nnz0 = levels[0], hier.levels[0].n, hier.levels[0].nnz
    if isinstance(L0.A, FusedDia):
        op, n_pad = L0.A, L0.A.n_pad
        x, d, r = vec(n_pad), vec(n_pad), vec(n_pad)
        for name, fn in cheb_calls(op, x, b, d, r, L0.dinv).items():
            rows.append(timed_row(
                f"{name}_l0", n0, nnz0, fn, tail_bytes(op, n0, name),
                tail_bytes(op, n_pad, name),
                wrapper=next(w for t, w, *_ in CHEB_TAILS if t == name)))
        degree, frac = params.cheby_degree, params.cheby_lower_frac
        for zero in (True, False):
            names = ["cheb_start0" if zero else "cheb_start"] + \
                ["cheb_step0" if zero and k == 0 else "cheb_step"
                 for k in range(degree - 2)] + \
                ["cheb_last0" if zero and degree == 2 else "cheb_last"]
            xs = None if zero else x
            rows.append(timed_row(
                f"cheb_smooth{'0' if zero else ''}_l0", n0, nnz0,
                lambda xs=xs, zero=zero: chebyshev(L0, b, xs, degree, frac,
                                                   zero),
                sum(tail_bytes(op, n0, t) for t in names),
                sum(tail_bytes(op, n_pad, t) for t in names), degree=degree))
    if cuda:
        rows += rank_block_rows(timed_row, rng)

    name = watts = bw_spec = bw_post = bw = None
    reprobed, plausible = False, True
    if cuda:
        bw_post = timing.copy_bandwidth(dev)
        bw = max(bw_pre, bw_post)
        bw_spec = meminfo.hbm_spec_bw(dev)
        name, watts, _ = meminfo.card_name_and_power_limit()
        rate = lambda r: r["bytes_per_op"] / (r["per_op_ms"] / 1e3)
        if max(rate(r) for r in rows) > bw:
            # no kernel moves bytes faster than a copy: the probe is the
            # implausible reading, not the kernel.  One more chance.
            bw = max(bw, timing.copy_bandwidth(dev))
            reprobed = True
        plausible = max(rate(r) for r in rows) <= bw
        for r in rows:
            r["hbm_frac"], r["hbm_frac_spec"] = rate(r) / bw, rate(r) / bw_spec
    else:
        for r in rows:
            r["hbm_frac"] = r["hbm_frac_spec"] = None
    gb = lambda v: None if v is None else v / 1e9
    hdr = {"kernel": "copy_bw", "mode": dev.type, "GBs": gb(bw),
           "GBs_pre": gb(bw_pre), "GBs_post": gb(bw_post),
           "spec_GBs": gb(bw_spec), "reprobed": reprobed,
           "plausible": plausible, "device_name": name,
           "power_limit_w": watts, "n": args.n,
           "aggressive": args.aggressive}
    print(json.dumps(hdr), flush=True)
    for r in rows:
        print(json.dumps(r), flush=True)
    if not plausible:
        print(json.dumps({"error": "implausible_copy_bw",
                          "detail": "a kernel exceeded 1x measured copy "
                                    "bandwidth after re-probing; discard "
                                    "these rows"}), flush=True)
    return {"copy_bw": hdr, "rows": rows, "ok": plausible}


def rank_block_rows(timed_row, rng):
    """The Chebyshev tails on rank 1's block of the four-card cell's fine
    level, poisson3d(304) over four ranks split by z-planes (bf16 bands,
    7,023,616 rows), as DistDia runs them in a solve: the local launch,
    then the boundary launch from halos already received."""
    import dataclasses
    import torch
    from chip_smoke import P304 as m, P304_RANKS as ranks
    from chip_smoke import poisson3d_slab_bands
    from sparsh_amg_tpu_torch.ops.formats import DiaMatrix
    from sparsh_amg_tpu_torch.parallel.dist import DistDia, RankGroup
    planes = m // ranks
    bands, offs = poisson3d_slab_bands(m, planes, 2 * planes)
    bands = torch.from_numpy(bands).cuda().to(torch.bfloat16)
    n, h = bands.shape[1], m * m
    vec = lambda k: torch.from_numpy(
        rng.standard_normal(k).astype(np.float32)).cuda()
    x, b, d, r, left, right = vec(n), vec(n), vec(n), vec(n), vec(h), vec(h)
    dinv = torch.full((n,), 1 / 6, device="cuda")

    @dataclasses.dataclass(frozen=True)
    class Received(RankGroup):
        def halo_start(self, v, width):
            return lambda: (left, right)

    op = DistDia(bands=bands, offsets=offs, h=h, ranks=Received(1, ranks),
                 n_rows=m ** 3, n_cols=m ** 3)
    nnz = int(torch.count_nonzero(bands))
    local = DiaMatrix(bands, offs, n, n)
    out = []
    for name, fn in cheb_calls(op, x, b, d, r, dinv).items():
        real = tail_bytes(local, n, name)
        out.append(timed_row(f"{name}_rank", n, nnz, fn, real, real,
                             grid=m, ranks=ranks, halo=h))
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 2)
