#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. environment: GPU name and power limit, torch/CUDA/nvcc versions;
  2. build the CUDA kernels from sparsh_amg_tpu_torch/csrc/;
  3. every kernel entry against its plain PyTorch version on the card, at a
     small size, on random long-row matrices (every split-row launch
     shape; two launches must give the same bits) and at the flagship's
     shapes (the DIA operators, every tail with the same bits twice and
     the instantiation and halo it ran, and every ELL operator of the
     hierarchy in the sliced layout it was packed in, its lanes per row
     T, slots per load V, sorting window sigma and stored/real slots
     printed, two launches with the same bits; the fp64 pass finish on
     the flagship's and the small DIA tables, x64 and the fp32 rhs with
     the plain version's bits, timed as CUDA graph replays): max errors,
     median device times, the least time the card could take (bound_ms
     at the data sheet's memory rate; bound_measured_ms, in the kernels
     line, at the copy rate measured at the end of the run) and the time
     of one PyTorch call computing the same function
     (library_ms: a cuSPARSE CSR SpMV, which the port never calls); and
     the loop guard of the Krylov loop (csrc/graph_loop.cu) against
     its plain version on every case of the loop condition;
  4. the flagship solve, poisson3d(192) (7,077,888 unknowns), through
     AMGSolver (each refinement pass one launch of a CUDA graph with a
     WHILE node, one host read per pass), with kernel launch counts from
     that solve, the residual recomputed on the host in fp64; then (4b)
     the same solve from the pass graphs against its passes launched
     eagerly (the loop in Python, the guard kernel before every step:
     counts equal, relres within 1e-12 relative, whether x has the same
     bits printed), the launches counted over one pass graph launch
     against the start's, k steps' and finish's captured launches and
     k + 1 guards, and over one replay of the step graph against the
     kernels the profiler sees, by wrapper, with the node kinds of the
     captured step;
     and a small solve on the card held against the same solve on the
     CPU;
  5. the systems path (smoothed aggregation, rigid-body modes, block
     levels): elasticity3d(40) and elasticity2d(512), each with every
     block (fp32 and bf16) and ELL operator of the hierarchy held
     against its plain version, two launches with the same bits, at the
     launch shape the solve gives it (the block levels' W, T, G, S
     printed in launch_shapes and per case; block tables that fit in L2
     timed with L2 flushed between launches, and every timed block case
     also as a CUDA graph replay, graph_ms), and elasticity2d's fine DIA
     operator under all five tails, timed with L2 flushed between
     launches since its 44 MB table fits in L2; then primed at tol 1e-2
     and solved to 1e-8 with launch counts from that solve; and a small
     elasticity3d(8) solve on the card held against the CPU;
  6. the seven scalar configurations of configs.py at full size (weighted
     Jacobi, l1-Jacobi, Chebyshev and two-stage Gauss-Seidel; V and W
     cycles; CG and BiCGStab): every DIA table of each hierarchy (the
     gs2 triangles, with one-sided offsets, included) under all five
     tails, every ELL operator (triangles included) and every dense
     one against its plain version, with each DIA table's instantiation
     and halo printed; timed cases for aniso2d(1024)'s 9-band fine level
     (SPMV and the l1-Jacobi sweep), its fine gs2 triangles, delaunay's
     fine ELL level and convection3d's R0; then each primed at tol
     1e-2 and solved to 1e-8 with launch counts, held to the JAX
     package's CPU counts (configs.held_counts: one configuration, whose
     BiCGStab count moves with rounding in the JAX package itself, to
     the port's plain versions' count at full size); and a
     stationary (method "amg") solve and a gs2-BiCGStab solve at small
     sizes on the card held against the CPU;
  7. the bench entry points as a user runs them, in child processes:
     bench_torch.py (the flagship at full size, built and warmed by
     itself, its line held to ok, 12 iterations / 2 passes and host
     relres <= 1e-8, its own launch counts over its timed solves) and
     kernel_bench_torch.py (every level operator, transfer and the
     V-cycle against the measured copy rate; it must exit 0);
  8. the distributed solver (parallel/), ranks as child processes of one
     torch.distributed group: bench_torch.py --dist 1 on NCCL (the
     flagship at full size, held as the serial line, its loop captured:
     its pass graphs built); the dry run of
     graft_entry_torch.py on 4 ranks sharing the card through gloo
     (poisson3d(64), the global setup and then the process-local blocked
     pipeline, each 12 +-1 iterations); the process-local solve of
     parallel/multihost.py on 4 gloo ranks at poisson3d(96), timed after
     the worker's warm() (12 / 2 +-1, relres <= 1e-8, the row blocks
     tiling the domain, no rank holding the global fine matrix); NCCL with more ranks than cards refused;
     the DIA interior and the ELL kernels on rank blocks of that 96^3
     hierarchy against their plain versions, timed; DistDia's products
     (every tail, fp32 and bf16 bands) on ranks 0, 1 and 3 of
     poisson3d(96), halos cut from the whole vector: the local and the
     boundary launch (dia_fused_boundary), one each, against the plain
     version on the whole matrix and bit for bit the rank's rows of one
     serial launch on it; the boundary launch alone timed on rank 1's
     block of poisson3d(304) over four ranks (the four-card cell's fine
     level, 7,023,616 rows, halo 92,416); and (8f, with two
     cards or more) the process-local solve on two NCCL ranks, one card
     each, its loop captured with the halos and all-reduces inside the
     graphs: counts 12 / 2 (+-1), relres <= 1e-8, one host read per pass
     (its pass graphs built), x with the same bits as the same solve run
     eagerly on each
     rank, no event node in the captured step.  With one card 8f prints
     that it did not run.  The ranks' launch counts over their solves
     join the totals.
The plain versions sum every stored slot, row lengths ignored, so a wrong
row length in a packer shows as a disagreement.
Every solve resets the launch counts just before it and reads them just
after; a replayed graph adds the launches its capture recorded, a pass
graph its step's once per iteration it ran.  Every solve on the card
(phases 4-6 and the bench lines) runs its passes from WHILE
graphs: graph capture is never skipped on the card, and a capture or a
pass graph that fails to build fails the run.  The line before the last is one JSON object with the kernels'
errors, times and launch counts; the last line is
{"ok": true, "device": {...}}.
"""
import copy
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np

REL_TOL = 1e-5      # kernel vs plain version: same inputs, fp32 sums in
                    # another order (and FMA contraction) on both sides
SMALL_E3D = 8               # elasticity3d size of the card-vs-CPU check
REPEATS = 3                 # warm solves timed after the counted one
# the least time the card could take (H100 SXM data sheet): device memory
# at 3.35 TB/s, fp32 outside the tensor cores at 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# random long-row cases (rows, columns, longest row) and, for the block
# kernel, (node rows, node columns, longest node row) per block size:
# fewer than 32 rows, rows not a multiple of 32, G x S of 32 x 8, 32 x 4,
# 32 x 1, 16 x 1, 8 x 1, 4 x 1 and 2 x 1 on an H100
LONG_ELL = [(20, 4000, 3000), (77, 5000, 3000), (2000, 3500, 1500),
            (10000, 12000, 250), (1000, 1500, 20), (1000, 1500, 40),
            (1000, 1500, 100)]
LONG_BLOCK = [(10, 600, 450), (15, 2500, 2000), (700, 900, 200),
              (100, 150, 20), (100, 150, 40), (100, 150, 100)]


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          check=True).stdout.strip()


def _errors(name, got, want):
    """(max abs error, normwise relative error) of got against want."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_err = rel_err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: bad output {tuple(g.shape)}")
        e = (g.double() - w.double()).abs().max().item()
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / max(w.double().abs().max().item(), 1e-30))
    return abs_err, rel_err


def compare(name, kernel, plain, results, time_it=True, work=None,
            library=None, same_bits=False, flush=None, extra=None,
            graph=False):
    """Kernel output(s) against the plain version's; raise above REL_TOL.
    Records max_abs_err, max_rel_err (normwise), and when timed both
    median device times and the kernel's time per call as the host
    launches it.  `work` (real_bytes, padded_bytes, flops; bytes as
    utils/accounting.op_bytes counts them) gives bound_ms;
    `library` = (note, {dtype: zero-arg call}) times one PyTorch call of
    the same function (its output held to the plain version too), or says
    why there is none.  `same_bits`: a second launch must give the same
    bits.  `flush`: see timed_ms (device times only).  `extra`: more keys
    for the record.  `graph`: also the time per launch of a CUDA graph
    replay (graph_ms), beside ms."""
    import torch
    from sparsh_amg_tpu_torch.utils.timing import graph_ms, timed_ms
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    abs_err, rel_err = _errors(name, got, want)
    rec = {"case": name, "max_abs_err": abs_err, "max_rel_err": rel_err,
           **(extra or {})}
    if same_bits:
        again = kernel()
        torch.cuda.synchronize()
        rec["same_bits"] = all(torch.equal(a, b) for a, b in zip(
            got if isinstance(got, tuple) else (got,),
            again if isinstance(again, tuple) else (again,)))
    if time_it:
        rec["ms"] = timed_ms(kernel, flush=flush)
        if graph:
            rec["graph_ms"] = graph_ms(kernel)
        rec["plain_ms"] = timed_ms(plain, flush=flush)
        rec["call_ms"] = timed_ms(kernel, queued=False)
        rec["l2_flushed"] = flush is not None
    if time_it and work is not None:
        real, padded, flops = work
        t_bytes, t_ops = real / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
        rec.update(real_bytes=real, padded_bytes=padded, flops=flops,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   TB_per_s_real=real / rec["ms"] / 1e9)
    if time_it:
        note, calls = library or ("none", {})
        rec["library_note"], rec["library_ms"] = note, None
        for dt, call in calls.items():
            lib_out = call()
            torch.cuda.synchronize()
            lerr = _errors(f"{name} library {dt}", lib_out, want)[1]
            rec[f"library_{dt}_rel_err"] = lerr
            if dt == "fp32":
                if not lerr <= REL_TOL:
                    raise AssertionError(f"{name}: the library call "
                                         f"disagrees ({lerr:.3e})")
                rec["library_ms"] = timed_ms(call, flush=flush)
            else:
                rec[f"library_{dt}_ms"] = timed_ms(call, flush=flush)
    results.append(rec)
    print(json.dumps(rec), flush=True)
    if not rel_err <= REL_TOL:
        raise AssertionError(f"{name}: rel err {rel_err:.3e} > {REL_TOL}")
    if same_bits and not rec["same_bits"]:
        raise AssertionError(f"{name}: two launches gave different bits")
    return rec


def _csr_call(crow, col, val, shape, x):
    """{"fp32": call[, "bf16": call]}: one cuSPARSE CSR SpMV y = A x over
    the given rows, as torch runs `A @ x`; bf16 where torch takes it."""
    import torch
    calls = {}
    for dt in (torch.float32, torch.bfloat16):
        A = torch.sparse_csr_tensor(crow, col, val.to(dt), size=shape)
        xd = x.to(dt)
        try:
            (A @ xd).float()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:
            print(f"library CSR {dt}: {type(e).__name__}: "
                  f"{str(e).splitlines()[0][:200]}", flush=True)
            continue
        calls["fp32" if dt == torch.float32 else "bf16"] = \
            (lambda A=A, xd=xd: (A @ xd).float())
    note = "csr fp32 and bf16" if "bf16" in calls else "csr fp32 only"
    return note, calls


def _crow(counts):
    import torch
    crow = torch.zeros(counts.shape[0] + 1, dtype=torch.int32,
                       device=counts.device)
    crow[1:] = torch.cumsum(counts, 0)
    return crow


def ell_library(M, x):
    """cuSPARSE CSR SpMV of the packed ELL matrix's real slots, in their
    rows' order (ell_unpack)."""
    import torch
    from sparsh_amg_tpu_torch.ops.ell_spmv import ell_unpack
    cols, vals, lens = ell_unpack(M)
    live = (torch.arange(M.k, device=cols.device)[:, None]
            < lens[None, :]).T                   # (n_pad, K), row-major
    return _csr_call(_crow(lens), cols.T[live].contiguous(),
                     vals.T[live].float().contiguous(),
                     (M.n_pad, x.shape[0]), x)


def block_library(M, x):
    """cuSPARSE CSR SpMV of the block matrix's stored values (the dense
    blocks of its real node slots) over dof rows."""
    import torch
    dev = M.cols.device
    bs, n = M.bs, M.n_rows
    node = torch.arange(n, device=dev) // bs
    live = torch.arange(M.k, device=dev)[None, :] < M.lens[node][:, None]
    cols = (M.cols[:, node].T * bs)[:, :, None] + torch.arange(
        bs, device=dev, dtype=torch.int32)           # (n, K, bs)
    vals = M.vals[:, :, :n].permute(2, 0, 1)          # vals[k, d, t]
    mask = live[:, :, None].expand(n, M.k, bs)
    counts = torch.zeros(M.n_pad, dtype=torch.int32, device=dev)
    counts[:n] = M.lens[node] * bs
    return _csr_call(_crow(counts), cols[mask].int().contiguous(),
                     vals[mask].float().contiguous(),
                     (M.n_pad, x.shape[0]), x)


def dia_library(bands, offsets, n, x):
    """cuSPARSE CSR SpMV of the band matrix's nonzeros whose columns lie
    in [0, n_pad) (the kernel's x = 0 outside: a rank block's interior
    product drops the entries that reach into the neighbours' rows)."""
    import torch
    rows, cols, vals = [], [], []
    n_pad = bands.shape[1]
    i = torch.arange(n, device=bands.device)
    for d, off in enumerate(offsets):
        keep = (bands[d, :n] != 0) & (i + off >= 0) & (i + off < n_pad)
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(bands[d, :n][keep].float())
    A = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                             torch.cat(cols)]),
                                torch.cat(vals), (n_pad, n_pad)
                                ).coalesce().to_sparse_csr()
    return _csr_call(A.crow_indices().int(), A.col_indices().int(),
                     A.values(), (n_pad, n_pad), x)


# vectors each DIA tail reads or writes once (inputs, then outputs);
# "zero": a Chebyshev tail's zero start (x not read; the start has no
# product, so it reads no band either)
DIA_VECTORS = {"dia_spmv": 2, "dia_residual": 3, "dia_dinv_residual": 4,
               "dia_jacobi_sweep": 4, "dia_cheb_step": 7,
               "dia_cheb_start": 5, "dia_cheb_last": 5,
               "dia_cheb_start zero": 4, "dia_cheb_step zero": 5,
               "dia_cheb_last zero": 4}


def dia_cases(tag, bands, offsets, rng, results, time_it, n_rows=None,
              dinv=None, timed=None):
    """Every tail of the DIA kernel on one band table of n_rows real rows
    (the Chebyshev start, step and last also from a zero start), each
    against its plain version, two launches giving the same bits.  Timed
    with L2 flushed between launches when the table fits in L2; `timed`
    limits the timing to the tails named there.  `dinv`: the
    level's own inverse diagonal, else a random one."""
    import torch
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    from sparsh_amg_tpu_torch.ops.formats import DiaMatrix
    from sparsh_amg_tpu_torch.utils.accounting import op_bytes
    from sparsh_amg_tpu_torch.utils.timing import l2_flush_buffer
    n = bands.shape[1]
    inst = {"instantiation": K.instantiation(bands, offsets)}
    print(f"dia {tag}: {bands.shape[0]} bands {tuple(offsets)}, "
          f"{inst['instantiation']}", flush=True)
    flush = l2_flush_buffer(bands.nbytes) if time_it else None
    n_rows = n if n_rows is None else n_rows
    vec = lambda: torch.from_numpy(
        rng.standard_normal(n).astype(np.float32)).to(bands.device)
    x, b, d, r = vec(), vec(), vec(), vec()
    if dinv is None:
        dinv = torch.from_numpy(
            rng.uniform(0.1, 0.2, n).astype(np.float32)).to(bands.device)
    P = lambda *a, **k: (lambda: K.dia_fused_plain(*a, **k))
    cases = [
        ("dia_spmv", lambda: K.dia_spmv(bands, x, offsets),
         P(K.SPMV, bands, offsets, x)),
        ("dia_residual", lambda: K.dia_residual(bands, x, b, offsets),
         P(K.RESIDUAL, bands, offsets, x, b=b)),
        ("dia_jacobi_sweep",
         lambda: K.dia_jacobi_sweep(bands, x, b, dinv, 0.7, offsets),
         P(K.JACOBI, bands, offsets, x, b=b, dinv=dinv, x=x, s0=0.7)),
        ("dia_cheb_step",
         lambda: K.dia_cheb_step(bands, x, d, r, dinv, 0.3, 0.9, offsets),
         P(K.CHEB, bands, offsets, d, b=r, dinv=dinv, x=x, s0=0.3, s1=0.9)),
    ]
    if hasattr(K, "dia_dinv_residual"):     # an older checkout's
        cases.insert(2, (
            "dia_dinv_residual",
            lambda: K.dia_dinv_residual(bands, x, b, dinv, offsets),
            P(K.DINV_RESIDUAL, bands, offsets, x, b=b, dinv=dinv)))
    if hasattr(K, "dia_cheb_start"):        # an older checkout has none
        cases += [
            ("dia_cheb_start",
             lambda: K.dia_cheb_start(bands, x, b, dinv, 1.7, offsets),
             P(K.CHEB_START, bands, offsets, x, b=b, dinv=dinv, s0=1.7)),
            ("dia_cheb_start zero",
             lambda: K.dia_cheb_start(bands, None, b, dinv, 1.7, offsets),
             P(K.CHEB_START, bands, offsets, None, b=b, dinv=dinv, s0=1.7)),
            ("dia_cheb_step zero",
             lambda: K.dia_cheb_step(bands, None, d, r, dinv, 0.3, 0.9,
                                     offsets),
             P(K.CHEB, bands, offsets, d, b=r, dinv=dinv, s0=0.3, s1=0.9)),
            ("dia_cheb_last",
             lambda: K.dia_cheb_last(bands, x, d, r, dinv, 0.3, 0.9,
                                     offsets),
             P(K.CHEB_LAST, bands, offsets, d, b=r, dinv=dinv, x=x, s0=0.3,
               s1=0.9)),
            ("dia_cheb_last zero",
             lambda: K.dia_cheb_last(bands, None, d, r, dinv, 0.3, 0.9,
                                     offsets),
             P(K.CHEB_LAST, bands, offsets, d, b=r, dinv=dinv, s0=0.3,
               s1=0.9)),
        ]
    dt = "bf16" if bands.dtype == torch.bfloat16 else "fp32"
    if time_it:
        # one SpMV's bytes (x and y), then the tail's other vectors
        ob = op_bytes(DiaMatrix(bands, tuple(offsets), n_rows, n_rows))
        nz = int(torch.count_nonzero(bands))
    for name, kern, plain in cases:
        wrapper = name.split()[0]
        extra_vec = DIA_VECTORS[name] - 2
        work = (ob.real + 4 * n_rows * extra_vec,
                ob.padded + 4 * n * extra_vec, 2 * nz) if time_it else None
        if time_it and name == "dia_cheb_start zero":   # no product
            work = (4 * n_rows * DIA_VECTORS[name],
                    4 * n * DIA_VECTORS[name], 0)
        t = time_it and (timed is None or wrapper in timed)
        lib = (dia_library(bands, offsets, n_rows, x)
               if t and name == "dia_spmv" else None)
        label = name.replace(" zero", " zero-start")
        compare(f"{label} {tag} {dt} n_pad={n}", kern, plain, results,
                t, work=work, library=lib, same_bits=True,
                flush=flush if t else None, extra=inst, graph=t)


def finish_case(tag, A64, rng, results, time_it, n_rows=None):
    """The fp64 pass finish (ops/fp64.py::dia_finish64) on one fp64 DIA
    table against finish64_plain: x64 and the fp32 right-hand side with
    its bits, ||r||^2 within 1e-13 relative, two launches with the same
    bits, the halo it stages.  Timed as CUDA graph replays (graph_ms; in
    place, x64 moving by d a launch) beside the plain composition with
    the copies into the loop's buffers that the finish graph made before
    the kernel (plain_ms)."""
    import torch
    from sparsh_amg_tpu_torch.ops.fp64 import (dia_finish64, finish64_plain,
                                               finish_halo)
    from sparsh_amg_tpu_torch.utils.timing import graph_ms
    n, dev = A64.n_pad, A64.bands.device
    n_rows = n if n_rows is None else n_rows
    vec = lambda scale, dt: torch.from_numpy(np.pad(
        rng.standard_normal(n_rows) * scale, (0, n - n_rows)).astype(dt)
        ).to(dev)
    x64, b64, d = vec(1.0, np.float64), vec(1.0, np.float64), \
        vec(1e-3, np.float32)

    def kernel():
        return dia_finish64(
            A64, x64.clone(), d, b64, torch.empty(n, device=dev),
            torch.empty(1, dtype=torch.float64, device=dev))
    px, pr, prr = finish64_plain(A64, x64, d, b64, torch.dot)
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    errs = [(got[0] - px).abs().max().item(),
            (got[1].double() - pr.float().double()).abs().max().item()]
    rec = {"case": f"dia_finish64 {tag} fp64 n_pad={n}",
           "instantiation": f"halo={finish_halo(A64.offsets)}",
           "x_same_bits": torch.equal(got[0], px),
           "b_same_bits": torch.equal(got[1], pr.float()),
           "rr_rel_err": abs(got[2].item() - prr.item()) / prr.item(),
           "same_bits": all(torch.equal(a, b) for a, b in zip(got, again)),
           "max_abs_err": max(errs), "max_rel_err": max(
               errs[0] / px.abs().max().item(),
               errs[1] / pr.abs().max().item())}
    if time_it:
        xb, bb = x64.clone(), torch.empty(n, device=dev)
        rrb = torch.empty(1, dtype=torch.float64, device=dev)

        def plain():
            x, r, s = finish64_plain(A64, xb, d, b64, torch.dot)
            xb.copy_(x)
            bb.copy_(r)
            rrb.copy_(s)
        rec["ms"] = rec["graph_ms"] = graph_ms(
            lambda: dia_finish64(A64, xb, d, b64, bb, rrb))
        rec["plain_ms"] = graph_ms(plain)
        # each band once, x64 in and out, d and b64 in, the fp32 b out
        nb = len(A64.offsets)
        real, padded = (8 * nb + 32) * n_rows, (8 * nb + 32) * n
        flops = 2 * int(torch.count_nonzero(A64.bands)) + 3 * n_rows
        rec.update(real_bytes=real, padded_bytes=padded, flops=flops,
                   bound_ms=real / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                   TB_per_s_real=real / rec["ms"] / 1e9, l2_flushed=False,
                   library_ms=None, library_note="none: the JAX package's "
                   "df64 residual is plain XLA")
    results.append(rec)
    print(json.dumps(rec), flush=True)
    if not (rec["x_same_bits"] and rec["b_same_bits"] and rec["same_bits"]
            and rec["rr_rel_err"] <= 1e-13):
        raise AssertionError(f"{rec['case']}: {rec}")
    return rec


def ell_case(tag, M, rng, results, time_it, same_bits=True):
    """The ELL kernel against its plain version on one packed matrix; the
    record names its lanes per row T, slots per load V, sorting window
    sigma, split-row shape G x S and stored over real slots."""
    import torch
    from sparsh_amg_tpu_torch.ops.ell_spmv import (ell_plain, ell_spmv,
                                                   split_shape)
    from sparsh_amg_tpu_torch.utils.accounting import op_bytes
    x = torch.from_numpy(
        rng.standard_normal(max(M.n_cols, 1)).astype(np.float32)).to(
        M.cols.device)
    dt = "bf16" if M.vals.dtype == torch.bfloat16 else "fp32"
    g, s = split_shape(M, M.cols.device)
    layout = {"T": M.lanes, "V": M.vec, "sigma": M.sigma,
              "stored_over_real": M.cols.numel() / max(M.nnz, 1)}
    work = lib = None
    if time_it:
        work = (*op_bytes(M), 2 * M.nnz)
        lib = ell_library(M, x)
    return compare(f"ell_spmv {tag} {dt} K={M.k} n={M.n_rows} "
                   f"n_pad={M.n_pad} T={M.lanes} V={M.vec} "
                   f"sigma={M.sigma} G={g} S={s} "
                   f"stored/real={layout['stored_over_real']:.3f}",
                   lambda: ell_spmv(M, x), lambda: ell_plain(M, x), results,
                   time_it, work=work, library=lib, same_bits=same_bits,
                   extra=layout)


def block_case(tag, M, rng, results, time_it, same_bits=True):
    """The block kernel against its plain version on one table, at the
    launch shape the solve gives it (W node rows a thread, T lanes a
    group, or the split rows' G x S); timed with L2 flushed between
    launches where the tables fit in L2, and as a graph replay."""
    import torch
    from sparsh_amg_tpu_torch.ops.block_ell import (block_ell_plain,
                                                    block_ell_spmv,
                                                    block_shape)
    from sparsh_amg_tpu_torch.utils.accounting import op_bytes
    from sparsh_amg_tpu_torch.utils.timing import l2_flush_buffer
    x = torch.from_numpy(rng.standard_normal(max(M.n_pad, M.n_cols)).astype(
        np.float32)).to(M.cols.device)
    dt = "bf16" if M.vals.dtype == torch.bfloat16 else "fp32"
    w, t, g, s = block_shape(M.cols, M.vals)
    work = lib = flush = None
    if time_it:
        ob = op_bytes(M)
        work = (*ob, 2 * int(M.lens.sum()) * M.bs * M.bs)
        lib = block_library(M, x)
        flush = l2_flush_buffer(ob.padded)
    return compare(f"block_ell_spmv {tag} {dt} bs={M.bs} K={M.k} "
                   f"n={M.n_rows} n_pad={M.n_pad} W={w} T={t} G={g} S={s}",
                   lambda: block_ell_spmv(M.cols, M.vals, M.lens, x),
                   lambda: block_ell_plain(M.cols, M.vals, x),
                   results, time_it, work=work, library=lib,
                   same_bits=same_bits, flush=flush, graph=time_it,
                   extra={"W": w, "T": t, "G": g, "S": s})


def long_row_cases(rng, results, dev):
    """The split-row launches on random long-row matrices (rows of 0 to
    3,000 slots), fp32 and bf16: against the plain version, and two
    launches must give the same bits."""
    import torch
    from sparsh_amg_tpu_torch.ops.block_ell import csr_to_block_ell
    from sparsh_amg_tpu_torch.ops.formats import csr_to_ell
    from sparsh_amg_tpu_torch.systems import random_long_rows
    for dt in (torch.float32, torch.bfloat16):
        for shape in LONG_ELL:
            E = csr_to_ell(random_long_rows(*shape, seed=5), dt, 2048,
                           device=dev)
            ell_case(f"long rows {shape}", E, rng, results, time_it=False,
                     same_bits=True)
        for bs in (2, 3, 6):
            for shape in LONG_BLOCK:
                M = csr_to_block_ell(random_long_rows(*shape, seed=6, bs=bs),
                                     bs, dt, device=dev)
                block_case(f"long rows {shape}", M, rng, results,
                           time_it=False, same_bits=True)


# a level's operators, named as the kernel cases are: "A2", "P0", "R1",
# and "tril0"/"triu0" for the two-stage Gauss-Seidel triangles
FIELDS = {"A": "A", "P": "P", "R": "R", "L": "tril", "U": "triu"}


def level_operators(levels, kind):
    """[(name, level index, matrix)]: every operator of a device hierarchy
    of layout class `kind`."""
    return [(f"{tag}{li}", li, getattr(lev, f))
            for li, lev in enumerate(levels) for f, tag in FIELDS.items()
            if isinstance(getattr(lev, f), kind)]


def sparse_operators(levels):
    """[(name, matrix)]: every ELL and block operator of a device
    hierarchy ("P0", "R1", "A2", "tril1" for ELL, "L1" for a block
    level)."""
    from sparsh_amg_tpu_torch.ops.block_ell import BlockEllMatrix
    from sparsh_amg_tpu_torch.ops.formats import EllMatrix
    return [(f"L{li}" if isinstance(M, BlockEllMatrix) else name, M)
            for name, li, M in level_operators(levels,
                                               (EllMatrix, BlockEllMatrix))]


def launch_shapes(levels):
    """The launch of every ELL and block operator of a device hierarchy,
    as {name: [rows, K, G, S, T]} for ELL (the split rows' lanes and
    cluster blocks, T lanes per row of a slice) and [rows, K, W, T, G, S]
    for a block level (W node rows a thread, T lanes a group)."""
    from sparsh_amg_tpu_torch.ops.block_ell import (BlockEllMatrix,
                                                    block_shape)
    from sparsh_amg_tpu_torch.ops.ell_spmv import split_shape
    return {name: [M.n_rows, M.k, *block_shape(M.cols, M.vals)]
            if isinstance(M, BlockEllMatrix) else
            [M.n_rows, M.k, *split_shape(M, M.cols.device), M.lanes]
            for name, M in sparse_operators(levels)}


def operator_cases(tag, levels, rng, results, timed):
    """Every ELL and block operator of a device hierarchy against its
    plain version, at the launch shape the solve gives it; the operators
    named in `timed` are timed, block levels in fp32 and bf16."""
    import dataclasses
    import torch
    from sparsh_amg_tpu_torch.ops.block_ell import BlockEllMatrix
    for name, M in sparse_operators(levels):
        label, time_it = f"{tag}{name}", name in timed
        if isinstance(M, BlockEllMatrix):
            block_case(label, M, rng, results, time_it)
            block_case(label, dataclasses.replace(
                M, vals=M.vals.to(torch.bfloat16)), rng, results, time_it)
        else:
            ell_case(label, M, rng, results, time_it)


# the loop guard's cases: each method's state, with its condition's every
# way to stop (a breakdown only BiCGStab reports)
GUARD_CASES = ("active", "met", "zero_rhs", "budget", "inf", "nan",
               "breakdown")
# bytes the guard must move: ||r||^2 (fp32), k (int32), breakdown (bool),
# target and budget (fp64) read; (||r||^2, k, breakdown) written in fp64
GUARD_BYTES = 4 + 4 + 1 + 8 + 8 + 3 * 8


def guard_cases(results, dev):
    """The loop guard kernel launched on its own against its plain version
    (krylov.loop_active and loop_record) on every case of the loop
    condition, for each Krylov method's state at the solver's types: the
    same decision and record, the same bits twice.  One case timed."""
    import torch
    from sparsh_amg_tpu_torch.solve import krylov as tk
    from sparsh_amg_tpu_torch.solve.graphs import loop_guard
    f64 = torch.float64
    for method, size in (("cg", 7), ("bicgstab", 10), ("amg", 4)):
        i_rr, i_k, i_brk = tk.READS[method]
        for case in GUARD_CASES:
            if case == "breakdown" and i_brk is None:
                continue
            state = [torch.zeros((), device=dev) for _ in range(size)]
            state[i_rr] = torch.tensor(
                {"inf": float("inf"), "nan": float("nan"),
                 "zero_rhs": 0.0}.get(case, 2.5), device=dev)
            state[i_k] = torch.tensor(50 if case == "budget" else 3,
                                      dtype=torch.int32, device=dev)
            if i_brk is not None:
                state[i_brk] = torch.tensor(case == "breakdown", device=dev)
            guard = (torch.tensor(3.0 if case == "met" else 0.0, dtype=f64,
                                  device=dev),
                     torch.tensor(50.0, dtype=f64, device=dev))
            prog = torch.zeros(5, dtype=f64, device=dev)
            # a non-finite ||r||^2 is recorded as it is: compared apart
            lo = 1 if case in ("inf", "nan") else 0
            kernel = lambda m=method, st=state, g=guard, p=prog, lo=lo: (
                loop_guard(m, st, g, p), p[lo:3])
            plain = lambda m=method, st=state, g=guard, lo=lo: (
                tk.loop_active(m, st, g).int(), tk.loop_record(m, st)[lo:])
            rec = compare(f"loop_guard {method} {case}", kernel, plain,
                          results, time_it=(method, case) == ("cg",
                                                              "active"),
                          work=(GUARD_BYTES, GUARD_BYTES, 0),
                          same_bits=True)
            got, want = kernel()[0].item(), tk.loop_continue(method, state,
                                                              guard)
            assert bool(got) == want == (case == "active"), (rec, got)
            if lo:
                assert torch.equal(prog[:1].isnan(), state[i_rr].isnan()
                                   .reshape(1)) and prog[0].item() \
                    != 0.0, (case, prog)


def uncaptured(solver):
    """A shallow copy of `solver` whose loop runs eagerly: Python sees
    every call of a solve (a replayed CUDA graph makes none)."""
    s = copy.copy(solver)
    s.capture = False
    return s


def calls_per_operator(fn, levels):
    """Calls of the DIA, ELL and block SpMVs in fn(), by operator
    ("L<i> A/P/R/L/U"), counted at the layouts' spmv methods (the fused
    DIA tails, the wrappers and their launch counts are left as they
    are); "other" is the Krylov matvec on its own fp32 operator."""
    from sparsh_amg_tpu_torch.ops.block_ell import BlockEllMatrix
    from sparsh_amg_tpu_torch.ops.formats import DiaMatrix, EllMatrix
    classes = (DiaMatrix, EllMatrix, BlockEllMatrix)
    names = {id(getattr(lev, f)): f"L{li} {f}"
             for li, lev in enumerate(levels) for f in FIELDS
             if isinstance(getattr(lev, f), classes)}
    calls = dict.fromkeys(names.values(), 0)
    real = [c.spmv for c in classes]

    def shim(method):
        def spmv(self, x):
            key = names.get(id(self), "other")
            calls[key] = calls.get(key, 0) + 1
            return method(self, x)
        return spmv
    for c, m in zip(classes, real):
        c.spmv = shim(m)
    try:
        fn()
    finally:
        for c, m in zip(classes, real):
            c.spmv = m
    return calls


def wrapper_of(kernel_name):
    """The wrapper of one of the package's kernels, by the kernel's name in
    a profiler trace (dia_tile's second template argument is the tail,
    the index of its wrapper in dia_spmv.WRAPPERS; dia_boundary is
    dia_fused_boundary's; the loop guard is loop_guard); None for
    others."""
    from sparsh_amg_tpu_torch.ops.dia_spmv import WRAPPERS
    m = re.search(r"::dia_tile<[^,]+, (\d+),", kernel_name)
    if m:
        return WRAPPERS[int(m.group(1))].__name__
    if "::dia_boundary<" in kernel_name:
        return "dia_fused_boundary"
    for name in ("block_ell_spmv", "ell_spmv", "dia_finish64", "loop_guard"):
        if f"::{name}" in kernel_name:
            return name
    return None


def pass_graph_check(tag, solver, res, launches):
    """A solve on the card ran each pass as one pass graph launch: the
    solver's pass graphs are built, one host read per pass, and the guard
    launched k + 1 times per pass."""
    loop = solver._loop()
    assert loop.passes and all(p.exec is not None
                               for p in loop.passes.values()), tag
    assert res.host_reads == res.refine_passes, (tag, res.host_reads, res)
    assert launches["loop_guard"] == res.iterations + res.refine_passes, \
        (tag, launches["loop_guard"], res)
    # the fp64 finish kernel on a DIA fine level, twice a pass
    from sparsh_amg_tpu_torch.ops.formats import DiaMatrix
    want = 2 * res.refine_passes if isinstance(solver.A64, DiaMatrix) else 0
    assert launches["dia_finish64"] == want, (tag, launches, res)


def loop_phase(solver, rhs):
    """Phase 4b on the flagship: the solve from WHILE-node pass graphs
    against the same passes launched eagerly (the guard kernel before
    every step, one read per step; counts equal, relres within 1e-12
    relative; whether x has the same bits is printed), and the launches
    that counted() reports over one pass graph launch and over one
    replay of the step graph, against the bookkeeping and the kernels
    the profiler sees."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sparsh_amg_tpu_torch.ops import counted
    # both copies start from the solver's estimates: the same solve
    cap, eager = copy.copy(solver), uncaptured(solver)
    r_cap, l_cap = counted(lambda: cap.solve(rhs))
    r_eager = eager.solve(rhs)
    same_bits = bool(np.array_equal(r_cap.x, r_eager.x))
    print(json.dumps({
        "captured_vs_eager": "poisson3d", "captured": [
            r_cap.iterations, r_cap.refine_passes, r_cap.relres,
            r_cap.solve_time, r_cap.host_reads],
        "eager": [r_eager.iterations, r_eager.refine_passes,
                         r_eager.relres, r_eager.solve_time,
                         r_eager.host_reads],
        "x_same_bits": same_bits,
        "graph_seconds": solver.graph_seconds(),
        "pass_graph_seconds": solver.pass_graph_seconds()}), flush=True)
    if not same_bits:
        print("captured and eager passes gave x with other bits",
              flush=True)
    assert (r_cap.iterations, r_cap.refine_passes) == \
        (r_eager.iterations, r_eager.refine_passes), (r_cap, r_eager)
    assert abs(r_cap.relres - r_eager.relres) <= 1e-12 * r_eager.relres, \
        (r_cap.relres, r_eager.relres)
    assert r_cap.converged
    pass_graph_check("poisson3d", cap, r_cap, l_cap)
    # the eager passes read the guard after every step
    assert r_eager.host_reads == r_eager.iterations + 2 * \
        r_eager.refine_passes, r_eager

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out, counts = counted(fn)
            torch.cuda.synchronize()
        seen = {}
        for e in prof.events():
            w = wrapper_of(e.name)
            if w and getattr(e.device_type, "name", "") == "CUDA":
                seen[w] = seen.get(w, 0) + 1
        return out, {k: v for k, v in counts.items() if v}, seen

    # launch accounting under replay: one pass graph launch, then one
    # replay of its step graph
    loop = solver._loop()
    loop.b64.copy_(rhs.b)
    loop.set_limits(1e-4, solver.krylov.maxiter)
    (prog, _), counts, seen = profiled(loop.pass_graph(True).run)
    k = int(prog[1])
    want = {}
    for g, times in ((loop.cast, 1), (loop.init, 1), (loop.step, k),
                     (loop.finish, 1)):
        for w, n in g.per_replay.items():
            want[w.__name__] = want.get(w.__name__, 0) + n * times
    want["loop_guard"] = k + 1
    _, step_counts, step_seen = profiled(loop.step.run)
    print(json.dumps({
        "pass_graph_launches_counted": counts, "pass_graph_iterations": k,
        "pass_graph_kernels_profiled": seen,
        "step_launches_counted": step_counts,
        "step_kernels_profiled": step_seen,
        "step_graph_nodes": loop.step.node_kinds()}), flush=True)
    # the profiler reports a WHILE body's kernels once per launch
    assert k > 1 and counts == want, (counts, want)
    assert set(seen) == set(counts) and all(
        1 <= seen[w] <= counts[w] for w in counts), (counts, seen)
    assert step_counts and step_counts == step_seen, (step_counts,
                                                      step_seen)


def systems_phase(dim, rng, results, dev):
    """Phase 5 for one elasticity configuration: every sparse operator
    of the hierarchy against its plain version, then the primed solve to
    1e-8.  Returns the solve's launch counts."""
    import torch
    from sparsh_amg_tpu_torch import AMGSolver, systems
    from sparsh_amg_tpu_torch.ops import counted
    from sparsh_amg_tpu_torch.ops.block_ell import BlockEllMatrix
    from sparsh_amg_tpu_torch.ops.formats import DiaMatrix, EllMatrix
    from sparsh_amg_tpu_torch.utils.meminfo import device_memory_stats
    name = f"elasticity{dim}d({systems.SIZES[dim]})"
    A, ns = systems.problem(dim)
    torch.cuda.reset_peak_memory_stats()
    solver = AMGSolver(A, systems.params(dim), systems.krylov(),
                       nullspace=ns, device=dev)
    setup_peak = device_memory_stats(dev).get("peak_bytes_in_use")
    levels = solver.device.levels
    kinds = [(type(l.A).__name__, l.n, getattr(l.A, "bs", 1),
              getattr(l.A, "k", None) or len(getattr(l.A, "offsets", ())))
             for l in levels]
    shapes = launch_shapes(levels)
    print(f"{name} n={A.shape[0]} nnz={A.nnz} setup_s={solver.setup_time:.2f}"
          f" levels={kinds} mv_from_level0={solver.mv_from_level0} "
          f"launch_shapes={shapes}", flush=True)
    blocks = [(li, l.A) for li, l in enumerate(levels)
              if isinstance(l.A, BlockEllMatrix)]
    if dim == 3:
        assert [li for li, _ in blocks] == [0, 1, 2], kinds
        assert solver.mv_from_level0
    else:
        assert isinstance(levels[0].A, DiaMatrix), kinds
        assert [li for li, _ in blocks] == [1, 2], kinds
    timed = {f"L{li}" for li, _ in blocks}
    if dim == 3:
        assert all(isinstance(levels[li].R, EllMatrix) for li in range(3))
        timed |= {"R0", "R1", "R2"}
    operator_cases(f"e{dim}d ", levels, rng, results, timed)
    if dim == 2:
        L0 = levels[0].A
        assert len(L0.offsets) == 21 and L0.bands.dtype == torch.float32, \
            kinds
        dia_cases("e2d L0", L0.bands, L0.offsets, rng, results,
                  time_it=True, n_rows=A.shape[0])
        finish_case("e2d L0", solver.A64, rng, results, time_it=True,
                    n_rows=A.shape[0])

    b = np.random.default_rng(0).standard_normal(A.shape[0])
    rhs = solver.prepare_rhs(b)
    solver.solve(rhs, tol=1e-2)             # prime, as run_configs_tpu.py
    torch.cuda.synchronize()
    # the solve's own peak: the kernel checks above allocate temporaries
    torch.cuda.reset_peak_memory_stats()
    res, launches = counted(lambda: solver.solve(rhs))
    solve_peak = device_memory_stats(dev).get("peak_bytes_in_use")
    x = res.x
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    repeats = [solver.solve(rhs).solve_time for _ in range(REPEATS)]
    per_op = calls_per_operator(lambda: uncaptured(solver).solve(rhs),
                                levels)
    ref = systems.REFERENCE[name]
    print(json.dumps({
        "config": name, "setup_s": solver.setup_time,
        "solve_s": res.solve_time, "solve_s_repeats": repeats,
        "spmv_calls_per_operator": per_op,
        "iterations": res.iterations,
        "refine_passes": res.refine_passes, "jax_reference": ref,
        "levels": solver.hierarchy.n_levels,
        "operator_complexity": solver.hierarchy.operator_complexity(),
        "device_bytes": solver.device_bytes(),
        "setup_peak_bytes": setup_peak, "solve_peak_bytes": solve_peak,
        "relres_host_fp64": relres, "relres_solver": res.relres,
        "converged": res.converged, "history": res.history,
        "mv_from_level0": solver.mv_from_level0, "launches": launches,
        "launch_shapes": shapes}), flush=True)
    assert x.shape == (A.shape[0],) and np.isfinite(x).all()
    assert res.converged and relres <= 1e-8, (res, relres)
    # the JAX package's CPU counts; e2d's four passes sit at the fp32
    # floor, hence +-2 there
    want, slack = ref["cpu"], (1 if dim == 3 else 2)
    assert abs(res.iterations - want["iterations"]) <= slack, (res, want)
    assert res.refine_passes == want["refine_passes"], (res, want)
    assert launches["block_ell_spmv"] > 0 and launches["ell_spmv"] > 0
    pass_graph_check(name, solver, res, launches)
    if dim == 2:
        assert launches["dia_cheb_step"] > 0 and launches["dia_spmv"] > 0
    return launches


def systems_small_check(dev):
    """A small elasticity3d solve on the card against the same solve on
    the CPU (the plain versions, which the CPU tests hold to the JAX
    package)."""
    from sparsh_amg_tpu_torch import AMGSolver, systems
    A, ns = systems.problem(3, SMALL_E3D)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    p = systems.params(3, dense_size=256)
    on_gpu = AMGSolver(A, p, systems.krylov(), nullspace=ns,
                       device=dev).solve(b)
    on_cpu = AMGSolver(A, p, systems.krylov(), nullspace=ns,
                       device="cpu").solve(b)
    dx = np.linalg.norm(on_gpu.x - on_cpu.x) / np.linalg.norm(on_cpu.x)
    rel = [float(np.linalg.norm(b - A @ r.x) / np.linalg.norm(b))
           for r in (on_gpu, on_cpu)]
    # x is printed, not gated: elasticity is far worse conditioned than
    # Poisson, so two converged solutions differ more than relres says
    print(f"elasticity3d({SMALL_E3D}) cuda {on_gpu} cpu {on_cpu} host relres "
          f"{rel} rel diff x {dx:.3e}", flush=True)
    assert on_gpu.converged and on_cpu.converged
    assert max(rel) <= 1e-8, rel
    assert abs(on_gpu.iterations - on_cpu.iterations) <= 1
    assert on_gpu.refine_passes == on_cpu.refine_passes


def dense_case(tag, M, rng, results):
    """A dense operator's matvec on the card against the same product in
    fp64 on the host."""
    import torch
    import torch.nn.functional as F
    r, c = M.mat.shape
    x = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(
        M.mat.device)

    def plain():
        y = M.mat.cpu().double() @ x.cpu().double()
        return F.pad(y, (0, M.out_pad - r)).to(x.device)
    compare(f"dense {tag} {M.n_rows}x{M.n_cols}", lambda: M.spmv(x), plain,
            results, time_it=False)


# phase 6: short names of the configurations in the kernel cases
CONFIG_TAGS = {
    "poisson2d_1024_wjacobi_V_cg": "p2d(1024)",
    "aniso2d_1024_eps1e-3_rot45_aggW_bicgstab": "aniso-SA(1024)",
    "aniso2d_2048_eps1e-3_rot45_aggW_bicgstab": "aniso-SA(2048)",
    "aniso2d_1024_pmis_extpi_W_gs2_bicgstab": "aniso-gs2(1024)",
    "convection3d_96_pmis_extpi_V_bicgstab": "c3d(96)",
    "jump2d_1024_random_1e4_V_cg": "jump2d(1024)",
    "delaunay_1024sq_rcm_l1jac_V_cg": "delaunay(1024^2)",
}
# the timed cases of each configuration: DIA tables with the
# tails to time (the level's l1 inverse diagonal feeds the Jacobi tail),
# and ELL operators
CONFIG_TIMED = {
    "aniso2d_1024_eps1e-3_rot45_aggW_bicgstab": {
        "dia": {"A0": ("dia_spmv", "dia_jacobi_sweep")}},
    "aniso2d_1024_pmis_extpi_W_gs2_bicgstab": {
        "dia": {"tril0": ("dia_spmv",), "triu0": ("dia_spmv",)}},
    "delaunay_1024sq_rcm_l1jac_V_cg": {"ell": {"A0"}},
    "convection3d_96_pmis_extpi_V_bicgstab": {"ell": {"R0"}},
}
# wrappers each configuration's counted solve must launch, and operators
# whose SpMV it must call (calls_per_operator's names)
CONFIG_LAUNCHES = {
    "poisson2d_1024_wjacobi_V_cg": ("dia_jacobi_sweep", "dia_residual",
                                    "dia_spmv", "ell_spmv"),
    "aniso2d_1024_eps1e-3_rot45_aggW_bicgstab": (
        "dia_jacobi_sweep", "dia_residual", "dia_spmv", "ell_spmv"),
    "aniso2d_2048_eps1e-3_rot45_aggW_bicgstab": (
        "dia_jacobi_sweep", "dia_residual", "dia_spmv", "ell_spmv"),
    "aniso2d_1024_pmis_extpi_W_gs2_bicgstab": ("dia_spmv", "dia_residual",
                                               "ell_spmv"),
    "convection3d_96_pmis_extpi_V_bicgstab": ("dia_spmv", "dia_residual",
                                              "ell_spmv"),
    "jump2d_1024_random_1e4_V_cg": ("dia_cheb_start", "dia_cheb_step",
                                    "dia_cheb_last", "dia_residual",
                                    "dia_spmv", "ell_spmv"),
    "delaunay_1024sq_rcm_l1jac_V_cg": ("ell_spmv",),
}
CONFIG_CALLS = {
    "aniso2d_1024_pmis_extpi_W_gs2_bicgstab": ("L0 L", "L0 U"),
    "convection3d_96_pmis_extpi_V_bicgstab": ("L0 L", "L0 U"),
    "delaunay_1024sq_rcm_l1jac_V_cg": ("L0 A",),
}


def config_phase(name, rng, results, dev):
    """Phase 6 for one configuration of configs.py at full size: every
    DIA, ELL and dense operator of the hierarchy against its plain
    version, the configured cases timed, then the primed solve to 1e-8.
    Returns the solve's launch counts."""
    import torch
    from sparsh_amg_tpu_torch import AMGSolver, configs
    from sparsh_amg_tpu_torch.ops import counted
    from sparsh_amg_tpu_torch.ops.formats import DenseMatrix, DiaMatrix
    from sparsh_amg_tpu_torch.utils.meminfo import device_memory_stats
    t_phase = time.perf_counter()
    A, _ = configs.problem(name)
    gen_s = time.perf_counter() - t_phase
    torch.cuda.reset_peak_memory_stats()
    solver = AMGSolver(A, configs.params(name), configs.krylov(name),
                       device=dev)
    setup_peak = device_memory_stats(dev).get("peak_bytes_in_use")
    levels = solver.device.levels
    kinds = [(type(l.A).__name__, l.n,
              getattr(l.A, "k", None) or len(getattr(l.A, "offsets", ())),
              type(l.L).__name__, type(l.U).__name__) for l in levels]
    shapes = launch_shapes(levels)
    print(f"{name} n={A.shape[0]} nnz={A.nnz} gen_s={gen_s:.2f} "
          f"setup_s={solver.setup_time:.2f} levels={kinds} "
          f"launch_shapes={shapes}", flush=True)
    timed = CONFIG_TIMED.get(name, {})
    tag = CONFIG_TAGS[name] + " "
    krylov_op = solver._krylov_op
    if krylov_op is not levels[0].A:        # the fine level's fp32 copy
        if isinstance(krylov_op, DiaMatrix):
            dia_cases(tag + "Krylov operator", krylov_op.bands,
                      krylov_op.offsets, rng, results, False, A.shape[0])
        else:
            ell_case(tag + "Krylov operator", krylov_op, rng, results,
                     False)
    for op, li, M in level_operators(levels, DiaMatrix):
        lev = levels[li]
        tails = timed.get("dia", {}).get(op)
        dia_cases(tag + op, M.bands, M.offsets, rng, results,
                  tails is not None, n_rows=M.n_rows,
                  dinv=lev.l1_dinv if lev.l1_dinv is not None else lev.dinv,
                  timed=tails)
    operator_cases(tag, levels, rng, results, timed.get("ell", set()))
    for op, _, M in level_operators(levels, DenseMatrix):
        dense_case(tag + op, M, rng, results)

    b = configs.rhs(A.shape[0])
    rhs = solver.prepare_rhs(b)
    solver.solve(rhs, tol=1e-2)             # prime, as run_configs_tpu.py
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, launches = counted(lambda: solver.solve(rhs))
    solve_peak = device_memory_stats(dev).get("peak_bytes_in_use")
    x = res.x
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    repeats = [solver.solve(rhs).solve_time for _ in range(REPEATS)]
    per_op = calls_per_operator(lambda: uncaptured(solver).solve(rhs),
                                levels)
    ref = configs.REFERENCE[name]
    print(json.dumps({
        "config": name, "gen_s": gen_s, "setup_s": solver.setup_time,
        "solve_s": res.solve_time, "solve_s_repeats": repeats,
        "spmv_calls_per_operator": per_op,
        "iterations": res.iterations,
        "refine_passes": res.refine_passes, "jax_reference": ref,
        "levels": solver.hierarchy.n_levels,
        "operator_complexity": solver.hierarchy.operator_complexity(),
        "device_bytes": solver.device_bytes(),
        "setup_peak_bytes": setup_peak, "solve_peak_bytes": solve_peak,
        "relres_host_fp64": relres, "relres_solver": res.relres,
        "converged": res.converged, "history": res.history,
        "launches": launches, "launch_shapes": shapes,
        "phase_s": time.perf_counter() - t_phase}), flush=True)
    assert x.shape == (A.shape[0],) and np.isfinite(x).all()
    assert res.converged and relres <= 1e-8, (name, res, relres)
    want = configs.held_counts(name)
    assert res.refine_passes == want["refine_passes"], (name, res, want)
    assert abs(res.iterations - want["iterations"]) <= \
        configs.iteration_slack(name), (name, res, want)
    for w in CONFIG_LAUNCHES[name]:
        assert launches[w] > 0, f"{name}: {w} not launched during the solve"
    for op in CONFIG_CALLS.get(name, ()):
        assert per_op[op] > 0, f"{name}: no SpMV on {op} during the solve"
    pass_graph_check(name, solver, res, launches)
    return launches


def config_small_checks(dev):
    """A stationary AMG solve (method "amg") and a gs2-BiCGStab solve at
    small sizes on the card, each against the same solve on the CPU."""
    import dataclasses
    from sparsh_amg_tpu_torch import AMGSolver, configs
    for name, m, method in (("poisson2d_1024_wjacobi_V_cg", 64, "amg"),
                            ("convection3d_96_pmis_extpi_V_bicgstab", 16,
                             None)):
        A, _ = configs.problem(name, m)
        b = configs.rhs(A.shape[0])
        p = configs.params(name, dense_size=256)
        kr = configs.krylov(name)
        if method:
            kr = dataclasses.replace(kr, method=method)
        on_gpu = AMGSolver(A, p, kr, device=dev).solve(b)
        on_cpu = AMGSolver(A, p, kr, device="cpu").solve(b)
        dx = np.linalg.norm(on_gpu.x - on_cpu.x) / np.linalg.norm(on_cpu.x)
        rel = [float(np.linalg.norm(b - A @ r.x) / np.linalg.norm(b))
               for r in (on_gpu, on_cpu)]
        print(f"{name}({m}) {kr.method} cuda {on_gpu} cpu {on_cpu} host "
              f"relres {rel} rel diff x {dx:.3e}", flush=True)
        assert on_gpu.converged and on_cpu.converged
        assert max(rel) <= 1e-8, rel
        assert abs(on_gpu.iterations - on_cpu.iterations) <= \
            (2 if kr.method == "bicgstab" else 1)
        assert on_gpu.refine_passes == on_cpu.refine_passes
        assert dx <= 1e-6, dx


def child_json(script, *args, timeout=600):
    """(exit code, JSON lines) of `python3 script args` run from this
    checkout's root; stderr's tail is printed when it fails."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.run([sys.executable, os.path.join(root, script), *args],
                       cwd=root, capture_output=True, text=True,
                       timeout=timeout)
    if p.returncode:
        print(f"{script} exited {p.returncode}:\n{p.stderr[-4000:]}",
              flush=True)
    return p.returncode, [json.loads(line) for line in p.stdout.splitlines()
                          if line.startswith("{")]


def bench_loop_check(tag, out):
    """A bench line's solves ran from pass graphs (built, so pass_graph_s
    > 0), one read per pass."""
    assert out["pass_graph_s"] > 0, (tag, out["pass_graph_s"])
    assert out["host_reads"] == out["refine_passes"], (tag, out)
    assert out["launches"]["loop_guard"] > 0, (tag, out["launches"])


def bench_phase(gpu_name):
    """Phase 7: bench_torch.py on the flagship and kernel_bench_torch.py,
    each as a child process.  Returns the bench's launch counts."""
    from sparsh_amg_tpu_torch import flagship
    rc, lines = child_json("bench_torch.py")
    out = lines[-1]
    print(json.dumps(out), flush=True)
    ref = flagship.REFERENCE_192
    assert rc == 0 and out["ok"], out.get("checks")
    assert [out["iterations"], out["refine_passes"]] == \
        [ref["iterations"], ref["refine_passes"]], out
    assert out["relres_host_fp64"] <= 1e-8, out
    assert out["device_name"] == gpu_name, (out["device_name"], gpu_name)
    bench_loop_check("bench_torch.py", out)
    for name in ("dia_spmv", "dia_residual", "dia_cheb_start",
                 "dia_cheb_step", "dia_cheb_last", "ell_spmv"):
        assert out["launches"][name] > 0, \
            f"{name} not launched during the bench's solves"
    rc, rows = child_json("kernel_bench_torch.py")
    for r in rows:
        print(json.dumps(r), flush=True)
    assert rc == 0, f"kernel_bench_torch.py exited {rc}"
    assert {"spmv_l0", "P_l0", "R_l0", "vcycle"} <= {r["kernel"]
                                                     for r in rows}
    assert all(r["hbm_frac"] <= 1.0 for r in rows if "hbm_frac" in r)
    return out["launches"]


# phase 8: the 4-rank runs (ranks sharing the card through gloo)
DIST_RANKS = 4
DIST_M = 96                 # launch_processes: poisson3d(96), blocked setup
NCCL_RANKS = 2              # phase 8f: NCCL ranks, one card each


def nccl_phase():
    """Phase 8f: the process-local solve on NCCL_RANKS NCCL ranks, one
    card each, from captured graphs, held against the same solve run
    eagerly.  Returns the ranks' launch counts (none with fewer cards
    than ranks)."""
    import torch
    from sparsh_amg_tpu_torch.parallel.multihost import launch_processes
    cards = torch.cuda.device_count()
    if cards < NCCL_RANKS:
        print(f"phase 8f did not run: several NCCL ranks need one card "
              f"each, and this machine has {cards}", flush=True)
        return []
    t0 = time.perf_counter()
    res = launch_processes(NCCL_RANKS, "poisson3d", DIST_M, setup="blocked",
                           device="cuda", backend="nccl",
                           compare_eager=True, timeout=600)
    for r in res:
        print(json.dumps(r), flush=True)
        assert r["backend"] == "nccl" and r["capture"], r
        assert r["converged"] and r["true_relres"] <= 1e-8, r
        assert abs(r["iterations"] - 12) <= 1 and r["passes"] == 2, r
        assert r["same_bits"], r
        assert (r["eager"]["iterations"], r["eager"]["passes"]) == \
            (r["iterations"], r["passes"]), r
        kinds = r["step_node_kinds"]
        assert kinds["kernel"] > 0 and not {"wait_event",
                                            "event_record"} & set(kinds), r
        assert r["launches"]["dia_spmv"] > 0 and \
            r["launches"]["ell_spmv"] > 0, r
        assert r["host_reads"] == r["passes"], r
        assert r["pass_graph_s"] > 0, r
        assert len(r["pass_ms"]) == r["passes"], r
        assert r["launches"]["loop_guard"] > 0, r
    assert len({(r["iterations"], r["passes"]) for r in res}) == 1, res
    print(f"phase_s 8f {time.perf_counter() - t0:.1f} launch_processes "
          f"ranks={NCCL_RANKS} backend=nccl poisson3d({DIST_M}) "
          f"iters={res[0]['iterations']} passes={res[0]['passes']} "
          f"relres={res[0]['true_relres']:.4e} same_bits=True "
          f"solve_s={max(r['solve_s'] for r in res):.4f} "
          f"eager_solve_s={max(r['eager']['solve_s'] for r in res):.4f} "
          f"pass_share={min(r['pass_share'] for r in res):.3f}", flush=True)
    return [r["launches"] for r in res]


def dist_shard_cases(rng, results, dev):
    """DIA interior and ELL kernels on one rank's blocks of the 96^3
    flagship hierarchy split over DIST_RANKS ranks (an interior rank, so
    both halos are live), against their plain versions and timed."""
    import torch
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.parallel.dist import DistDia, DistEll
    from sparsh_amg_tpu_torch.parallel.hierarchy import to_dist
    from sparsh_amg_tpu_torch.parallel.multihost import _flagship_params
    from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
    params = _flagship_params()
    hier = amg_setup(poisson3d(DIST_M), params)
    dh = to_dist(hier, 1, DIST_RANKS, params, device=dev)
    ops = [(f"{tag}{li}", getattr(l, f)) for li, l in enumerate(dh.levels)
           for f, tag in (("A", "A"), ("P", "P"), ("R", "R"))]
    ops = [(name, getattr(M, "op", M)) for name, M in ops]
    shapes = [(name, type(M).__name__, getattr(M, "mode", None),
               tuple(M.bands.shape) if isinstance(M, DistDia)
               else (M.local.k, M.n_loc) if isinstance(M, DistEll)
               else None)
              for name, M in ops]
    print(f"rank 1 of {DIST_RANKS}, poisson3d({DIST_M}): {shapes}",
          flush=True)
    dia = [(n, M) for n, M in ops if isinstance(M, DistDia)]
    ell = [(n, M) for n, M in ops if isinstance(M, DistEll)]
    assert dia and ell, shapes
    for name, M in dia:
        rows = dh.parts[int(name[1:])].count(1)
        dia_cases(f"rank 1/{DIST_RANKS} {name} interior", M.bands, M.offsets,
                  rng, results, time_it=True, n_rows=rows,
                  timed=("dia_spmv",))
    for name, M in ell:
        ell_case(f"rank 1/{DIST_RANKS} {name} {M.mode}", M.as_local(), rng,
                 results, time_it=True)
    del dh, hier
    torch.cuda.empty_cache()


def cut_halos(rank, size, whole):
    """A RankGroup with no process group whose halos are cut from `whole`,
    the vector the product multiplies; NaN at an end of the domain, so a
    launch that read a missing neighbour's entries shows it."""
    import torch
    from sparsh_amg_tpu_torch.parallel.dist import RankGroup

    @dataclasses.dataclass(frozen=True)
    class Cut(RankGroup):
        def halo_start(self, x, h):
            n = x.shape[0]
            r0 = self.rank * n
            nan = torch.full((h,), float("nan"), device=x.device)
            left = whole[r0 - h:r0] if self.rank > 0 else nan
            right = whole[r0 + n:r0 + n + h] \
                if self.rank < self.size - 1 else nan
            return lambda: (left, right)

    return Cut(rank, size)


def poisson3d_slab_bands(m, z0, z1):
    """The 7-point stencil's bands of poisson3d(m) (6 on the diagonal, -1
    towards each interior neighbour) on the rows of z-planes z0 .. z1 - 1:
    a rank's block of the fine level when the ranks split the planes."""
    i = np.arange(z0 * m * m, z1 * m * m)
    ix, iy, iz = i % m, (i // m) % m, i // (m * m)
    inside = (iz > 0, iy > 0, ix > 0, None, ix < m - 1, iy < m - 1,
              iz < m - 1)
    bands = np.zeros((7, len(i)), dtype=np.float32)
    for d, keep in enumerate(inside):
        bands[d] = 6.0 if keep is None else np.where(keep, -1.0, 0.0)
    return bands, (-m * m, -m, -1, 0, 1, m, m * m)


# the four-card cell's fine level: poisson3d(304) over four ranks, a
# rank's block of 76 z-planes (7,023,616 rows, halo 92,416)
P304, P304_RANKS = 304, 4


def dist_boundary_cases(rng, results, dev):
    """DistDia's fused products on ranks 0, 1 and 3 of poisson3d(DIST_M)
    over DIST_RANKS ranks, fp32 and bf16 bands, halos cut from the whole
    vector: each tail's local launch plus boundary launch against
    dia_fused_plain of the whole matrix on the rank's rows, two runs with
    the same bits, and bit for bit the rank's rows of one serial launch
    on the whole matrix; one launch of each, the boundary's reading no
    halo at an end the rank lacks.  Then the boundary launch of a CHEB
    step alone on rank 1's block of the four-card cell's fine level (both
    ends), against its plain version and timed."""
    import torch
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.ops import counted
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    from sparsh_amg_tpu_torch.ops.formats import csr_to_dia
    from sparsh_amg_tpu_torch.parallel.dist import (DistDia, RankGroup,
                                                    csr_to_dist)
    from sparsh_amg_tpu_torch.parallel.partition import Partition
    from sparsh_amg_tpu_torch.utils.timing import l2_flush_buffer
    A = poisson3d(DIST_M)
    part = Partition.make(A.shape[0], DIST_RANKS)
    vec = lambda k: torch.from_numpy(
        rng.standard_normal(k).astype(np.float32)).to(dev)
    v, b, x = vec(part.n_pad), vec(part.n_pad), vec(part.n_pad)
    dinv = torch.from_numpy(rng.uniform(0.1, 0.2, part.n_pad).astype(
        np.float32)).to(dev)
    for dtype, dt in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        W = csr_to_dia(A, dtype, part.n_pad, device=dev)
        P = lambda *a, **k: (lambda: K.dia_fused_plain(*a, **k))
        whole = {
            "dia_spmv": (lambda: K.dia_spmv(W.bands, v, W.offsets),
                         P(K.SPMV, W.bands, W.offsets, v)),
            "dia_residual": (
                lambda: K.dia_residual(W.bands, v, b, W.offsets),
                P(K.RESIDUAL, W.bands, W.offsets, v, b=b)),
            "dia_jacobi_sweep": (
                lambda: K.dia_jacobi_sweep(W.bands, v, b, dinv, 0.7,
                                           W.offsets),
                P(K.JACOBI, W.bands, W.offsets, v, b=b, dinv=dinv, x=v,
                  s0=0.7)),
            "dia_cheb_step": (
                lambda: K.dia_cheb_step(W.bands, x, v, b, dinv, 0.3, 0.9,
                                        W.offsets),
                P(K.CHEB, W.bands, W.offsets, v, b=b, dinv=dinv, x=x,
                  s0=0.3, s1=0.9)),
            "dia_cheb_start": (
                lambda: K.dia_cheb_start(W.bands, v, b, dinv, 1.7,
                                         W.offsets),
                P(K.CHEB_START, W.bands, W.offsets, v, b=b, dinv=dinv,
                  s0=1.7)),
            "dia_cheb_step zero": (
                lambda: K.dia_cheb_step(W.bands, None, v, b, dinv, 0.3, 0.9,
                                        W.offsets),
                P(K.CHEB, W.bands, W.offsets, v, b=b, dinv=dinv, s0=0.3,
                  s1=0.9)),
            "dia_cheb_last": (
                lambda: K.dia_cheb_last(W.bands, x, v, b, dinv, 0.3, 0.9,
                                        W.offsets),
                P(K.CHEB_LAST, W.bands, W.offsets, v, b=b, dinv=dinv, x=x,
                  s0=0.3, s1=0.9)),
            "dia_cheb_last zero": (
                lambda: K.dia_cheb_last(W.bands, None, v, b, dinv, 0.3, 0.9,
                                        W.offsets),
                P(K.CHEB_LAST, W.bands, W.offsets, v, b=b, dinv=dinv,
                  s0=0.3, s1=0.9)),
        }
        for rank in (0, 1, DIST_RANKS - 1):
            op = csr_to_dist(A, part, part, RankGroup(rank, DIST_RANKS),
                             dtype=dtype, device=dev)
            assert isinstance(op, DistDia) and op.offsets == W.offsets
            op = dataclasses.replace(op, ranks=cut_halos(rank, DIST_RANKS,
                                                         v))
            rows = slice(rank * op.n_loc, (rank + 1) * op.n_loc)
            vl, bl, dl, xl = v[rows], b[rows], dinv[rows], x[rows]
            block = {
                "dia_spmv": lambda: op.spmv(vl),
                "dia_residual": lambda: op.residual(vl, bl),
                "dia_jacobi_sweep": lambda: op.jacobi_sweep(vl, bl, dl, 0.7),
                "dia_cheb_step":
                    lambda: op.cheb_step(xl, vl, bl, dl, 0.3, 0.9),
                "dia_cheb_start": lambda: op.cheb_start(vl, bl, dl, 1.7),
                "dia_cheb_step zero":
                    lambda: op.cheb_step(None, vl, bl, dl, 0.3, 0.9),
                "dia_cheb_last":
                    lambda: op.cheb_last(xl, vl, bl, dl, 0.3, 0.9),
                "dia_cheb_last zero":
                    lambda: op.cheb_last(None, vl, bl, dl, 0.3, 0.9),
            }
            ends = K.boundary_rows(op.offsets, op.n_loc, rank > 0,
                                   rank < DIST_RANKS - 1)
            for name, product in block.items():
                serial, plain = whole[name]
                got, launches = counted(product)
                want = serial()
                torch.cuda.synchronize()
                launched = {w: c for w, c in launches.items() if c}
                if launched != {name.split()[0]: 1, "dia_fused_boundary": 1}:
                    raise AssertionError(f"{name} rank {rank}: launched "
                                         f"{launched}")
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                serial_bits = all(torch.equal(g, w[rows])
                                  for g, w in zip(got, want, strict=True))
                compare(f"dia_fused_boundary {name} rank {rank}/"
                        f"{DIST_RANKS} poisson3d({DIST_M}) {dt} "
                        f"n_loc={op.n_loc}", product,
                        lambda: tuple(t[rows] for t in (
                            plain() if isinstance(plain(), tuple)
                            else (plain(),))),
                        results, time_it=False, same_bits=True,
                        extra={"serial_same_bits": serial_bits,
                               "boundary_rows": list(ends), "h": op.h})
                if not serial_bits:
                    raise AssertionError(
                        f"{name} rank {rank} {dt}: the rank's rows differ "
                        f"from the serial launch on the whole matrix")
        del W
    del v, b, x, dinv
    torch.cuda.empty_cache()

    # the boundary launch alone at the four-card cell's rank-block shape
    planes = P304 // P304_RANKS
    bands, offs = poisson3d_slab_bands(P304, planes, 2 * planes)
    n, h = bands.shape[1], P304 * P304
    bands = torch.from_numpy(bands).to(dev).to(torch.bfloat16)
    d, r, x, left, right = vec(n), vec(n), vec(n), vec(h), vec(h)
    dinv = torch.full((n,), 1 / 6, device=dev)
    outs, plain_outs = ([torch.zeros(n, device=dev) for _ in range(3)]
                        for _ in range(2))
    lo_rows, hi_row = K.boundary_rows(offs, n, True, True)
    rows = lo_rows + n - hi_row
    nz = int(torch.count_nonzero(bands[:, :lo_rows])
             + torch.count_nonzero(bands[:, hi_row:]))
    # the band table's boundary rows, the tail's vectors there (CHEB: d,
    # r, dinv, x read; x', r', d' written) and both halos read once
    real = (bands.element_size() * len(offs) * rows
            + 4 * rows * DIA_VECTORS["dia_cheb_step"] + 4 * 2 * h)

    for tail, tag, wrapper, n_out in (
            (K.CHEB, "CHEB", "dia_cheb_step", 3),
            (K.CHEB_LAST, "CHEB_LAST", "dia_cheb_last", 1)):
        if tail == K.CHEB_LAST:
            # CHEB_LAST writes x + d + d' alone: x', r', d' not written
            real -= 4 * rows * (DIA_VECTORS["dia_cheb_step"]
                                - DIA_VECTORS[wrapper])

        def kernel(tail=tail, n_out=n_out):
            K.dia_fused_boundary(tail, bands, offs, d, left, right,
                                 outs[:n_out], True, True, b=r, dinv=dinv,
                                 x=x, s0=0.3, s1=0.9)
            return tuple(outs[:n_out])

        def plain(tail=tail, n_out=n_out):
            K.dia_boundary_plain(tail, bands, offs, d, left, right,
                                 plain_outs[:n_out], True, True, b=r,
                                 dinv=dinv, x=x, s0=0.3, s1=0.9)
            return tuple(plain_outs[:n_out])

        compare(f"dia_fused_boundary p3d{P304}x{P304_RANKS} rank 1/"
                f"{P304_RANKS} L0 {tag} bf16 n_loc={n} h={h}", kernel,
                plain, results, True, work=(real, real, 2 * nz),
                same_bits=True, flush=l2_flush_buffer(real), graph=True,
                library=("none: the JAX package corrects the boundary rows "
                         "with plain slices", {}),
                extra={"boundary_rows": [lo_rows, hi_row], "h": h})
    del bands, d, r, x, dinv, outs, plain_outs
    torch.cuda.empty_cache()


def dist_phase(gpu_name, rng, results, dev):
    """Phase 8: the distributed solver in child processes.  Returns the
    launch counts of every rank's solves."""
    import graft_entry_torch
    import torch
    from sparsh_amg_tpu_torch import flagship
    from sparsh_amg_tpu_torch.parallel.multihost import launch_processes
    from sparsh_amg_tpu_torch.parallel.solver import check_backend
    paths = []
    # (a) the bench line on one NCCL rank
    t0 = time.perf_counter()
    rc, lines = child_json("bench_torch.py", "--dist", "1")
    out = lines[-1]
    print(json.dumps(out), flush=True)
    ref = flagship.REFERENCE_192
    assert rc == 0 and out["ok"], out.get("checks")
    assert (out["dist_ranks"], out["dist_backend"]) == (1, "nccl"), out
    assert [out["iterations"], out["refine_passes"]] == \
        [ref["iterations"], ref["refine_passes"]], out
    assert out["relres_host_fp64"] <= 1e-8, out
    assert out["device_name"] == gpu_name, (out["device_name"], gpu_name)
    bench_loop_check("bench_torch.py --dist 1", out)
    # one rank's DistDia takes the serial fused products: no boundary
    for name in ("dia_spmv", "dia_cheb_step", "ell_spmv"):
        assert out["launches"][name] > 0, \
            f"{name} not launched during the --dist 1 bench's solves"
    assert out["launches"]["dia_fused_boundary"] == 0, out["launches"]
    paths.append(out["launches"])
    print(f"phase_s 8a {time.perf_counter() - t0:.1f} bench --dist 1 nccl "
          f"iters={out['iterations']} passes={out['refine_passes']} "
          f"relres={out['relres_host_fp64']:.4e} solve_s={out['solve_s']} "
          f"pass_graph_s={out['pass_graph_s']}", flush=True)

    # (b) the dry run: 4 ranks sharing the card through gloo
    t0 = time.perf_counter()
    ranks = graft_entry_torch.dryrun_multichip(DIST_RANKS, "cuda", "gloo")
    for key in ("global", "blocked"):
        runs = [r[key] for r in ranks]
        assert all(abs(r["iterations"] - 12) <= 1 for r in runs), runs
        assert all(r["relres_host_fp64"] <= 1e-8 for r in runs), runs
        for r in runs:
            for name in ("dia_spmv", "dia_cheb_step", "dia_fused_boundary",
                         "ell_spmv"):
                assert r["launches"][name] > 0, (name, r)
            paths.append(r["launches"])
    print(json.dumps({"dryrun_multichip": [
        {k: r[k] for k in ("rank", "ranks", "backend", "device", "global",
                           "blocked")} for r in ranks]}), flush=True)
    print(f"phase_s 8b {time.perf_counter() - t0:.1f} dryrun_multichip "
          f"ranks={DIST_RANKS} backend=gloo "
          f"iters={ranks[0]['global']['iterations']}/"
          f"{ranks[0]['blocked']['iterations']}", flush=True)

    # (c) the process-local solve at 96^3 on 4 gloo ranks
    t0 = time.perf_counter()
    res = launch_processes(DIST_RANKS, "poisson3d", DIST_M, setup="blocked",
                           device="cuda", backend="gloo")
    for r in res:
        print(json.dumps(r), flush=True)
        assert r["converged"] and r["true_relres"] <= 1e-8, r
        assert abs(r["iterations"] - 12) <= 1 and r["passes"] == 2, r
        assert not r["holds_global_fine"] and r["backend"] == "gloo", r
        assert r["launches"]["dia_spmv"] > 0 and \
            r["launches"]["ell_spmv"] > 0, r
        paths.append(r["launches"])
    hi = 0
    for r in res:
        assert r["row_range"][0] == hi, [r["row_range"] for r in res]
        hi = r["row_range"][1]
    assert hi == res[0]["n"] == DIST_M ** 3
    print(f"phase_s 8c {time.perf_counter() - t0:.1f} launch_processes "
          f"ranks={DIST_RANKS} backend=gloo poisson3d({DIST_M}) blocked "
          f"iters={res[0]['iterations']} passes={res[0]['passes']} "
          f"relres={res[0]['true_relres']:.4e} "
          f"setup_s={max(r['setup_s'] for r in res):.2f} "
          f"solve_s={max(r['solve_s'] for r in res):.4f}", flush=True)

    # (d) NCCL refuses more ranks than cards
    try:
        check_backend("nccl", torch.cuda.device_count() + 1, dev)
    except ValueError as e:
        assert "gloo" in str(e), e
        print(f"nccl with {torch.cuda.device_count() + 1} ranks: refused "
              f"({e})", flush=True)
    else:
        raise AssertionError("nccl with more ranks than cards was accepted")

    # (e) the kernels at rank-block shapes
    t0 = time.perf_counter()
    dist_shard_cases(rng, results, dev)
    dist_boundary_cases(rng, results, dev)
    print(f"phase_s 8e {time.perf_counter() - t0:.1f}", flush=True)

    # (f) NCCL ranks, one card each, capturing their loop
    paths.extend(nccl_phase())
    return paths


def main(nside=192, dev="cuda"):
    # -- 1. environment ----------------------------------------------------
    t_start = time.perf_counter()
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "test needs an NVIDIA GPU")
    from sparsh_amg_tpu_torch.utils.meminfo import card_name_and_power_limit
    gpu_name, _, gpu_line = card_name_and_power_limit()
    print(gpu_line, flush=True)
    from sparsh_amg_tpu_torch import _build
    print(run([_build.nvcc_path(), "--version"]).splitlines()[-1], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    print(f"build_s {time.perf_counter() - t0:.2f} {so}", flush=True)

    from sparsh_amg_tpu_torch import AMGSolver, flagship
    from sparsh_amg_tpu_torch._native import get_lib
    from sparsh_amg_tpu_torch.ops import counted
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.utils.meminfo import device_memory_stats
    from sparsh_amg_tpu_torch.ops.block_ell import csr_to_block_ell
    from sparsh_amg_tpu_torch.systems import random_blocks
    from sparsh_amg_tpu_torch.ops.formats import (csr_to_dia, csr_to_ell,
                                                  DiaMatrix, EllMatrix)
    from sparsh_amg_tpu_torch.ops.fp64 import csr_to_fp64
    import scipy.sparse as sp
    print(f"native setup library: {get_lib() is not None}", flush=True)

    # -- 3. kernels against their plain versions ---------------------------
    rng = np.random.default_rng(1)
    small = []
    offs = [-300, -129, -127, -5, 0, 3, 127, 128, 301]   # wide bands
    W = sp.diags([rng.standard_normal(1000) for _ in offs], offs,
                 shape=(1000, 1000), format="csr")
    for dt in (torch.float32, torch.bfloat16):
        for tag, M in (("poisson3d(16)", poisson3d(16)), ("wide-band", W)):
            D = csr_to_dia(M, dt, 2048, device=dev)
            dia_cases(tag, D.bands, D.offsets, rng, small, time_it=False)
            if dt == torch.float32:
                finish_case(tag, csr_to_fp64(M, device=dev), rng, small,
                            time_it=False)
        R = sp.random(300, 450, density=0.05, random_state=4, format="csr")
        E = sp.csr_matrix((np.array([2.0, 3.0, 4.0]),
                           (np.array([0, 0, 5]), np.array([1, 7, 3]))),
                          shape=(9, 11))
        # the rule's packing, then T lanes x V slots per load of every
        # family of the kernel, unsorted and sorted rows
        for tag, M in (("random 300x450", R), ("empty rows 9x11", E)):
            for pack in ({}, dict(lanes=2, vec=1, sigma=1),
                         dict(lanes=4, vec=4, sigma=64),
                         dict(lanes=32, vec=1, sigma=4096)):
                ell_case(tag, csr_to_ell(M, dt, 2048, device=dev, **pack),
                         rng, small, time_it=False)
        for bs in (2, 3, 6):
            block_case("random with holes", csr_to_block_ell(
                random_blocks(700, bs, bs), bs, dt, device=dev), rng, small,
                time_it=False)
    long_row_cases(rng, small, dev)

    t0 = time.perf_counter()
    A = poisson3d(nside)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    solver = AMGSolver(A, flagship.params(), flagship.krylov(), device=dev)
    setup_peak = device_memory_stats(dev).get("peak_bytes_in_use")
    levels = solver.device.levels
    kinds = [(type(l.A).__name__, l.n,
              getattr(l.A, "k", None) or len(getattr(l.A, "offsets", ())))
             for l in levels]
    shapes = launch_shapes(levels)
    print(f"poisson3d({nside}) n={A.shape[0]} nnz={A.nnz} gen_s={gen_s:.2f} "
          f"setup_s={solver.setup_time:.2f} levels={kinds} "
          f"launch_shapes={shapes}", flush=True)
    L0 = levels[0]
    assert isinstance(L0.A, DiaMatrix) and L0.A.bands.dtype == torch.bfloat16
    assert isinstance(L0.P, EllMatrix) and isinstance(L0.R, EllMatrix)
    assert isinstance(levels[1].A, EllMatrix)
    flag = []
    dia_cases("L0 Krylov operator", solver.A32.bands, solver.A32.offsets,
              rng, flag, time_it=True, n_rows=A.shape[0])
    dia_cases("L0 cycle operator", L0.A.bands, L0.A.offsets, rng, flag,
              time_it=True, n_rows=A.shape[0])
    finish_case("p3d L0", solver.A64, rng, flag, time_it=True,
                n_rows=A.shape[0])
    operator_cases("", levels, rng, flag, timed={"P0", "R0", "A1"})
    guard_cases(flag, dev)

    # -- 4. the flagship solve ---------------------------------------------
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    rhs = solver.prepare_rhs(b)
    solver.solve(rhs)                                   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, launches = counted(lambda: solver.solve(rhs))
    solve_peak = device_memory_stats(dev).get("peak_bytes_in_use")
    x = res.x
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    repeats = [solver.solve(rhs).solve_time for _ in range(REPEATS)]
    per_op = calls_per_operator(lambda: uncaptured(solver).solve(rhs),
                                levels)
    stats = {
        "setup_s": solver.setup_time, "solve_s": res.solve_time,
        "solve_s_repeats": repeats, "spmv_calls_per_operator": per_op,
        "iterations": res.iterations, "refine_passes": res.refine_passes,
        "jax_reference": flagship.REFERENCE_192,
        "levels": solver.hierarchy.n_levels,
        "operator_complexity": solver.hierarchy.operator_complexity(),
        "device_bytes": solver.device_bytes(),
        "setup_peak_bytes": setup_peak, "solve_peak_bytes": solve_peak,
        "relres_host_fp64": relres, "relres_solver": res.relres,
        "converged": res.converged, "history": res.history,
        "launches": launches, "launch_shapes": shapes}
    print(json.dumps(stats), flush=True)
    assert x.shape == (A.shape[0],) and np.isfinite(x).all()
    assert res.converged and relres <= 1e-8, (res, relres)
    for name in ("dia_spmv", "dia_residual", "dia_cheb_start",
                 "dia_cheb_step", "dia_cheb_last", "ell_spmv"):
        assert launches[name] > 0, f"{name} not launched during the solve"
    pass_graph_check("poisson3d", solver, res, launches)
    t0 = time.perf_counter()
    loop_phase(solver, rhs)
    print(f"phase_s 4b {time.perf_counter() - t0:.1f}", flush=True)

    # a small solve on the card against the same solve on the CPU (the
    # plain versions, which the CPU tests hold to the JAX package)
    As = poisson3d(24)
    bs = np.random.default_rng(0).standard_normal(As.shape[0])
    p_small = flagship.params(dense_size=256)
    on_gpu = AMGSolver(As, p_small, flagship.krylov(),
                       device=dev).solve(bs)
    on_cpu = AMGSolver(As, p_small, flagship.krylov(),
                       device="cpu").solve(bs)
    dx = np.linalg.norm(on_gpu.x - on_cpu.x) / np.linalg.norm(on_cpu.x)
    print(f"poisson3d(24) cuda {on_gpu} cpu {on_cpu} rel diff x {dx:.3e}",
          flush=True)
    assert on_gpu.converged and on_cpu.converged
    assert abs(on_gpu.iterations - on_cpu.iterations) <= 1
    assert on_gpu.refine_passes == on_cpu.refine_passes
    assert dx <= 1e-7, dx
    del solver, levels, L0, rhs

    print(f"phase_s 1-4 {time.perf_counter() - t_start:.1f}", flush=True)

    # -- 5. the systems path ------------------------------------------------
    t0 = time.perf_counter()
    sysk = []
    paths = [launches]
    for dim in (3, 2):
        paths.append(systems_phase(dim, rng, sysk, dev))
    systems_small_check(dev)
    print(f"phase_s 5 {time.perf_counter() - t0:.1f}", flush=True)

    # -- 6. the scalar configurations ----------------------------------------
    from sparsh_amg_tpu_torch import configs
    t0 = time.perf_counter()
    cfgk = []
    for name in configs.NAMES:
        paths.append(config_phase(name, rng, cfgk, dev))
        torch.cuda.empty_cache()
    config_small_checks(dev)
    print(f"phase_s 6 {time.perf_counter() - t0:.1f}", flush=True)

    # -- 7. the bench entry points -------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    paths.append(bench_phase(gpu_name))
    print(f"phase_s 7 {time.perf_counter() - t0:.1f}", flush=True)

    # -- 8. the distributed solver ---------------------------------------------
    t0 = time.perf_counter()
    distk = []
    paths.extend(dist_phase(gpu_name, rng, distk, dev))
    print(f"phase_s 8 {time.perf_counter() - t0:.1f}", flush=True)

    # -- result lines ------------------------------------------------------
    every = small + flag + sysk + cfgk + distk
    total = {k: sum(p[k] for p in paths) for k in launches}
    # the bounds again at the copy rate measured on this card
    from sparsh_amg_tpu_torch.utils.timing import copy_bandwidth
    copy_bw = copy_bandwidth(dev)
    for c in every:
        if "real_bytes" in c:
            c["bound_measured_ms"] = max(c["real_bytes"] / copy_bw,
                                         c["flops"] / FP32_FLOPS_PER_S) * 1e3

    keep = ("case", "ms", "plain_ms", "call_ms", "bound_ms", "bound_by",
            "bound_measured_ms", "library_ms", "library_bf16_ms",
            "library_note", "real_bytes", "padded_bytes", "max_rel_err",
            "same_bits", "instantiation", "l2_flushed", "graph_ms", "W",
            "T", "G", "S")

    def entry(name, source, cases, timed, replaces):
        errs = [c["max_abs_err"] for c in every
                if c["case"].split()[0] in cases]
        timed_cases = [c for c in flag + sysk + cfgk + distk
                       if c["case"].split()[0] in cases and "ms" in c]
        t = next(c for c in timed_cases if c["case"].startswith(timed))
        return {"name": name, "route": "cuda",
                "source": f"sparsh_amg_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(total[c] for c in cases),
                "max_abs_err": max(errs), "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "bound_measured_ms": t["bound_measured_ms"],
                "copy_bw_GBs": copy_bw / 1e9,
                "library_ms": t["library_ms"],
                "case": t["case"],
                "cases": [{k: c[k] for k in keep if k in c}
                          for c in timed_cases]}

    fused = ("dia_residual", "dia_jacobi_sweep", "dia_cheb_step",
             "dia_cheb_start", "dia_cheb_last")
    kernels = [
        entry("dia_spmv", "dia_spmv.cu", ("dia_spmv",),
              "dia_spmv L0 Krylov operator fp32",
              "sparsh_amg_tpu/ops/pallas_spmv.py:285"),
        entry("dia_fused", "dia_spmv.cu", fused,
              "dia_cheb_step L0 cycle operator bf16",
              "sparsh_amg_tpu/ops/pallas_spmv.py:132"),
        # the port's own: a rank block's boundary rows, plain slices in
        # the JAX package
        entry("dia_fused_boundary", "dia_spmv.cu", ("dia_fused_boundary",),
              f"dia_fused_boundary p3d{P304}x{P304_RANKS}",
              "sparsh_amg_tpu/parallel/dist.py:137"),
        entry("ell_spmv", "ell_spmv.cu", ("ell_spmv",), "ell_spmv R0",
              "sparsh_amg_tpu/ops/gell.py:266"),
        entry("block_ell_spmv", "block_ell_spmv.cu", ("block_ell_spmv",),
              "block_ell_spmv e3d L0 fp32",
              "sparsh_amg_tpu/ops/block_gell.py:147"),
        # the port's own: the refinement pass's finish, plain XLA in the
        # JAX package (no Pallas kernel)
        entry("dia_finish64", "dia_finish64.cu", ("dia_finish64",),
              "dia_finish64 p3d L0", "sparsh_amg_tpu/ops/df64_ops.py:136"),
        # the port's own: the condition of the JAX device mode's
        # lax.while_loop, a traced predicate there and no Pallas kernel
        entry("loop_guard", "graph_loop.cu", ("loop_guard",),
              "loop_guard cg active", "sparsh_amg_tpu/solve/krylov.py:73"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
