#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. environment: GPU name and power limit, torch/CUDA/nvcc versions;
  2. build the CUDA kernels from sparsh_amg_tpu_torch/csrc/;
  3. every kernel entry against its plain PyTorch version on the card, at a
     small size and at the flagship's shapes: max errors and median times;
  4. the flagship solve, poisson3d(192) (7,077,888 unknowns), through
     AMGSolver, with kernel launch counts from that solve, the residual
     recomputed on the host in fp64, and a small solve on the card held
     against the same solve on the CPU;
  5. the systems path (smoothed aggregation, rigid-body modes, block
     levels): elasticity3d(40) and elasticity2d(512), each with the block
     kernel (fp32 and bf16) and the ELL kernel held against their plain
     versions at the hierarchy's shapes, then primed at tol 1e-2 and
     solved to 1e-8 with launch counts from that solve; and a small
     elasticity3d(8) solve on the card held against the CPU.
Every solve resets the launch counts just before it and reads them just
after.  The line before the last is one JSON object with the kernels'
errors, times and launch counts; the last line is
{"ok": true, "device": {...}}.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np

REL_TOL = 1e-5      # kernel vs plain version: same inputs, fp32 sums in
                    # another order (and FMA contraction) on both sides
TIMED_RUNS = 25
SLEEP_CYCLES = 50_000_000   # ~30 ms of device sleep ahead of timed runs
SMALL_E3D = 8               # elasticity3d size of the card-vs-CPU check


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          check=True).stdout.strip()


def timed_ms(fn, queued=True):
    """Median of TIMED_RUNS launches, each between two CUDA events.  With
    `queued`, the runs wait behind a device sleep until the host has
    queued them all, so the events see device time alone; without it,
    each run is timed as the host launches it, Python and launch overhead
    included (the floor of a small kernel inside the solve)."""
    import torch
    fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    events = []
    for _ in range(TIMED_RUNS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in events)


def compare(name, kernel, plain, results, time_it=True):
    """Kernel output(s) against the plain version's; raise above REL_TOL.
    Records max_abs_err, max_rel_err (normwise), both median device
    times, and the kernel's time per call as the host launches it."""
    import torch
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_err = rel_err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: bad output {tuple(g.shape)}")
        e = (g.double() - w.double()).abs().max().item()
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / max(w.double().abs().max().item(), 1e-30))
    rec = {"case": name, "max_abs_err": abs_err, "max_rel_err": rel_err}
    if time_it:
        rec["ms"], rec["plain_ms"] = timed_ms(kernel), timed_ms(plain)
        rec["call_ms"] = timed_ms(kernel, queued=False)
    results.append(rec)
    print(json.dumps(rec), flush=True)
    if not rel_err <= REL_TOL:
        raise AssertionError(f"{name}: rel err {rel_err:.3e} > {REL_TOL}")
    return rec


def dia_cases(tag, bands, offsets, rng, results, time_it):
    """All five tails of the DIA kernel on one band table."""
    import torch
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    n = bands.shape[1]
    vec = lambda: torch.from_numpy(
        rng.standard_normal(n).astype(np.float32)).to(bands.device)
    x, b, d, r = vec(), vec(), vec(), vec()
    dinv = torch.from_numpy(
        rng.uniform(0.1, 0.2, n).astype(np.float32)).to(bands.device)
    P = lambda *a, **k: (lambda: K.dia_fused_plain(*a, **k))
    cases = [
        ("dia_spmv", lambda: K.dia_spmv(bands, x, offsets),
         P(K.SPMV, bands, offsets, x)),
        ("dia_residual", lambda: K.dia_residual(bands, x, b, offsets),
         P(K.RESIDUAL, bands, offsets, x, b=b)),
        ("dia_dinv_residual",
         lambda: K.dia_dinv_residual(bands, x, b, dinv, offsets),
         P(K.DINV_RESIDUAL, bands, offsets, x, b=b, dinv=dinv)),
        ("dia_jacobi_sweep",
         lambda: K.dia_jacobi_sweep(bands, x, b, dinv, 0.7, offsets),
         P(K.JACOBI, bands, offsets, x, b=b, dinv=dinv, x=x, s0=0.7)),
        ("dia_cheb_step",
         lambda: K.dia_cheb_step(bands, x, d, r, dinv, 0.3, 0.9, offsets),
         P(K.CHEB, bands, offsets, d, b=r, dinv=dinv, x=x, s0=0.3, s1=0.9)),
    ]
    dt = "bf16" if bands.dtype == torch.bfloat16 else "fp32"
    for name, kern, plain in cases:
        compare(f"{name} {tag} {dt} n_pad={n}", kern, plain, results, time_it)


def ell_case(tag, M, rng, results, time_it):
    import torch
    from sparsh_amg_tpu_torch.ops.ell_spmv import ell_plain, ell_spmv
    x = torch.from_numpy(
        rng.standard_normal(max(M.n_cols, 1)).astype(np.float32)).to(
        M.cols.device)
    dt = "bf16" if M.vals.dtype == torch.bfloat16 else "fp32"
    compare(f"ell_spmv {tag} {dt} K={M.k} n_pad={M.n_pad}",
            lambda: ell_spmv(M.cols, M.vals, x),
            lambda: ell_plain(M.cols, M.vals, x), results, time_it)


def block_case(tag, M, rng, results, time_it):
    """The block kernel against its plain version on one table; records
    the table's bytes and the kernel's rate when timed."""
    import torch
    from sparsh_amg_tpu_torch.ops.block_ell import (block_ell_plain,
                                                    block_ell_spmv)
    x = torch.from_numpy(
        rng.standard_normal(M.n_pad).astype(np.float32)).to(M.cols.device)
    dt = "bf16" if M.vals.dtype == torch.bfloat16 else "fp32"
    rec = compare(f"block_ell_spmv {tag} {dt} bs={M.bs} K={M.k} "
                  f"n={M.n_rows} n_pad={M.n_pad}",
                  lambda: block_ell_spmv(M.cols, M.vals, x),
                  lambda: block_ell_plain(M.cols, M.vals, x), results,
                  time_it)
    if time_it:
        nbytes = (M.vals.nbytes + M.cols.nbytes + 4 * M.n_pad
                  + 4 * M.n_cols)
        print(json.dumps({"case": rec["case"], "bytes": nbytes,
                          "TB_per_s": nbytes / rec["ms"] / 1e9}), flush=True)


def counted(fn):
    """fn() with every kernel wrapper's launch count set to 0 just before
    and read just after."""
    from sparsh_amg_tpu_torch.ops import dia_spmv as dia_mod
    from sparsh_amg_tpu_torch.ops.block_ell import block_ell_spmv
    from sparsh_amg_tpu_torch.ops.ell_spmv import ell_spmv
    wrappers = (*dia_mod.WRAPPERS, ell_spmv, block_ell_spmv)
    for w in wrappers:
        w.launches = 0
    out = fn()
    return out, {w.__name__: w.launches for w in wrappers}


def systems_phase(dim, rng, results, dev):
    """Phase 5 for one elasticity configuration: kernels at the
    hierarchy's shapes, then the primed solve to 1e-8.  Returns the
    solve's launch counts."""
    import dataclasses
    import torch
    from sparsh_amg_tpu_torch import AMGSolver, systems
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
              getattr(l.A, "k", None)) for l in levels]
    print(f"{name} n={A.shape[0]} nnz={A.nnz} setup_s={solver.setup_time:.2f}"
          f" levels={kinds} mv_from_level0={solver.mv_from_level0}",
          flush=True)
    blocks = [(li, l.A) for li, l in enumerate(levels)
              if isinstance(l.A, BlockEllMatrix)]
    if dim == 3:
        assert [li for li, _ in blocks] == [0, 1, 2], kinds
        assert solver.mv_from_level0
    else:
        assert isinstance(levels[0].A, DiaMatrix), kinds
        assert [li for li, _ in blocks] == [1, 2], kinds
    tag = f"e{dim}d"
    for li, M in blocks:
        block_case(f"{tag} L{li}", M, rng, results, time_it=True)
        block_case(f"{tag} L{li}", dataclasses.replace(
            M, vals=M.vals.to(torch.bfloat16)), rng, results, time_it=True)
    if dim == 3:
        for li in range(3):
            assert isinstance(levels[li].R, EllMatrix)
            ell_case(f"{tag} R{li}", levels[li].R, rng, results, time_it=True)

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
    ref = systems.REFERENCE[name]
    print(json.dumps({
        "config": name, "setup_s": solver.setup_time,
        "solve_s": res.solve_time, "iterations": res.iterations,
        "refine_passes": res.refine_passes, "jax_reference": ref,
        "levels": solver.hierarchy.n_levels,
        "operator_complexity": solver.hierarchy.operator_complexity(),
        "device_bytes": solver.device_bytes(),
        "setup_peak_bytes": setup_peak, "solve_peak_bytes": solve_peak,
        "relres_host_fp64": relres, "relres_solver": res.relres,
        "converged": res.converged, "history": res.history,
        "mv_from_level0": solver.mv_from_level0, "launches": launches}),
        flush=True)
    assert x.shape == (A.shape[0],) and np.isfinite(x).all()
    assert res.converged and relres <= 1e-8, (res, relres)
    # the JAX package's CPU counts; e2d's four passes sit at the fp32
    # floor, hence +-2 there
    want, slack = ref["cpu"], (1 if dim == 3 else 2)
    assert abs(res.iterations - want["iterations"]) <= slack, (res, want)
    assert res.refine_passes == want["refine_passes"], (res, want)
    assert launches["block_ell_spmv"] > 0 and launches["ell_spmv"] > 0
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


def main(nside=192, dev="cuda"):
    # -- 1. environment ----------------------------------------------------
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "test needs an NVIDIA GPU")
    gpu_line = run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
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
    from sparsh_amg_tpu_torch._host import get_lib, poisson3d
    from sparsh_amg_tpu_torch.utils.meminfo import device_memory_stats
    from sparsh_amg_tpu_torch.ops.block_ell import csr_to_block_ell
    from sparsh_amg_tpu_torch.systems import random_blocks
    from sparsh_amg_tpu_torch.ops.formats import (csr_to_dia, csr_to_ell,
                                                  DiaMatrix, EllMatrix)
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
        R = sp.random(300, 450, density=0.05, random_state=4, format="csr")
        E = sp.csr_matrix((np.array([2.0, 3.0, 4.0]),
                           (np.array([0, 0, 5]), np.array([1, 7, 3]))),
                          shape=(9, 11))
        for tag, M in (("random 300x450", R), ("empty rows 9x11", E)):
            ell_case(tag, csr_to_ell(M, dt, 2048, device=dev), rng, small,
                     time_it=False)
        for bs in (2, 3, 6):
            block_case("random with holes", csr_to_block_ell(
                random_blocks(700, bs, bs), bs, dt, device=dev), rng, small,
                time_it=False)

    t0 = time.perf_counter()
    A = poisson3d(nside)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    solver = AMGSolver(A, flagship.params(), flagship.krylov(), device=dev)
    setup_peak = device_memory_stats(dev).get("peak_bytes_in_use")
    levels = solver.device.levels
    kinds = [(type(l.A).__name__, l.n, getattr(l.A, "k", None))
             for l in levels]
    print(f"poisson3d({nside}) n={A.shape[0]} nnz={A.nnz} gen_s={gen_s:.2f} "
          f"setup_s={solver.setup_time:.2f} levels={kinds}", flush=True)
    L0 = levels[0]
    assert isinstance(L0.A, DiaMatrix) and L0.A.bands.dtype == torch.bfloat16
    assert isinstance(L0.P, EllMatrix) and isinstance(L0.R, EllMatrix)
    assert isinstance(levels[1].A, EllMatrix)
    flag = []
    dia_cases("L0 Krylov operator", solver.A32.bands, solver.A32.offsets,
              rng, flag, time_it=True)
    dia_cases("L0 cycle operator", L0.A.bands, L0.A.offsets, rng, flag,
              time_it=True)
    for tag, M in (("P0", L0.P), ("R0", L0.R), ("A1", levels[1].A)):
        ell_case(tag, M, rng, flag, time_it=True)

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
    stats = {
        "setup_s": solver.setup_time, "solve_s": res.solve_time,
        "iterations": res.iterations, "refine_passes": res.refine_passes,
        "jax_reference": flagship.REFERENCE_192,
        "levels": solver.hierarchy.n_levels,
        "operator_complexity": solver.hierarchy.operator_complexity(),
        "device_bytes": solver.device_bytes(),
        "setup_peak_bytes": setup_peak, "solve_peak_bytes": solve_peak,
        "relres_host_fp64": relres, "relres_solver": res.relres,
        "converged": res.converged, "history": res.history,
        "launches": launches}
    print(json.dumps(stats), flush=True)
    assert x.shape == (A.shape[0],) and np.isfinite(x).all()
    assert res.converged and relres <= 1e-8, (res, relres)
    for name in ("dia_spmv", "dia_residual", "dia_dinv_residual",
                 "dia_cheb_step", "ell_spmv"):
        assert launches[name] > 0, f"{name} not launched during the solve"

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

    # -- 5. the systems path ------------------------------------------------
    sysk = []
    paths = [launches]
    for dim in (3, 2):
        paths.append(systems_phase(dim, rng, sysk, dev))
    systems_small_check(dev)

    # -- result lines ------------------------------------------------------
    every = small + flag + sysk
    total = {k: sum(p[k] for p in paths) for k in launches}

    def entry(name, source, cases, timed, replaces):
        errs = [c["max_abs_err"] for c in every
                if c["case"].split()[0] in cases]
        t = next(c for c in flag + sysk if c["case"].startswith(timed))
        return {"name": name, "route": "cuda",
                "source": f"sparsh_amg_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(total[c] for c in cases),
                "max_abs_err": max(errs), "ms": t["ms"],
                "plain_ms": t["plain_ms"]}

    fused = ("dia_residual", "dia_dinv_residual", "dia_jacobi_sweep",
             "dia_cheb_step")
    kernels = [
        entry("dia_spmv", "dia_spmv.cu", ("dia_spmv",),
              "dia_spmv L0 Krylov operator fp32",
              "sparsh_amg_tpu/ops/pallas_spmv.py:285"),
        entry("dia_fused", "dia_spmv.cu", fused,
              "dia_cheb_step L0 cycle operator bf16",
              "sparsh_amg_tpu/ops/pallas_spmv.py:132"),
        entry("ell_spmv", "ell_spmv.cu", ("ell_spmv",), "ell_spmv R0",
              "sparsh_amg_tpu/ops/gell.py:265"),
        entry("block_ell_spmv", "block_ell_spmv.cu", ("block_ell_spmv",),
              "block_ell_spmv e3d L0 fp32",
              "sparsh_amg_tpu/ops/block_gell.py:146"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
