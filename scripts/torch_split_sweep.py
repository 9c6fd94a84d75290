#!/usr/bin/env python3
"""Device time of the ELL and block-ELL kernels on the operators of the
solves, for one checkout of the port, and (--sweep) under every packing
and launch shape.

    python3 scripts/torch_split_sweep.py [--root DIR] [--sweep]
        [--cases p3d c3d delaunay e3d rank e3d-block e2d-block]
        [--dtypes fp32 bf16] [--cache DIR]

The operators: the flagship poisson3d(192)'s P0, R0 and A1 (bf16),
convection3d(96)'s R0 and delaunay(1024^2)'s fine level (fp32),
elasticity3d(40)'s SA transfers R0-R2 (fp32, the long rows that the
split-row launch serves), and (case "rank") the ELL blocks of rank 1 of
4 of the poisson3d(96) flagship hierarchy (bf16, their columns indexing
the extended or gathered source); for the block kernel (cases
"e3d-block", "e2d-block"), the levels that ``to_device`` stores as
block-ELL (bs > 1, more rows than the dense threshold): elasticity3d(40)'s
L0-L2 and elasticity2d(512)'s L1-L2 (e2d's L0 is a DIA table), in each
of --dtypes.  Their host CSR matrices come from the port's host setup
(RCM first where the configuration asks for it, as AMGSolver does; the
rank blocks from ``parallel.hierarchy.to_dist``), kept in --cache as
.npz so that later runs, of any checkout, time the same matrices.  The
first line gives the card, the copy rate measured in the run and the
launch floor (a one-element add timed with and without an L2 flush and
as a graph replay).

For each operator, one JSON line: the checkout's own ELL layout
(``csr_to_ell`` with its defaults) and kernel (``EllMatrix.spmv``), its
median device time (25 launches queued behind a device sleep, as
chip_smoke.py times kernels), the least time the card could take
(``bound_ms``: the real slots, x and y once, at 3.35 TB/s), stored bytes
over real ones, and one cuSPARSE CSR SpMV of the same matrix
(``library_ms``, fp32 values; the port never calls it).  With --sweep
(the sliced layout only), every lanes-per-row T and slots-per-load V
(sorting windows of 256 / T rows), sorting windows of 1 (unsorted) to
4096 rows, and for T = V = 1 every split-row shape (G lanes x S cluster
blocks), each held to the default's output within 1e-5.

For each block operator and value dtype, one JSON line: the checkout's
own packing (``csr_to_block_ell`` at the level's n_pad) and kernel
(``BlockEllMatrix.spmv``) held to its plain version within 1e-5 and to
its own bits on a second launch; its launch shape (W, T, G, S); its
median device time with L2 flushed between launches where the tables fit
in L2 (``ms``) and per launch of a CUDA graph replay of 20 launches
(``graph_ms``, operands hot in L2 where they fit); ``bound_ms`` (real
node slots, x and y once) and ``bound_copy_ms`` at the measured copy
rate; and one cuSPARSE CSR SpMV in fp32 and bf16 (``library_*_ms``).
With --sweep (a checkout whose kernel takes forced launch shapes), every
node-group shape (W = 16 bytes of values, T lanes), one thread per dof
row and every split-row shape, each held to the default's output within
1e-5 and to its own bits twice.

--root names the checkout whose ``sparsh_amg_tpu_torch`` is imported
(default: the one holding this script), so one call can time a parent
commit unpacked beside the tree, in turns with the tree.  The timing
functions come from this script's own checkout.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
LANES = (1, 2, 4, 8, 16, 32)
VECS = (1, 4)
SIGMAS = (1, 32, 256, 1024, 4096)
SPLITS = [(g, s) for s in (1, 2, 4, 8) for g in (1, 2, 4, 8, 16, 32)
          if g * s <= 256 and (s == 1 or g == 32)]
# case: (operators, value dtype)
CASES = {"p3d": (("P0", "R0", "A1"), "bf16"),
         "c3d": (("R0",), "fp32"),
         "delaunay": (("A0",), "fp32"),
         "e3d": (("R0", "R1", "R2"), "fp32"),
         "rank": (None, "bf16")}
PAD = {"rank": 128}         # the rank blocks' row padding; else 2048
# block case: (dimension of the elasticity problem, its block levels)
BLOCK_CASES = {"e3d-block": (3, ("L0", "L1", "L2")),
               "e2d-block": (2, ("L1", "L2"))}
DTYPES = ("fp32", "bf16")


def _timing():
    """utils/timing.py of this script's checkout, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "_sweep_timing",
        os.path.join(HERE, "sparsh_amg_tpu_torch", "utils", "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max().clamp_min(1e-30)).item()


def _rank_blocks():
    """{name: host CSR} of rank 1's ELL blocks of 4 ranks, poisson3d(96)."""
    import scipy.sparse as sp
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.parallel.dist import DistEll
    from sparsh_amg_tpu_torch.parallel.hierarchy import to_dist
    from sparsh_amg_tpu_torch.parallel.multihost import _flagship_params
    from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
    params = _flagship_params()
    dh = to_dist(amg_setup(poisson3d(96), params), 1, 4, params,
                 device="cpu")
    out = {}
    for li, lev in enumerate(dh.levels):
        for f in ("A", "P", "R"):
            op = getattr(getattr(lev, f), "op", getattr(lev, f))
            if not isinstance(op, DistEll):
                continue
            if hasattr(op, "local"):
                from sparsh_amg_tpu_torch.ops.ell_spmv import ell_unpack
                cols, vals, lens = ell_unpack(op.local)
            else:
                cols, vals, lens = op.cols, op.vals, op.lens
            L = op.as_local()
            cols, vals, lens = cols.numpy(), vals.float().numpy(), \
                lens.numpy()
            live = np.arange(cols.shape[0])[:, None] < lens[None, :]
            rows = np.broadcast_to(np.arange(cols.shape[1]), cols.shape)
            out[f"{f}{li}"] = sp.csr_matrix(
                (vals.T[live.T], (rows.T[live.T], cols.T[live.T])),
                shape=(L.n_pad, L.n_cols))
    return out


def host_operators(case):
    """{name: host CSR} of one case, from the port's host setup; {name:
    (host CSR, bs)} for a block case."""
    from sparsh_amg_tpu_torch import configs, flagship, systems
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
    from sparsh_amg_tpu_torch.setup.reorder import maybe_reorder
    if case == "rank":
        return _rank_blocks()
    ns = None
    if case == "p3d":
        A, p = poisson3d(192), flagship.params()
    elif case == "e3d" or case in BLOCK_CASES:
        dim = BLOCK_CASES[case][0] if case in BLOCK_CASES else 3
        (A, ns), p = systems.problem(dim), systems.params(dim)
    else:
        name = next(n for n in configs.NAMES if n.startswith(
            "convection3d" if case == "c3d" else case))
        A, p = configs.problem(name)[0], configs.params(name)
    A, perm = maybe_reorder(A.tocsr(), p.reorder)
    if ns is not None and perm is not None:
        ns = np.asarray(ns)[perm]
    hier = amg_setup(A, p, nullspace=ns)
    out = {}
    if case in BLOCK_CASES:
        for name in BLOCK_CASES[case][1]:
            lev = hier.levels[int(name[1:])]
            assert lev.bs > 1 and lev.A.shape[0] > p.dense_size, name
            out[name] = (lev.A.tocsr(), lev.bs)
        return out
    for name in CASES[case][0]:
        lev = hier.levels[int(name[1:])]
        out[name] = getattr(lev, name[0]).tocsr()
    return out


def cached_operators(case, cache):
    import scipy.sparse as sp
    path = os.path.join(cache, f"{case}.npz")
    if os.path.exists(path):
        z = np.load(path)
        ops = {}
        for name in z["names"]:
            A = sp.csr_matrix((z[f"{name}_data"], z[f"{name}_indices"],
                               z[f"{name}_indptr"]),
                              shape=tuple(z[f"{name}_shape"]))
            ops[name] = (A, int(z[f"{name}_bs"])) \
                if f"{name}_bs" in z.files else A
        return ops
    ops = host_operators(case)
    os.makedirs(cache, exist_ok=True)
    arrays = {}
    for n, op in ops.items():
        A = op[0] if isinstance(op, tuple) else op
        arrays.update({f"{n}_{f}": getattr(A, f)
                       for f in ("data", "indices", "indptr")})
        arrays[f"{n}_shape"] = np.array(A.shape)
        if isinstance(op, tuple):
            arrays[f"{n}_bs"] = np.array(op[1])
    np.savez(path, names=np.array(list(ops)), **arrays)
    return ops


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cases", nargs="+", default=[*CASES, *BLOCK_CASES],
                    choices=[*CASES, *BLOCK_CASES])
    ap.add_argument("--dtypes", nargs="+", default=list(DTYPES),
                    choices=DTYPES, help="value dtypes of the block cases")
    ap.add_argument("--cache", default=os.path.join(HERE, "_ab_cache"))
    ap.add_argument("--packings", nargs="+", metavar="T,V,SIGMA",
                    help="sweep these packings only")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import sparsh_amg_tpu_torch
    from sparsh_amg_tpu_torch.ops.formats import csr_to_ell
    assert sparsh_amg_tpu_torch.__file__.startswith(root), \
        sparsh_amg_tpu_torch.__file__
    timing = _timing()
    timed_ms = timing.timed_ms
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    copy_bw = timing.copy_bandwidth("cuda")
    # the floor under every time below: a one-element add
    one = torch.zeros(1, device="cuda")
    step = lambda: one.add_(1.0)
    floor = {"ms_flushed": timed_ms(step, flush=timing.l2_flush_buffer(1)),
             "ms": timed_ms(step), "graph_ms": timing.graph_ms(step)}
    print(json.dumps({"root": root, "gpu": gpu, "copy_bw_GBs": copy_bw / 1e9,
                      "launch_floor": floor}), flush=True)
    from sparsh_amg_tpu_torch.ops.formats import EllMatrix
    sliced = "slice_off" in EllMatrix.__dataclass_fields__
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}

    for case in args.cases:
        t0 = time.perf_counter()
        ops = cached_operators(case, args.cache)
        setup_s = time.perf_counter() - t0
        if case in BLOCK_CASES:
            block_case(case, ops, [dtypes[d] for d in args.dtypes], timing,
                       copy_bw, args.sweep, setup_s)
            continue
        dt = dtypes[CASES[case][1]]
        for name, A in ops.items():
            x = torch.from_numpy(np.random.default_rng(0).standard_normal(
                A.shape[1]).astype(np.float32)).cuda()
            pad = PAD.get(case, 2048)
            M = csr_to_ell(A, dt, pad, device="cuda")
            want = M.spmv(x)
            esize = 2 if dt == torch.bfloat16 else 4
            real = A.nnz * (4 + esize) + 4 * (A.shape[0] + A.shape[1])
            stored = M.cols.nbytes + M.vals.nbytes
            lib = torch.sparse_csr_tensor(
                torch.from_numpy(A.indptr.astype(np.int32)),
                torch.from_numpy(A.indices.astype(np.int32)),
                torch.from_numpy(A.data.astype(np.float32)),
                size=A.shape).cuda()
            lib_err = rel(lib @ x, want[: A.shape[0]])
            rec = {"case": f"{case} {name}", "dtype": CASES[case][1],
                   "rows": A.shape[0], "k": int(np.diff(A.indptr).max()),
                   "mean_len": A.nnz / A.shape[0], "setup_s": setup_s,
                   "ms": timed_ms(lambda: M.spmv(x)),
                   "bound_ms": real / HBM_BYTES_PER_S * 1e3,
                   "library_ms": timed_ms(lambda: lib @ x),
                   "library_rel_err": lib_err,
                   "stored_over_real": stored / (A.nnz * (4 + esize))}
            if sliced:
                rec.update(T=M.lanes, V=M.vec, sigma=M.sigma)
            if sliced and args.sweep:
                rec["sweep"] = sweep(M, A, dt, x, want, timed_ms,
                                     args.packings, pad)
            print(json.dumps(rec), flush=True)
            del M, lib
            torch.cuda.empty_cache()


def sweep(M0, A, dt, x, want, timed_ms, packings=None, pad=2048):
    """{"T,V,sigma[,GxS]": [ms, stored/real]} over the packings and, for
    T = V = 1, the split-row shapes."""
    import torch
    from sparsh_amg_tpu_torch import _build
    from sparsh_amg_tpu_torch.ops.formats import csr_to_ell
    from sparsh_amg_tpu_torch.ops.split_rows import limits
    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    grid = [(t, v, 256 // t) for t in LANES for v in VECS
            if t * v <= 4 * max(M0.k, 1)]
    grid += [(t, 1, sigma) for t in (1, M0.lanes) for sigma in SIGMAS
             if (t, 1, sigma) not in grid]
    if packings:
        grid = [tuple(int(a) for a in p.split(",")) for p in packings]
    splittable = 2 * A.shape[0] <= limits("cuda")[0] \
        and A.shape[0] <= 65535 * 32
    for t, v, sigma in grid:
        M = csr_to_ell(A, dt, pad, device="cuda", lanes=t, vec=v,
                       sigma=sigma)
        ratio = M.cols.numel() / max(M.nnz, 1)
        shapes = SPLITS if (t, v, sigma) == (1, 1, 256) and splittable \
            else [(1, 1)]
        y = torch.empty_like(want)
        for g, s in shapes:
            def run(g=g, s=s):
                _build.check(lib.ell_spmv_launch(
                    int(dt == torch.bfloat16), t, v,
                    M.cols.data_ptr(), M.vals.data_ptr(),
                    M.slice_off.data_ptr(), M.slice_width.data_ptr(),
                    M.perm.data_ptr() if M.sigma > 1 else 0,
                    M.lens.data_ptr(),
                    M.n_slices, M.n_rows, M.n_pad, g, s, x.data_ptr(),
                    y.data_ptr(), stream), "ell_spmv")
            run()
            torch.cuda.synchronize()
            err = rel(y, want)
            assert err <= 1e-5, (t, v, sigma, g, s, err)
            key = f"{t},{v},{sigma}" + (f",{g}x{s}" if g * s > 1
                                        else "")
            out[key] = [timed_ms(run), ratio]
        del M
    return out


def block_case(case, ops, dts, timing, copy_bw, sweep, setup_s):
    """One JSON line per block operator of `ops` and value dtype."""
    import torch
    from sparsh_amg_tpu_torch.ops import block_ell
    from sparsh_amg_tpu_torch.ops.formats import _round_up
    for name, (A, bs) in ops.items():
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            A.shape[1]).astype(np.float32)).cuda()
        lib = {ldt: torch.sparse_csr_tensor(
            torch.from_numpy(A.indptr.astype(np.int32)),
            torch.from_numpy(A.indices.astype(np.int32)),
            torch.from_numpy(A.data.astype(np.float32)),
            size=A.shape).to("cuda", dtype=dt)
            for ldt, dt in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16))}
        for dt in dts:
            rec = block_record(f"{case} {name}", A, bs, dt, x, lib,
                               block_ell, _round_up(A.shape[0], 2048),
                               timing, copy_bw, sweep)
            rec.update(dtype="bf16" if dt == torch.bfloat16 else "fp32",
                       setup_s=setup_s)
            print(json.dumps(rec), flush=True)
        del lib
        torch.cuda.empty_cache()


def block_record(case, A, bs, dt, x, lib, block_ell, n_pad, timing,
                 copy_bw, sweep):
    import torch
    M = block_ell.csr_to_block_ell(A, bs, dt, n_pad=n_pad, device="cuda")
    xs = torch.zeros(max(M.n_pad, M.n_cols), device="cuda")
    xs[: x.shape[0]] = x
    want = M.spmv(xs)
    again = M.spmv(xs)
    torch.cuda.synchronize()
    plain = block_ell.block_ell_plain(M.cols, M.vals, xs, M.lens)
    err = rel(want, plain)
    assert err <= 1e-5, (case, err)
    slots = int(M.lens.sum())
    esize = M.vals.element_size()
    real = slots * (4 + bs * bs * esize) + 4 * (M.n_cols + M.n_rows)
    stored = M.vals.nbytes + M.cols.nbytes + M.lens.nbytes
    flush = timing.l2_flush_buffer(stored + 4 * (M.n_cols + M.n_pad))
    shaped = hasattr(block_ell, "_launch")
    if shaped:
        shape = list(block_ell.block_shape(M.cols, M.vals))
    else:   # a checkout from before the node-group launch
        from sparsh_amg_tpu_torch.ops.split_rows import launch_shape
        shape = [1, 1, *launch_shape(M.n_rows, M.k, "cuda")]
    run = lambda: M.spmv(xs)
    rec = {"case": case, "rows": M.n_rows, "bs": bs, "k": M.k,
           "mean_slots": slots / max(M.cols.shape[1], 1),
           "shape_WTGS": shape, "max_rel_err": err,
           "same_bits": bool(torch.equal(want, again)),
           "real_MB": real / 1e6, "stored_MB": stored / 1e6,
           "l2_flushed": flush is not None,
           "ms": timing.timed_ms(run, flush=flush),
           "graph_ms": timing.graph_ms(run),
           "bound_ms": real / HBM_BYTES_PER_S * 1e3,
           "bound_copy_ms": real / copy_bw * 1e3}
    for ldt, L in lib.items():
        xl = x.to(L.dtype)
        rec[f"library_{ldt}_rel_err"] = rel((L @ xl).float(),
                                            want[: M.n_rows])
        rec[f"library_{ldt}_ms"] = timing.timed_ms(lambda: L @ xl,
                                                   flush=flush)
    if sweep and shaped:
        rec["sweep"] = block_sweep(M, xs, want, block_ell, timing, flush)
    return rec


def block_sweep(M, xs, want, block_ell, timing, flush):
    """{"W,T" or "GxS": [ms, graph_ms]} over every launch shape: node
    groups of W = 16 bytes of values and T lanes, one thread per dof row
    ("1x1") and split dof rows."""
    import torch
    wide = 16 // M.vals.element_size()
    shapes = [(wide, t, 1, 1) for t in LANES] + [(1, 1, 1, 1)]
    if M.n_rows <= 65535 * 32:
        shapes += [(1, 1, g, s) for g, s in SPLITS if g * s > 1]
    out = {}
    for shape in shapes:
        run = lambda shape=shape: block_ell._launch(M.cols, M.vals, M.lens,
                                                    xs, shape)
        got, again = run(), run()
        torch.cuda.synchronize()
        err = rel(got, want)
        assert err <= 1e-5 and torch.equal(got, again), (shape, err)
        w, t, g, s = shape
        key = f"{w},{t}" if w > 1 else f"{g}x{s}"
        out[key] = [timing.timed_ms(run, flush=flush), timing.graph_ms(run)]
    return out


if __name__ == "__main__":
    main()
