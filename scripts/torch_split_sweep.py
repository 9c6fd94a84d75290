#!/usr/bin/env python3
"""Device time of the ELL kernel on the operators of the solves, for one
checkout of the port, and (--sweep) under every packing and launch shape.

    python3 scripts/torch_split_sweep.py [--root DIR] [--sweep]
        [--cases p3d c3d delaunay e3d] [--cache DIR]

The operators: the flagship poisson3d(192)'s P0, R0 and A1 (bf16),
convection3d(96)'s R0 and delaunay(1024^2)'s fine level (fp32),
elasticity3d(40)'s SA transfers R0-R2 (fp32, the long rows that the
split-row launch serves), and (case "rank") the ELL blocks of rank 1 of
4 of the poisson3d(96) flagship hierarchy (bf16, their columns indexing
the extended or gathered source).  Their host CSR matrices come from the
port's host setup (RCM first where the configuration asks for it, as
AMGSolver does; the rank blocks from ``parallel.hierarchy.to_dist``),
kept in --cache as .npz so that later runs, of any checkout, time the
same matrices.

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

--root names the checkout whose ``sparsh_amg_tpu_torch`` is imported
(default: the one holding this script), so one call can time a parent
commit unpacked beside the tree, in turns with the tree.
"""
import argparse
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
    """{name: host CSR} of one case, from the port's host setup."""
    from sparsh_amg_tpu_torch import configs, flagship, systems
    from sparsh_amg_tpu_torch.models import poisson3d
    from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
    from sparsh_amg_tpu_torch.setup.reorder import maybe_reorder
    if case == "rank":
        return _rank_blocks()
    ns = None
    if case == "p3d":
        A, p = poisson3d(192), flagship.params()
    elif case == "e3d":
        (A, ns), p = systems.problem(3), systems.params(3)
    else:
        name = next(n for n in configs.NAMES if n.startswith(
            "convection3d" if case == "c3d" else case))
        A, p = configs.problem(name)[0], configs.params(name)
    A, perm = maybe_reorder(A.tocsr(), p.reorder)
    if ns is not None and perm is not None:
        ns = np.asarray(ns)[perm]
    hier = amg_setup(A, p, nullspace=ns)
    out = {}
    for name in CASES[case][0]:
        lev = hier.levels[int(name[1:])]
        out[name] = getattr(lev, name[0]).tocsr()
    return out


def cached_operators(case, cache):
    import scipy.sparse as sp
    path = os.path.join(cache, f"{case}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return {name: sp.csr_matrix((z[f"{name}_data"], z[f"{name}_indices"],
                                     z[f"{name}_indptr"]),
                                    shape=tuple(z[f"{name}_shape"]))
                for name in z["names"]}
    ops = host_operators(case)
    os.makedirs(cache, exist_ok=True)
    np.savez(path, names=np.array(list(ops)),
             **{f"{n}_{f}": getattr(A, f) if f != "shape"
                else np.array(A.shape)
                for n, A in ops.items()
                for f in ("data", "indices", "indptr", "shape")})
    return ops


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cases", nargs="+", default=list(CASES))
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
    from sparsh_amg_tpu_torch.utils.timing import timed_ms
    assert sparsh_amg_tpu_torch.__file__.startswith(root), \
        sparsh_amg_tpu_torch.__file__
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "gpu": gpu}), flush=True)
    from sparsh_amg_tpu_torch.ops.formats import EllMatrix
    sliced = "slice_off" in EllMatrix.__dataclass_fields__
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}

    def rel(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp_min(1e-30)).item()

    for case in args.cases:
        t0 = time.perf_counter()
        ops = cached_operators(case, args.cache)
        setup_s = time.perf_counter() - t0
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
                rec["sweep"] = sweep(M, A, dt, x, want, rel, timed_ms,
                                     args.packings, pad)
            print(json.dumps(rec), flush=True)
            del M, lib
            torch.cuda.empty_cache()


def sweep(M0, A, dt, x, want, rel, timed_ms, packings=None, pad=2048):
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


if __name__ == "__main__":
    main()
