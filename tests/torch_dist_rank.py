"""One rank of the port's distributed CPU tests (imports numpy, scipy and
the port only; never jax).  Started by the tests through
``sparsh_amg_tpu_torch.parallel.multihost.spawn_ranks``:

    python tests/torch_dist_rank.py ops|cycles|levels

``ops`` applies every distributed operator of ``op_cases()`` to the same
seeded inputs and prints this rank's outputs; ``cycles`` and ``levels``
run the distributed solves of ``solve_cases(group)`` and print their
counts.  The cases are
built here so that the tests build the JAX package's side from the very
same matrices.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import scipy.sparse as sp

RANKS = 4


def _rand_csr(n, m, density, seed, banded=None):
    rng = np.random.default_rng(seed)
    A = sp.random(n, m, density=density, random_state=rng, format="csr",
                  dtype=np.float64)
    if banded is not None:
        rows = np.repeat(np.arange(n), np.diff(A.indptr))
        keep = np.abs(A.indices - rows * m // n) <= banded
        A.data[~keep] = 0.0
        A.eliminate_zeros()
    return A


def _rect(nf, nc, seed):
    return (_rand_csr(nf, nc, 0.02, seed) + sp.csr_matrix(
        (np.ones(nc), (np.arange(nc), np.arange(nc))),
        shape=(nf, nc))).tocsr()


def op_cases() -> list:
    """(name, A, kwargs of csr_to_dist, wrapper): the operators the
    distributed CPU tests hold to the JAX package's.  wrapper is None,
    "gather_out" (replicated output) or "repl_src" (replicated input)."""
    from sparsh_amg_tpu_torch.models import poisson2d
    n = 600
    return [
        ("dia", poisson2d(26), {}, None),
        ("ell_halo", (_rand_csr(n, n, 0.02, 1, banded=60)
                      + sp.identity(n)).tocsr(), {"prefer_dia": False},
         None),
        ("ell_gather", (_rand_csr(n, n, 0.05, 2) + sp.identity(n)).tocsr(),
         {"prefer_dia": False}, None),
        ("rect", _rect(500, 180, 3), {"prefer_dia": False}, None),
        ("dense", (_rand_csr(300, 300, 0.05, 4) + sp.identity(300)).tocsr(),
         {"dense_size": 1024}, None),
        ("gather_out", _rect(500, 180, 5).T.tocsr(), {"prefer_dia": False},
         "gather_out"),
        ("repl_src", _rect(500, 180, 6),
         {"prefer_dia": False, "max_halo_frac": -1.0}, "repl_src"),
        ("repl_src_dense", _rect(500, 180, 7),
         {"dense_size": 1024}, "repl_src"),
    ]


def op_input(A, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(A.shape[1])


def coarse_case():
    """(A, params): a hierarchy whose coarsest level stays distributed,
    with a dense inverse split by rows."""
    from sparsh_amg_tpu_torch.models import poisson2d
    from sparsh_amg_tpu_torch.params import AMGParams
    return poisson2d(24), AMGParams(coarse_size=200, replicate_size=0)


SOLVE_GROUPS = {"cycles": ("poisson3d_chebyshev", "W", "F", "bicgstab"),
                "levels": ("gs2", "bf16", "replicated")}


def solve_cases(group: str | None = None) -> dict:
    """name -> (A, params keywords, Krylov keywords): the cases of the
    JAX package's tests/test_parallel.py (dense_size 256 where the fine
    level must stay sparse: DistDia levels under Chebyshev, the gs2
    triangles, bf16 bands); those of SOLVE_GROUPS[group] with a group."""
    from sparsh_amg_tpu_torch.models import (convection2d, poisson2d,
                                             poisson3d)
    cases = {
        "poisson3d_chebyshev": (poisson3d(12), dict(
            smoother="chebyshev", coarse_size=40, dense_size=256), {}),
        "W": (poisson2d(24), dict(coarse_size=40, cycle="W"), {}),
        "F": (poisson2d(24), dict(coarse_size=40, cycle="F"), {}),
        "bicgstab": (convection2d(24), dict(coarse_size=40),
                     dict(method="bicgstab", maxiter=200)),
        "gs2": (poisson2d(24), dict(coarse_size=40, smoother="gs2",
                                    dense_size=256), {}),
        "bf16": ((poisson3d(12) * (np.pi / 3.0)).tocsr(),
                 dict(coarse_size=40, band_dtype="bfloat16",
                      dense_size=256), {}),
        "replicated": (poisson2d(24), dict(coarse_size=40,
                                           replicate_size=400), {}),
    }
    return cases if group is None else {k: cases[k]
                                        for k in SOLVE_GROUPS[group]}


def solve_rhs(n: int) -> np.ndarray:
    return np.random.default_rng(11).standard_normal(n)


def _ops(rank: int) -> dict:
    import torch
    from sparsh_amg_tpu_torch.parallel import (DistDense, DistDia, DistEll,
                                               GatherOut, Partition,
                                               RankGroup, ReplSrc,
                                               csr_to_dist, to_dist)
    from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
    ranks = RankGroup(rank, RANKS)
    out = {}
    for name, A, kw, wrap in op_cases():
        pd = Partition.make(A.shape[0], RANKS)
        ps = Partition.make(A.shape[1], RANKS)
        op = csr_to_dist(A, pd, ps, ranks, device="cpu", **kw)
        x = op_input(A)
        if wrap == "repl_src":
            xs = torch.from_numpy(ps.pad_vec(x).reshape(-1)).float()
            y = ReplSrc(op).spmv(xs)
        else:
            xs = torch.from_numpy(ps.pad_vec(x)[rank]).float()
            y = (GatherOut(op) if wrap == "gather_out" else op).spmv(xs)
            plain = op.spmv_plain(xs)
            if wrap == "gather_out":
                plain = ranks.all_gather(plain)
            out[name + "_plain"] = plain.tolist()
        out[name] = y.tolist()
        out[name + "_kind"] = [type(op).__name__, getattr(op, "mode", None)]
        assert isinstance(op, (DistDia, DistEll, DistDense))
    A, params = coarse_case()
    dh = to_dist(amg_setup(A, params), rank, RANKS, params, device="cpu")
    lev = dh.levels[-1]
    b = np.random.default_rng(3).standard_normal(lev.n)
    bs = torch.from_numpy(dh.parts[-1].pad_vec(b)[rank]).float()
    out["coarse_solve"] = lev.coarse_solve(bs).tolist()
    out["coarse_kind"] = [type(lev).__name__, lev.coarse_inv is not None]
    return out


def _solves(group: str) -> dict:
    from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
    from sparsh_amg_tpu_torch.parallel import DistAMGSolver
    out = {}
    for name, (A, pkw, kkw) in solve_cases(group).items():
        b = solve_rhs(A.shape[0])
        solver = DistAMGSolver(A, params=AMGParams(**pkw),
                               krylov=KrylovParams(tol=1e-8, **kkw),
                               device="cpu")
        res = solver.solve(b)
        out[name] = {
            "iterations": res.iterations, "passes": res.refine_passes,
            "converged": bool(res.converged),
            "relres_host_fp64": float(np.linalg.norm(b - A @ res.x)
                                      / np.linalg.norm(b)),
            "levels": [type(l).__name__ for l in solver.dist.levels],
            "ops": [type(l.A).__name__ for l in solver.dist.levels]}
    return out


def spawn(job: str):
    """Start the RANKS ranks of `job` in a thread (they run while the
    caller computes the JAX package's side); returns a call that waits
    and gives each rank's JSON output."""
    import threading
    from sparsh_amg_tpu_torch.parallel import multihost
    box = {}

    def run():
        try:
            box["outs"] = [multihost.last_json(o) for o in
                           multihost.spawn_ranks(
                               RANKS, ["tests/torch_dist_rank.py", job],
                               backend="gloo", device="cpu", threads=1,
                               timeout=240)]
        except BaseException as e:          # noqa: BLE001 — re-raised
            box["error"] = e
    t = threading.Thread(target=run)
    t.start()

    def wait():
        t.join()
        if "error" in box:
            raise box["error"]
        return box["outs"]
    return wait


def main(job: str) -> None:
    import torch.distributed as dist
    from sparsh_amg_tpu_torch.parallel import multihost
    multihost.pin_threads()
    multihost.init_process_group()
    out = _ops(dist.get_rank()) if job == "ops" else _solves(job)
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
