"""The port's process-local pipeline: its copies of the blocked setup
(``setup/blocked.py``, ``setup/blocked_sa.py``, ``setup/comm.py``) against
the JAX package's, value for value, on 2 and 4 thread ranks; its
process-local freeze (``parallel/blocked_dist.py``) against ``to_dist`` of
the global hierarchy; a two-rank process-local solve (gloo ranks as
subprocesses) against the one-rank count; and the guard on the nullspace
QR table of ``tentative_rows`` (aggregates smaller than the nullspace).
Mirrors the JAX package's tests/test_blocked.py, test_blocked_sa.py,
test_blocked_dist.py and test_multihost.py in small."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sparsh_amg_tpu.params import AMGParams as JParams
from sparsh_amg_tpu.setup import blocked as jblocked
from sparsh_amg_tpu.setup import blocked_sa as jblocked_sa
from sparsh_amg_tpu.setup import comm as jcomm
from sparsh_amg_tpu_torch.models import (elasticity3d, elasticity3d_nullspace,
                                         poisson3d)
from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
from sparsh_amg_tpu_torch.parallel import DistAMGSolver
from sparsh_amg_tpu_torch.parallel.blocked_dist import (blocked_to_dist,
                                                        fine_fp64_blocked,
                                                        slice_to_blocked)
from sparsh_amg_tpu_torch.parallel.hierarchy import fine_fp64, to_dist
from sparsh_amg_tpu_torch.parallel.multihost import (_flagship_params,
                                                     launch_processes)
from sparsh_amg_tpu_torch.setup import blocked, blocked_sa, comm
from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup

FLAGSHIP = dict(coarsening="pmis", interpolation="extpi", interp_max=4,
                rap_drop_tol=0.01, agg_levels=1, interp_max_composed=5,
                intermediate_drop_tol=0.02, aggressive="pmis2",
                coarse_size=64, replicate_size=600)
ELAS = dict(coarsening="aggregation", interpolation="smoothed",
            smoother="chebyshev", coarse_size=100, agg_blocksize=3,
            p_smooth_filter=False, row_align=6, replicate_size=300)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b, label):
    """Two setup products (CSR, arrays, scalars, dataclasses) equal value
    for value."""
    if sp.issparse(a):
        assert sp.issparse(b) and a.shape == b.shape, label
        a, b = a.tocsr(), b.tocsr()
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          f"{label} {f}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, label)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.name != "params":
                _same(getattr(a, f.name), getattr(b, f.name),
                      f"{label}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), label
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{label}[{i}]")
    else:
        assert a == b, (label, a, b)


def _blocked_both(A, kw, nb, B=None):
    """(port, JAX) per-rank BlockedHierarchy of A on nb thread ranks."""
    outs = []
    for mod, cm, P in ((blocked, comm, AMGParams),
                       (jblocked, jcomm, JParams)):
        params = P(**kw)
        align = params.row_align
        bounds = mod.partition_bounds(A.shape[0], nb, nb, align=align)

        def fn(rank, c, mod=mod, params=params, bounds=bounds, align=align):
            r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
            return mod.blocked_amg_setup(
                A[r0:r1].tocsr(), bounds, c, params,
                bounds_fn=lambda nc: mod.partition_bounds(nc, nb, nb,
                                                          align=align),
                nullspace_own=None if B is None else B[r0:r1])
        outs.append(cm.run_blocked(fn, nb))
    return outs


@pytest.mark.parametrize("nb", [2, 4])
def test_blocked_setup_equals_jax(nb):
    """The flagship's blocked setup (pmis2 aggressive step, multipass,
    filtered RAP, gathered tail) equals the JAX package's on every rank."""
    mine, ref = _blocked_both(poisson3d(16), FLAGSHIP, nb)
    assert len(mine[0].levels) >= 1
    for r, (a, b) in enumerate(zip(mine, ref)):
        _same(a, b, f"rank {r}")


@pytest.mark.parametrize("nb", [2, 4])
def test_blocked_sa_equals_jax(nb):
    """Blocked smoothed aggregation with rigid-body modes (nullspace QR,
    smoothed P, coarse nullspace routing) equals the JAX package's."""
    A = elasticity3d(6).tocsr().astype(np.float64)
    mine, ref = _blocked_both(A, ELAS, nb, B=elasticity3d_nullspace(6))
    assert len(mine[0].levels) >= 1
    for r, (a, b) in enumerate(zip(mine, ref)):
        _same(a, b, f"rank {r}")


def _op_equal(a, b, label):
    a, b = getattr(a, "op", a), getattr(b, "op", b)
    assert type(a) is type(b), (label, type(a), type(b))
    if a is None:
        return
    for f in ("bands", "cols", "vals", "lens", "mat"):
        if hasattr(a, f):
            assert torch.equal(getattr(a, f), getattr(b, f)), (label, f)
    for f in ("offsets", "h", "mode", "rows", "n_src", "n_rows", "n_cols"):
        if hasattr(a, f):
            assert getattr(a, f) == getattr(b, f), (label, f)


@pytest.mark.parametrize("extra", [{"smoother": "chebyshev",
                                    "band_dtype": "bfloat16"},
                                   {"smoother": "gs2"}],
                         ids=["flagship", "gs2"])
def test_blocked_freeze_equals_to_dist(extra):
    """blocked_to_dist of a rank's slice of the global hierarchy (4 thread
    ranks agreeing through the comm) equals to_dist of the global
    hierarchy for that rank, value for value, the fp64 fine operator
    too."""
    params = AMGParams(**{**FLAGSHIP, "dense_size": 512, **extra})
    hier = amg_setup(poisson3d(16), params)

    def fn(rank, c):
        bh = slice_to_blocked(hier, rank, 4, 4, params)
        dh = blocked_to_dist(bh, c, params, device="cpu")
        A64 = fine_fp64_blocked(bh.levels[0].A, bh.levels[0].r0,
                                dh.parts[0], c, params, dh.ranks,
                                device="cpu")
        return dh, A64

    outs = comm.run_blocked(fn, 4)
    for r, (dh, A64) in enumerate(outs):
        ref = to_dist(hier, r, 4, params, device="cpu")
        assert dh.parts == ref.parts
        kinds = [type(l).__name__ for l in ref.levels]
        assert "DistLevel" in kinds and "DeviceLevel" in kinds, kinds
        for li, (a, b) in enumerate(zip(dh.levels, ref.levels)):
            lab = f"rank {r} level {li}"
            assert type(a) is type(b), lab
            for f in ("A", "P", "R", "L", "U"):
                _op_equal(getattr(a, f), getattr(b, f), f"{lab} {f}")
            for f in ("dinv", "l1_dinv"):
                assert torch.equal(getattr(a, f), getattr(b, f)), lab
            assert a.lam_max == b.lam_max, lab
        ref64 = fine_fp64(hier, ref, params, device="cpu")
        _op_equal(A64.A, ref64.A, f"rank {r} fp64")
        _op_equal(A64.A_hi, ref64.A_hi, f"rank {r} A_hi")


def test_two_rank_processes_match_one_rank():
    """Two gloo ranks as subprocesses, each assembling only its rows and
    coarsening through the blocked setup: the one-rank count (+-1, the
    blocked RAP sums in another order), the tolerance, this rank's rows
    of the one-rank solution, rows that tile the domain, and no rank
    holding the global fine matrix."""
    m = 24                       # 13,824 rows: above replicate_size
    A = poisson3d(m)
    ref = DistAMGSolver(A, params=_flagship_params(),
                        krylov=KrylovParams(tol=1e-8, maxiter=60),
                        device="cpu").solve(
        np.random.default_rng(0).standard_normal(A.shape[0]))
    results = launch_processes(2, "poisson3d", m, setup="blocked",
                               device="cpu", threads=1, timeout=240)
    for r in results:
        assert r["process_count"] == 2 and r["backend"] == "gloo"
        assert r["converged"] and r["true_relres"] <= 1e-8, r
        assert not r["holds_global_fine"]
        r0, r1 = r["row_range"]
        assert r["local_rows"] == r1 - r0 < r["n"]
        assert abs(r["iterations"] - ref.iterations) <= 1, (r, ref)
        assert r["passes"] == ref.refine_passes
        assert np.allclose(r["x_head"], ref.x[r0:r0 + 8], rtol=1e-5,
                           atol=1e-8)
    assert results[0]["row_range"][1] == results[1]["row_range"][0]
    assert results[1]["row_range"][1] == results[0]["n"] == m ** 3


def _tentative_case():
    """Three aggregates of 2, 3 and 3 dofs against a 6-column nullspace:
    every aggregate is smaller than the nullspace dimension."""
    rng = np.random.default_rng(4)
    agg = np.array([0, 1, 0, 2, 1, 2, 1, 2])
    B = rng.standard_normal((8, 6))
    return agg, B


def test_tentative_rows_guards_small_aggregates():
    """The port's tentative_rows pads the QR table to the nullspace
    dimension when every aggregate is smaller (the JAX package's copy
    fails there): the kept columns equal a QR of the zero-padded table
    computed directly with numpy, numbered by ascending aggregate."""
    agg, B = _tentative_case()
    k = B.shape[1]
    c = comm.ThreadComm(comm._ThreadGroup(1), 0)
    bounds = np.array([0, 8])
    P, n_c, (cols_c, _) = blocked_sa.tentative_rows(agg, 3, 0, bounds, c, B,
                                                    ([3], [0]))
    want, base = np.zeros((8, 0)), 0
    scale = np.abs(B).max() + 1e-300
    for a in range(3):
        members = np.flatnonzero(agg == a)
        table = np.zeros((k, k))
        table[: members.size] = B[members]
        Q, R = np.linalg.qr(table)
        kept = np.abs(np.diag(R)) > 1e-10 * scale
        block = np.zeros((8, int(kept.sum())))
        block[members] = Q[: members.size][:, kept]
        want = np.hstack([want, block])
        base += int(kept.sum())
    assert n_c == base == 8 and P.shape == (8, n_c)
    np.testing.assert_array_equal(P.toarray(), want)
    np.testing.assert_array_equal(np.sort(cols_c), np.arange(n_c))
    jc = jcomm.ThreadComm(jcomm._ThreadGroup(1), 0)
    with pytest.raises(ValueError):
        jblocked_sa.tentative_rows(agg, 3, 0, bounds, jc, B, ([3], [0]))
