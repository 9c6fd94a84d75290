"""The port's distributed operators (``sparsh_amg_tpu_torch/parallel``)
against the JAX package's, and each rank's frozen block against the JAX
package's stacked hierarchy.

The port runs one process per rank: four gloo ranks on the CPU, started
as subprocesses that import only the port (``tests/torch_dist_rank.py``
through ``multihost.spawn_ranks``), apply every distributed operator to
the same numpy inputs the JAX package's operators get here under
``shard_map`` on ``default_mesh(4)``.  Outputs agree within fp32 rounding
(normwise relative error <= 1e-6).  ``to_dist``'s block for rank r equals
the JAX package's ``stacked[r]`` value for value, which needs no ranks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_rank as W
from sparsh_amg_tpu.params import AMGParams as JParams
from sparsh_amg_tpu.parallel import Partition as JPartition
from sparsh_amg_tpu.parallel import csr_to_dist as jcsr_to_dist
from sparsh_amg_tpu.parallel.dist import GatherOut as JGatherOut
from sparsh_amg_tpu.parallel.dist import ReplSrc as JReplSrc
from sparsh_amg_tpu.parallel.hierarchy import fine_df64 as jfine_df64
from sparsh_amg_tpu.parallel.hierarchy import local
from sparsh_amg_tpu.parallel.hierarchy import to_dist as jto_dist
from sparsh_amg_tpu.parallel.solver import default_mesh
from sparsh_amg_tpu.setup.hierarchy import amg_setup as jamg_setup
from sparsh_amg_tpu_torch.models import poisson3d
from sparsh_amg_tpu_torch.ops.ell_spmv import ell_unpack
from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
from sparsh_amg_tpu_torch.parallel import multihost
from sparsh_amg_tpu_torch.parallel.hierarchy import fine_fp64, to_dist
from sparsh_amg_tpu_torch.parallel.solver import (DistAMGSolver,
                                                  check_backend)
from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup

RANKS = W.RANKS
TOL = 1e-6                  # normwise, fp32 sums in another order


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_apply(op, x, in_full=False, out_full=False, method="spmv"):
    """op's method under shard_map on default_mesh(RANKS): x stacked
    (RANKS, n_loc), or full and replicated with in_full; the blocked
    output, or shard 0's full output with out_full."""
    mesh = default_mesh(RANKS)
    axis = mesh.axis_names[0]

    def body(op_s, x_s):
        return getattr(local(op_s), method)(x_s if in_full else x_s[0])[None]
    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P(axis), P() if in_full else P(axis)),
                              out_specs=P(axis), check_vma=False))
    y = np.asarray(f(op, jnp.asarray(x, dtype=jnp.float32)))
    return y[0] if out_full else y.reshape(-1)


def _jax_ops():
    """The JAX package's output of every case of W.op_cases()."""
    want = {}
    for name, A, kw, wrap in W.op_cases():
        pd = JPartition.make(A.shape[0], RANKS)
        ps = JPartition.make(A.shape[1], RANKS)
        op = jcsr_to_dist(A, pd, ps, **kw)
        x = W.op_input(A)
        if wrap == "repl_src":
            want[name] = _jax_apply(JReplSrc(op=op), ps.pad_vec(x).reshape(-1),
                                    in_full=True)
        elif wrap == "gather_out":
            want[name] = _jax_apply(JGatherOut(op=op, axis="rows"),
                                    ps.pad_vec(x), out_full=True)
        else:
            want[name] = _jax_apply(op, ps.pad_vec(x))
        want[name + "_kind"] = [type(op).__name__, getattr(op, "mode", None)]
    A, params = W.coarse_case()
    jp = JParams(**dataclasses.asdict(params))
    jd = jto_dist(jamg_setup(A, jp), RANKS, jp)
    lev = jax.tree.map(lambda a: a, jd.levels[-1])
    b = np.random.default_rng(3).standard_normal(lev.n)
    want["coarse_solve"] = _jax_apply(lev, jd.parts[-1].pad_vec(b),
                                      method="coarse_solve")
    return want


@pytest.fixture(scope="module")
def ops():
    wait = W.spawn("ops")
    want = _jax_ops()
    return wait(), want


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("name,kind", [
    ("dia", ["DistDia", None]), ("ell_halo", ["DistEll", "halo"]),
    ("ell_gather", ["DistEll", "gather"]), ("rect", None),
    ("dense", ["DistDense", None]), ("gather_out", None),
    ("repl_src", ["DistEll", "gather"]), ("repl_src_dense",
                                          ["DistDense", None])])
def test_operator_matches_jax(ops, name, kind):
    """Each operator on 4 gloo ranks equals the JAX package's on
    default_mesh(4): the same layout (the one named, where named), the
    same product within fp32 rounding, and its plain version the same
    product."""
    outs, want = ops
    kind = kind or want[name + "_kind"]
    assert [o[name + "_kind"] for o in outs] == [kind] * RANKS
    assert want[name + "_kind"] == kind
    if name.startswith("repl_src"):
        got = np.concatenate([o[name] for o in outs])
    elif name == "gather_out":
        got = outs[0][name]
        assert all(o[name] == got for o in outs)   # replicated
    else:
        got = np.concatenate([o[name] for o in outs])
    assert _rel(got, want[name]) <= TOL
    if name + "_plain" in outs[0]:
        plain = outs[0][name + "_plain"] if name == "gather_out" else \
            np.concatenate([o[name + "_plain"] for o in outs])
        assert _rel(got, plain) <= TOL


def test_coarse_solve_matches_jax(ops):
    """The agglomerated coarse solve (all-gather, then the rank's rows of
    the dense inverse) equals the JAX package's."""
    outs, want = ops
    assert all(o["coarse_kind"] == ["DistLevel", True] for o in outs)
    got = np.concatenate([o["coarse_solve"] for o in outs])
    assert _rel(got, want["coarse_solve"]) <= TOL


# ---------------------------------------------------------------------------
# each rank's frozen block against the JAX package's stacked[r]
# ---------------------------------------------------------------------------

FLAGSHIP = dict(coarsening="pmis", interpolation="extpi",
                smoother="chebyshev", band_dtype="bfloat16", interp_max=4,
                rap_drop_tol=0.01, agg_levels=1, interp_max_composed=5,
                intermediate_drop_tol=0.02, aggressive="pmis2",
                dense_size=512, cheby_degree_coarse=1, cheby_coarse_from=1,
                replicate_size=600)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _same_op(mine, ref, r, label, stacked=True):
    """A port layout (rank r's block) against the JAX one (stacked[r],
    or the replicated serial layout with stacked=False)."""
    ref = getattr(ref, "op", ref)
    mine = getattr(mine, "op", mine)
    if ref is None:
        assert mine is None, label
        return
    pick = (lambda a: _np(a)[r]) if stacked else _np
    kind = type(ref).__name__
    assert type(mine).__name__ == kind, (label, type(mine), kind)
    if kind in ("DistDia", "DiaMatrix"):
        assert tuple(mine.offsets) == tuple(ref.offsets), label
        if kind == "DistDia":
            assert mine.h == ref.h, label
        np.testing.assert_array_equal(_np(mine.bands), pick(ref.bands), label)
    elif kind in ("DistEll", "EllMatrix"):
        fill = 0
        if kind == "DistEll":
            assert (mine.h, mine.mode) == (ref.h, ref.mode), label
            mine, fill = mine.local, mine.h
        k = np.asarray(ref.cols).shape[-2]
        cols, vals, _ = ell_unpack(mine, k=k, fill=fill)
        np.testing.assert_array_equal(_np(cols), pick(ref.cols), label)
        np.testing.assert_array_equal(_np(vals), pick(ref.vals), label)
    else:
        assert kind in ("DistDense", "DenseMatrix"), label
        np.testing.assert_array_equal(_np(mine.mat), pick(ref.mat), label)


@pytest.mark.parametrize("extra", [{}, {"smoother": "gs2",
                                        "band_dtype": "float32"}],
                         ids=["flagship", "gs2"])
def test_to_dist_block_is_jax_stacked_slice(extra):
    """to_dist(hier, r, 4) holds, for every rank r, the JAX package's
    to_dist(hier, 4) stacked[r]: operators, smoother vectors, lam_max,
    the transfers across the replication boundary, the replicated levels
    and the fp64 fine operator (hi + lo, and A_hi its fp32 cast)."""
    kw = {**FLAGSHIP, **extra}
    A = poisson3d(16)
    jp = JParams(**kw)
    jh = jamg_setup(A, jp)
    jd = jto_dist(jh, RANKS, jp)
    jf = jfine_df64(jh, jd, jp)
    params = AMGParams(**kw)
    hier = amg_setup(A, params)
    kinds = [type(l).__name__ for l in jd.levels]
    assert "DistLevel" in kinds and "DeviceLevel" in kinds, kinds
    for r in range(RANKS):
        dh = to_dist(hier, r, RANKS, params, device="cpu")
        assert dh.parts == tuple(
            type(dh.parts[0])(p.n, p.nd, p.n_loc) for p in jd.parts)
        for li, (mine, ref) in enumerate(zip(dh.levels, jd.levels)):
            lab = f"rank {r} level {li}"
            assert type(mine).__name__ == type(ref).__name__, lab
            stacked = type(ref).__name__ == "DistLevel"
            pick = (lambda a: _np(a)[r]) if stacked else \
                (lambda a: _np(a)[0])      # JAX stacks replicated copies
            for f in ("A", "P", "R", "L", "U"):
                ref_op = getattr(ref, f)
                if not stacked and ref_op is not None:
                    ref_op = jax.tree.map(lambda a: a[0], ref_op)
                _same_op(getattr(mine, f), ref_op, r, f"{lab} {f}",
                         stacked=stacked)
            for f in ("dinv", "l1_dinv"):
                np.testing.assert_array_equal(_np(getattr(mine, f)),
                                              pick(getattr(ref, f)), lab)
            assert np.float32(mine.lam_max) == pick(ref.lam_max), lab
            if ref.coarse_inv is None:
                assert mine.coarse_inv is None, lab
            else:
                np.testing.assert_array_equal(_np(mine.coarse_inv),
                                              pick(ref.coarse_inv), lab)
        f64 = fine_fp64(hier, dh, params, device="cpu")
        hi = jax.tree.map(lambda a: a, jf.A_hi)
        _same_op(f64.A_hi, hi, r, f"rank {r} A_hi")
        full = _np(f64.A.bands if hasattr(f64.A, "bands") else f64.A.vals)
        ref_hi = _np(hi.bands if hasattr(hi, "bands") else hi.vals)[r]
        ref_lo = 0.0 if jf.lo is None else _np(jf.lo)[r]
        np.testing.assert_array_equal(
            full, ref_hi.astype(np.float64) + np.asarray(
                ref_lo, dtype=np.float32).astype(np.float64))


def test_note_pass_slack_skips_budget_limited_passes():
    """The distributed loop hands AMGSolver._note_pass_slack its
    budget_limited flag: a pass the iteration budget cut short does not
    set the fp32 floor estimate, a finished one does; and a solve whose
    only pass is cut by maxiter (in the device loop mode, which stops
    exactly there) leaves it unset."""
    A = poisson3d(10)
    s = DistAMGSolver(A, params=AMGParams(coarse_size=40),
                      krylov=KrylovParams(tol=1e-8, loop_mode="device"),
                      device="cpu")
    s._note_pass_slack(1.0, 1e-3, 1e-6, budget_limited=True)
    assert s._floor_est is None
    s._note_pass_slack(1.0, 1e-3, 1e-6, budget_limited=False)
    assert s._floor_est == pytest.approx(1e-3)
    s._floor_est = None
    res = s.solve(np.ones(A.shape[0]), maxiter=2)
    assert res.iterations == 2 and not res.converged
    assert s._floor_est is None


def test_nccl_without_enough_cards_raises():
    """NCCL needs one card per rank: more ranks than cards (or the CPU)
    raise, naming gloo; gloo takes any count."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match='backend="gloo"'):
        check_backend("nccl", cards + 1, "cuda")
    with pytest.raises(ValueError, match='backend="gloo"'):
        check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError, match='backend="gloo"'):
        multihost.spawn_ranks(cards + 1, ["-c", "pass"], backend="nccl",
                              device="cuda")
    check_backend("gloo", 8, "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        check_backend("mpi", 2, "cpu")


def test_spawn_ranks_stops_every_rank_when_one_fails():
    """A rank that exits non-zero, or ranks that outlive the time limit,
    raise RuntimeError naming the rank, and no rank is left running."""
    import os
    import subprocess
    import time
    mark = f"rank-marker-{os.getpid()}-{time.time_ns()}"  # in each argv
    code = ("import os, sys, time; r = int(os.environ['RANK']); "
            "print(r, os.environ['WORLD_SIZE'], flush=True); "
            f"sys.exit(3) if r == 1 else time.sleep(60)  # {mark}")
    with pytest.raises(RuntimeError, match=r"rank 1 of 3 failed \(rc=3\)"):
        multihost.spawn_ranks(3, ["-c", code], backend="gloo", device="cpu",
                              timeout=30)
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed .timed out"):
        multihost.spawn_ranks(2, ["-c", f"import time; time.sleep(60)  "
                                  f"# {mark}"],
                              backend="gloo", device="cpu", timeout=1)
    left = subprocess.run(["pgrep", "-f", mark], capture_output=True,
                          text=True).stdout
    assert left == "", left
    assert multihost.spawn_ranks(
        2, ["-c", "import os; print(os.environ['RANK'])"], backend="gloo",
        device="cpu") == ["0\n", "1\n"]
