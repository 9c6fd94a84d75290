"""The port's work accounting (``utils/accounting.py``) and device facts
(``utils/meminfo.py``) on the CPU: the cycle counts and the nnz of one
Krylov iteration equal the JAX package's on the same hierarchy; the bytes
of each port layout equal a hand count (real bytes no more than padded);
the footprint table adds up to ``AMGSolver.device_bytes()``; a 7-band
fp32 DIA fine operator moves ~36/7 bytes per nonzero; and the data-sheet
memory rate is known for the H100 and refused for any other card."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sparsh_amg_tpu import params as jparams
from sparsh_amg_tpu.models.poisson import poisson2d as jpoisson2d
from sparsh_amg_tpu.setup.hierarchy import amg_setup as jamg_setup
from sparsh_amg_tpu.solve.device import to_device as jto_device
from sparsh_amg_tpu.utils import accounting as jacc
from sparsh_amg_tpu_torch import AMGSolver, flagship, systems
from sparsh_amg_tpu_torch import params as tparams
from sparsh_amg_tpu_torch.models import poisson3d
from sparsh_amg_tpu_torch.ops.block_ell import csr_to_block_ell
from sparsh_amg_tpu_torch.ops.formats import (csr_to_dense, csr_to_dia,
                                              csr_to_ell)
from sparsh_amg_tpu_torch.ops.fp64 import csr_to_fp64, to_fp32
from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
from sparsh_amg_tpu_torch.solve.device import to_device
from sparsh_amg_tpu_torch.utils import accounting as acc
from sparsh_amg_tpu_torch.utils import meminfo


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these sizes it is faster than the default
    pool, and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("smoother", ["chebyshev", "jacobi", "l1jacobi",
                                      "gs2"])
@pytest.mark.parametrize("cycle", ["V", "W", "F"])
def test_count_cycle_matches_jax(cycle, smoother):
    kw = dict(smoother=smoother, cycle=cycle, nu1=2, nu2=1, cheby_degree=3,
              cheby_degree_coarse=1, cheby_coarse_from=1, gs_stages=2)
    mine = [{"A": 0.0, "T": 0.0, "C": 0.0} for _ in range(5)]
    ref = [{"A": 0.0, "T": 0.0, "C": 0.0} for _ in range(5)]
    acc._count_cycle(5, 0, cycle, tparams.AMGParams(**kw), mine)
    jacc._count_cycle(5, 0, cycle, jparams.AMGParams(**kw), ref)
    assert mine == ref
    assert mine[-1]["C"] > 0


@pytest.mark.parametrize("kw", [dict(smoother="chebyshev", cycle="V"),
                                dict(smoother="gs2", cycle="W")],
                         ids=["chebyshev V", "gs2 W"])
@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_work_per_iteration_nnz_matches_jax(method, kw):
    """The nnz counts do not depend on the layout: the same poisson2d(24)
    hierarchy gives the JAX package's counts exactly."""
    A = jpoisson2d(24)
    kw = dict(kw, coarse_size=16, dense_size=64)
    tp, jp = tparams.AMGParams(**kw), jparams.AMGParams(**kw)
    th, jh = amg_setup(A, tp), jamg_setup(A, jp)
    mine = acc.work_per_iteration(th, to_device(th, tp, device="cpu"), tp,
                                  method=method)
    ref = jacc.work_per_iteration(jh, jto_device(jh, jp), jp, method=method)
    assert th.n_levels == jh.n_levels >= 3
    assert mine.nnz_per_iter == ref.nnz_per_iter
    assert mine.nnz_per_refine_pass == ref.nnz_per_refine_pass
    assert mine.spmv_equiv == ref.spmv_equiv
    assert mine.bytes_per_iter > 0
    assert acc.work_per_iteration(th, None, tp, method).nnz_per_iter == \
        ref.nnz_per_iter


def _tridiag(n):
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n),
                    format="csr")


def _layouts():
    """(layout, (real, padded) by hand) for one operator of each layout."""
    dia = csr_to_dia(_tridiag(10), torch.float32, 128, device="cpu")
    dia16 = csr_to_dia(_tridiag(10), torch.bfloat16, 128, device="cpu")
    # rows of 2, 0 and 1 entries over 4 columns: K = 2, n_pad = 8
    E = sp.csr_matrix((np.array([1.0, 2.0, 3.0]),
                       (np.array([0, 0, 2]), np.array([1, 3, 0]))),
                      shape=(3, 4))
    ell = csr_to_ell(E, torch.float32, 8, device="cpu")
    # 2 x 2 nodes of 2 x 2 blocks, node pattern (0,0), (0,1), (1,1)
    Bn = sp.csr_matrix(np.array([[1, 1], [0, 1]]))
    blk = csr_to_block_ell(sp.kron(Bn, np.ones((2, 2))).tocsr(), 2,
                           torch.float32, device="cpu")
    K, nb, n_pad = blk.k, blk.cols.shape[1], blk.n_pad
    dense = csr_to_dense(sp.random(3, 5, density=0.6, random_state=0,
                                   format="csr"), torch.float32, 128,
                         device="cpu")
    return {
        # 28 nonzero band entries, x and y over 10 rows; 3 x 128 bands
        "dia fp32": (dia, (28 * 4 + 2 * 4 * 10, 3 * 128 * 4 + 2 * 4 * 128)),
        "dia bf16": (dia16, (28 * 2 + 2 * 4 * 10,
                             3 * 128 * 2 + 2 * 4 * 128)),
        # 3 slots of value + column, x over 4 columns, y over 3 rows;
        # stored: one slice of 32 rows, 2 slots wide (64 slots of value +
        # column), its offset and width, lens over 8 rows (no perm: in
        # one slice, sorting saves no slot)
        "ell": (ell, (3 * 8 + 4 * (4 + 3),
                      64 * 8 + 2 * 4 + 8 * 4 + 4 * (4 + 8))),
        # 3 node slots of a column and 4 values
        "block": (blk, (3 * (4 + 4 * 4) + 4 * (4 + 4),
                        K * 2 * n_pad * 4 + K * nb * 4 + 4 * (4 + n_pad))),
        # 3 x 5 values, mat stored 128 x 128
        "dense": (dense, (3 * 5 * 4 + 4 * (3 + 5),
                          128 * 128 * 4 + 4 * (128 + 128))),
    }


@pytest.mark.parametrize("layout", ["dia fp32", "dia bf16", "ell", "block",
                                    "dense"])
def test_op_bytes_hand_counts(layout):
    op, want = _layouts()[layout]
    got = acc.op_bytes(op)
    assert tuple(got) == want
    assert got.real <= got.padded


def _solver(case):
    if case == "elasticity3d(4)":        # Krylov matvec on level 0's blocks
        A, ns = systems.problem(3, 4)
        return AMGSolver(A, systems.params(3, dense_size=64), nullspace=ns,
                         device="cpu")
    p = flagship.params(dense_size=256)
    if case == "poisson3d(12) fp32 bands":   # level 0 is the fp32 operator
        p = p.replace(band_dtype="float32")
    return AMGSolver(poisson3d(12), p, flagship.krylov(), device="cpu")


# ELL operators of each kind the hierarchies hold: P, R and a coarse A of
# a classical hierarchy, an SA transfer, an irregular random matrix
def _ell_matrices():
    hier = amg_setup(poisson3d(12), tparams.AMGParams(
        coarsening="pmis", interpolation="extpi", interp_max=4))
    sa = amg_setup(poisson3d(12), tparams.AMGParams(coarsening="aggregation"))
    return {"P0": hier.levels[0].P.tocsr(), "R0": hier.levels[0].R.tocsr(),
            "A1": hier.levels[1].A.tocsr(), "SA R0": sa.levels[0].R.tocsr(),
            "random": sp.random(700, 500, density=0.03, random_state=2,
                                format="csr")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_real_bytes_are_the_real_slots(dtype):
    """Real bytes of an ELL operator are its nonzeros' values and columns
    plus x and y once, whatever the packing (the same work, so every
    bound_ms stays); padded bytes are every stored table of the layout."""
    esize = 2 if dtype == torch.bfloat16 else 4
    for name, A in _ell_matrices().items():
        n, m = A.shape
        for lanes, vec, sigma in ((None, None, 256), (1, 1, 32), (4, 1, 256),
                                  (32, 4, 4096)):
            E = csr_to_ell(A, dtype, 128, device="cpu", lanes=lanes,
                           vec=vec, sigma=sigma)
            ob = acc.op_bytes(E)
            assert ob.real == A.nnz * (4 + esize) + 4 * (m + n), name
            stored = (E.cols.numel() * (4 + esize)
                      + 4 * (2 * E.n_slices + E.perm.numel() + E.n_pad))
            assert ob.padded == stored + 4 * (m + E.n_pad), name
            assert ob.real <= ob.padded, name


@pytest.mark.parametrize("case", ["poisson3d(12) bf16 bands",
                                  "poisson3d(12) fp32 bands",
                                  "elasticity3d(4)"])
def test_footprint_table_adds_up_to_device_bytes(case):
    solver = _solver(case)
    rows = acc.footprint_table(solver.device, solver.A64, solver.A32)
    assert sum(r["total"] for r in rows) == solver.device_bytes()
    names = [r["level"] for r in rows]
    assert names[:solver.device.n_levels] == list(
        range(solver.device.n_levels))
    assert names[solver.device.n_levels:] == (
        ["fp64_fine"] if solver.A32 is None else ["fp64_fine", "fp32_fine"])
    if case == "poisson3d(12) fp32 bands":
        assert solver.device.levels[0].A is solver.A32
        assert rows[-1]["A"] == 0          # counted once, at level 0


def test_dia_bytes_per_nnz_is_36_over_7():
    """The fp32 Krylov operator of 3-D Poisson (7 bands, fp32 values, x and
    y once) moves (7 + 1 + 1) * 4 / 7 bytes per nonzero, as bench.py
    assumes, within 1 % (the boundary rows hold fewer nonzeros)."""
    A = poisson3d(32)
    A32 = to_fp32(csr_to_fp64(A, device="cpu"))
    got = acc.op_bytes(A32).real / A.nnz
    assert got == pytest.approx(36 / 7, rel=0.01)


def test_spec_bw_is_the_h100_data_sheet_and_refuses_other_cards():
    assert meminfo.spec_bw_of("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        meminfo.spec_bw_of("NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError):
        meminfo.hbm_spec_bw("cpu")
    assert meminfo.device_memory_stats("cpu") == {}
