"""The frozen byte count against the port's ``accounting.op_bytes().real``
on a small hierarchy, every difference named, and the frozen cycle
count against the port's."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from conftest import small_spec

from amgbench import work


def _hierarchy(workload):
    from sparsh_amg_tpu_torch.models import (elasticity3d,
                                             elasticity3d_nullspace,
                                             poisson3d)
    from sparsh_amg_tpu_torch.params import AMGParams
    from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
    from sparsh_amg_tpu_torch.solve.device import to_device
    spec = small_spec(workload)
    amg = AMGParams(**spec["config"]["amg"])
    if workload.startswith("p3d"):
        A, ns = poisson3d(12).tocsr(), None
    else:
        A, ns = elasticity3d(5).tocsr(), elasticity3d_nullspace(5)
    hier = amg_setup(A, amg, nullspace=ns)
    return spec, amg, hier, to_device(hier, amg, device="cpu")


def _expected_difference(op, nnz: int, vb: int) -> int:
    """op_bytes().real minus the frozen rule's bytes for one operator."""
    from sparsh_amg_tpu_torch.ops.block_ell import BlockEllMatrix
    from sparsh_amg_tpu_torch.ops.formats import (DenseMatrix, DiaMatrix,
                                                  EllMatrix)
    if isinstance(op, DiaMatrix):
        # stored zeros inside the bands are not priced by either; the
        # rows past the matrix's are padding
        return int(torch.count_nonzero(op.bands)) * vb - nnz * vb
    if isinstance(op, EllMatrix):
        return 4 * nnz                      # a column index a slot
    if isinstance(op, BlockEllMatrix):
        slots = int(op.lens.sum())
        # a column index a node block, and the zeros a node block holds
        return 4 * slots + vb * (op.bs * op.bs * slots - nnz)
    if isinstance(op, DenseMatrix):
        return vb * (op.n_rows * op.n_cols - nnz)   # every entry stored
    raise TypeError(type(op))


@pytest.mark.parametrize("workload", ["p3d192.rhs", "e3d40.rhs"])
def test_bytes_against_op_bytes_real(workload):
    from sparsh_amg_tpu_torch.utils.accounting import op_bytes
    _, amg, hier, dev = _hierarchy(workload)
    vb = work.VALUE_BYTES[amg.band_dtype]
    kinds = set()
    for lev, dlev in zip(hier.levels, dev.levels):
        pairs = [(lev.A, dlev.A)]
        if lev.P is not None:
            pairs += [(lev.P, dlev.P), (lev.R, dlev.R)]
        for M, op in pairs:
            if op is None:
                continue
            kinds.add(type(op).__name__)
            ours = work.spmv_bytes(int(M.nnz), M.shape[0], M.shape[1], vb)
            assert op_bytes(op).real - ours \
                == _expected_difference(op, int(M.nnz), vb), type(op)
    assert len(kinds) >= 2


@pytest.mark.parametrize("workload", ["p3d192.rhs", "e3d40.rhs"])
def test_cycle_count_is_the_ports(workload):
    from sparsh_amg_tpu_torch.utils import accounting
    spec, amg, hier, _ = _hierarchy(workload)
    n = hier.n_levels
    for shape in ("V", "W", "F"):
        ours = [{"A": 0.0, "T": 0.0, "C": 0.0} for _ in range(n)]
        theirs = [{"A": 0.0, "T": 0.0, "C": 0.0} for _ in range(n)]
        cfg = dict(spec["config"]["amg"], cycle=shape)
        work.count_cycle(n, 0, shape, cfg, ours)
        accounting._count_cycle(n, 0, shape,
                                dataclasses.replace(amg, cycle=shape),
                                theirs)
        assert ours == theirs


def test_solve_bytes_by_hand():
    """Two levels, a V-cycle of Chebyshev degree 3: seven applications
    on the fine level, one R and one P, the fp32 inverse of the coarse
    level, the fp32 Krylov matvec; one fp64 residual a pass."""
    amg = {"band_dtype": "bfloat16", "dtype": "float32", "cycle": "V",
           "smoother": "chebyshev", "cheby_degree": 3,
           "cheby_degree_coarse": 0, "cheby_coarse_from": 2, "nu1": 1,
           "nu2": 1, "coarse_inv_max": 8192, "coarse_solver": "lu",
           "coarse_smooth_sweeps": 16}
    levels = [{"n": 100, "nnz": 500, "P": (100, 10, 100),
               "R": (10, 100, 100)},
              {"n": 10, "nnz": 50, "P": None, "R": None}]
    got = work.solve_bytes(levels, amg, {"method": "cg"})
    fine_cycle = 7 * (500 * 2 + 4 * 200)
    transfers = 2 * (100 * 2 + 4 * 110)
    coarse = 100 * 4 + 4 * 20
    krylov = 500 * 4 + 4 * 200
    assert got["iteration"] == krylov + fine_cycle + transfers + coarse
    assert got["pass"] == 500 * 8 + 8 * 200
    bicg = work.solve_bytes(levels, amg, {"method": "bicgstab"})
    assert bicg["iteration"] == 2 * got["iteration"]
    assert work.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert work.peak_bytes_per_s("NVIDIA A100-SXM4-40GB") is None
    assert np.isfinite(got["iteration"])
