"""Exact per-iteration work accounting (the port of
``sparsh_amg_tpu/utils/accounting.py``).

Mirrors the cycle recursion in solve/cycles.py op for op: for one Krylov
iteration it counts, per level, how many operator applications, transfer
applications and coarse solves run, then prices them two ways:

* **nnz**: true nonzeros touched (host hierarchy counts, no padding), the
  basis of the headline nnz/s metric;
* **bytes**: device-memory traffic of the port's layouts (``op_bytes``),
  the basis of the achieved fraction of the card's memory rate.

Bytes are counted as ``chip_smoke.py``'s ``bound_ms`` counts them: *real*
bytes are each stored slot in use (value and index; DIA: the nonzero band
entries), the source vector read once and the destination written once;
*padded* bytes are every stored slot and the padded vectors.  Only real
bytes feed ``WorkModel.bytes_per_iter``.

What is NOT counted: BLAS-1 axpy/dot traffic of the Krylov loop itself
(~10 vector streams per iteration, < 5% of cycle traffic at opC ~1.2).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple


def _smoother_applies(params, coarse: bool) -> float:
    """Operator applications of ONE smooth() call (solve/smoothers.py)."""
    name = params.smoother
    if name == "chebyshev":
        return (params.cheby_degree_coarse
                if coarse and params.cheby_degree_coarse
                else params.cheby_degree)
    if name in ("jacobi", "l1jacobi"):
        return params.nu1          # sweeps passed as nu1/nu2; one A per sweep
    if name == "gs2":
        # per sweep: one residual on A + `gs_stages` triangular products,
        # L and U each roughly half of A's nonzeros
        return params.nu1 * (1.0 + 0.5 * params.gs_stages)
    raise ValueError(f"unknown smoother {name!r}")


def _count_cycle(n_levels: int, l: int, shape: str, params, acc):
    """Visit levels exactly as solve/cycles._cycle does, incrementing
    acc[l] = {'A': operator applies, 'T': P+R applies, 'C': coarse solves}."""
    if l == n_levels - 1:
        acc[l]["C"] += 1
        return
    pre = _smoother_applies(params, coarse=l >= params.cheby_coarse_from)
    # pre-smooth + residual + post-smooth; nu2 smoothing costs the same
    # per-call applies as nu1 for jacobi-family (sweeps=nu2)
    post = pre if params.smoother == "chebyshev" else \
        pre / max(params.nu1, 1) * params.nu2
    acc[l]["A"] += pre + 1 + post
    acc[l]["T"] += 2               # one R, one P
    if shape == "V":
        _count_cycle(n_levels, l + 1, "V", params, acc)
    elif shape == "W":
        _count_cycle(n_levels, l + 1, "W", params, acc)
        _count_cycle(n_levels, l + 1, "W", params, acc)
    elif shape == "F":
        _count_cycle(n_levels, l + 1, "F", params, acc)
        _count_cycle(n_levels, l + 1, "V", params, acc)
    else:
        raise ValueError(f"unknown cycle {shape!r}")


class OpBytes(NamedTuple):
    real: int                  # slots in use, x and y once, no padding
    padded: int                # every stored slot, padded vectors


def op_bytes(op) -> OpBytes:
    """Device-memory bytes one SpMV of a device-layout operator moves:
    operator data, the source vector read once, the destination written
    once.  Vectors are fp32 (fp64 beside an fp64 operator).  A
    distributed operator is priced on this rank's block (``as_local``)."""
    import torch
    if hasattr(op, "as_local"):
        return op_bytes(op.as_local())
    from ..ops.block_ell import BlockEllMatrix
    from ..ops.formats import DenseMatrix, DiaMatrix, EllMatrix
    if isinstance(op, DiaMatrix):
        b = op.bands
        vec = max(4, b.element_size())
        nz = int(torch.count_nonzero(b))
        return OpBytes(nz * b.element_size() + 2 * vec * op.n_rows,
                       b.nbytes + 2 * vec * op.n_pad)
    if isinstance(op, EllMatrix):
        vec = max(4, op.vals.element_size())
        slots = int(op.lens.sum())
        return OpBytes(
            slots * (op.vals.element_size() + op.cols.element_size())
            + vec * (op.n_cols + op.n_rows),
            op.vals.nbytes + op.cols.nbytes + vec * (op.n_cols + op.n_pad))
    if isinstance(op, BlockEllMatrix):
        node_slots = int(op.lens.sum())
        return OpBytes(
            node_slots * (op.cols.element_size()
                          + op.bs * op.bs * op.vals.element_size())
            + 4 * (op.n_cols + op.n_rows),
            op.vals.nbytes + op.cols.nbytes + 4 * (op.n_cols + op.n_pad))
    if isinstance(op, DenseMatrix):
        r, c = op.mat.shape
        return OpBytes(op.n_rows * op.n_cols * op.mat.element_size()
                       + 4 * (op.n_rows + op.n_cols),
                       op.mat.nbytes + 4 * (r + c))
    raise TypeError(type(op))


@dataclasses.dataclass(frozen=True)
class WorkModel:
    nnz_per_iter: float        # true nonzeros touched per Krylov iteration
    bytes_per_iter: float      # device-layout HBM bytes per iteration
    nnz_per_refine_pass: float # df64 residual + true-residual check
    spmv_equiv: float          # nnz_per_iter in units of one fine SpMV

    def effective_nnz(self, iterations: int, passes: int = 0) -> float:
        return (self.nnz_per_iter * max(iterations, 1)
                + self.nnz_per_refine_pass * passes)


def footprint_table(dev, A64=None, A32=None) -> list:
    """Per-level, per-component persistent device bytes: one dict per
    level with the bytes of the operator, transfers, smoother vectors,
    coarse inverse and gs2 triangles, then a row each for the fp64 and
    fp32 fine operators when given (``AMGSolver.A64``/``A32``).  A tensor
    storage shared between fields or rows is counted once, at its first
    appearance, so the totals add up to ``AMGSolver.device_bytes()``."""
    from .meminfo import tree_device_bytes

    seen = set()
    price = lambda obj: tree_device_bytes(obj, seen)
    rows = []
    for li, lev in enumerate(dev.levels):
        rows.append({
            "level": li, "n": lev.n,
            "A": price(lev.A), "P": price(lev.P), "R": price(lev.R),
            "vectors": price((lev.dinv, lev.l1_dinv)),
            "coarse_inv": price(lev.coarse_inv),
            "tri": price((lev.L, lev.U)),
        })
    for name, op in (("fp64_fine", A64), ("fp32_fine", A32)):
        if op is not None:
            rows.append({"level": name, "n": dev.levels[0].n, "A": price(op),
                         "P": 0, "R": 0, "vectors": 0, "coarse_inv": 0,
                         "tri": 0})
    for r in rows:
        r["total"] = (r["A"] + r["P"] + r["R"] + r["vectors"]
                      + r["coarse_inv"] + r["tri"])
    return rows


def cycle_work(hier, dev, params) -> tuple:
    """(nnz, real bytes, padded bytes) of one preconditioner cycle; bytes
    are 0 without a device hierarchy (dev None)."""
    n_levels = hier.n_levels
    acc = [{"A": 0.0, "T": 0.0, "C": 0.0} for _ in range(n_levels)]
    _count_cycle(n_levels, 0, params.cycle, params, acc)

    nnz = 0.0
    nbytes = [0.0, 0.0]

    def add(times, ob):
        nbytes[0] += times * ob.real
        nbytes[1] += times * ob.padded

    for l, c in enumerate(acc):
        lev = hier.levels[l]
        dv = dev.levels[l] if dev is not None else None
        a_nnz = lev.A.nnz
        if c["A"]:
            nnz += c["A"] * a_nnz
            if dv is not None:
                add(c["A"], op_bytes(dv.A))
        if c["T"] and lev.P is not None:
            p_nnz = lev.P.nnz
            nnz += c["T"] * p_nnz
            if dv is not None:
                add(c["T"] / 2, op_bytes(dv.P))
                add(c["T"] / 2, op_bytes(dv.R))
        if c["C"]:
            nc = lev.A.shape[0]
            has_inv = (dv.coarse_inv is not None) if dv is not None else (
                nc <= params.coarse_inv_max
                and params.coarse_solver != "smooth")
            if has_inv:
                nnz += c["C"] * nc * nc
                if dv is not None:
                    r = dv.coarse_inv.shape[-1]
                    add(c["C"], OpBytes(4 * (nc * nc + 2 * nc),
                                        dv.coarse_inv.nbytes + 8 * r))
            else:
                sweeps = (dv.coarse_sweeps if dv is not None
                          else params.coarse_smooth_sweeps)
                nnz += c["C"] * sweeps * a_nnz
                if dv is not None:
                    add(c["C"] * sweeps, op_bytes(dv.A))
    return nnz, nbytes[0], nbytes[1]


def work_per_iteration(hier, dev, params, method: str = "cg",
                       mv_op=None) -> WorkModel:
    """Exact work of one AMG-preconditioned Krylov iteration.

    `hier` is the host Hierarchy (true nnz), `dev` the DeviceHierarchy
    (layouts for byte pricing; pass None to get nnz pricing only,
    bytes_per_iter = 0).  CG and the stationary 'amg' solve: 1 fine
    matvec + 1 cycle per iteration; BiCGStab: 2 + 2.  `mv_op`: the
    operator of the Krylov matvec (``AMGSolver._krylov_op``, the fp32
    fine operator), priced in place of the cycle's fine operator.
    """
    if method not in ("cg", "bicgstab", "amg"):
        raise ValueError(f"unknown Krylov method {method!r}")
    nnz, nbytes, _ = cycle_work(hier, dev, params)
    fine_nnz = hier.levels[0].A.nnz
    mv, pc = (2, 2) if method == "bicgstab" else (1, 1)
    nnz_iter = mv * fine_nnz + pc * nnz
    bytes_iter = 0.0
    if dev is not None:
        fine = mv_op if mv_op is not None else dev.levels[0].A
        bytes_iter = mv * op_bytes(fine).real + pc * nbytes
    # one refinement pass: fp64 residual + true-residual norm check = two
    # fine-level operator passes
    pass_nnz = 2.0 * fine_nnz
    return WorkModel(nnz_per_iter=nnz_iter, bytes_per_iter=bytes_iter,
                     nnz_per_refine_pass=pass_nnz,
                     spmv_equiv=nnz_iter / max(fine_nnz, 1))
