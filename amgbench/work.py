"""The device-memory bytes a solve needs, and the card's data-sheet memory
rate: the benchmark's yardstick for ``solve_roofline_pct``.

The cycle count is a frozen copy of
``sparsh_amg_tpu_torch/utils/accounting.py`` (``_smoother_applies``,
``_count_cycle``, ``work_per_iteration``'s CG/BiCGStab multiplicities).
The byte rule is that file's ``op_bytes(...).real`` (each stored value
once, the source vector read once, the destination written once), priced
on the host hierarchy's CSR matrices and never on the port's device
layouts, so the count is the same whatever implements a level.  One
departure: no index bytes.  A level the port holds as diagonals (the
flagship's fine level) carries none, and pricing 4 bytes an entry there
would count its bytes 3x and let the share pass 100% as those kernels
near their bound; without them the count is the least any layout moves.

Not counted: the Krylov loop's own vector updates and dots, and vectors
a fused kernel reads beside its operator.  So the share is of a lower
bound on the bytes and reads low, never high.
"""
from __future__ import annotations

# Data-sheet device-memory rates in bytes/s by the name
# torch.cuda.get_device_name gives (NVIDIA's data sheets, SXM parts; the
# copy of sparsh_amg_tpu_torch/utils/meminfo.py::_HBM_SPEC_BYTES_PER_S).
PEAK_BYTES_PER_S = {"H100 80GB HBM3": 3.35e12}

VALUE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


def peak_bytes_per_s(card_name: str) -> float | None:
    """The data-sheet rate of the card, or None for a card not in the
    table (the roofline share is then not reported)."""
    for key, rate in PEAK_BYTES_PER_S.items():
        if key in card_name:
            return rate
    return None


def smoother_applies(amg: dict, coarse: bool) -> float:
    """Operator applications of ONE smooth() call."""
    name = amg["smoother"]
    if name == "chebyshev":
        return (amg["cheby_degree_coarse"]
                if coarse and amg["cheby_degree_coarse"]
                else amg["cheby_degree"])
    if name in ("jacobi", "l1jacobi"):
        return amg["nu1"]
    if name == "gs2":
        return amg["nu1"] * (1.0 + 0.5 * amg["gs_stages"])
    raise ValueError(f"unknown smoother {name!r}")


def count_cycle(n_levels: int, level: int, shape: str, amg: dict,
                acc: list) -> None:
    """Visit the levels as one cycle does: acc[l] counts operator
    applications ("A"), transfer applications ("T", one R and one P a
    visit) and coarse solves ("C")."""
    if level == n_levels - 1:
        acc[level]["C"] += 1
        return
    pre = smoother_applies(amg, coarse=level >= amg["cheby_coarse_from"])
    post = pre if amg["smoother"] == "chebyshev" else \
        pre / max(amg["nu1"], 1) * amg["nu2"]
    acc[level]["A"] += pre + 1 + post
    acc[level]["T"] += 2
    if shape == "V":
        count_cycle(n_levels, level + 1, "V", amg, acc)
    elif shape == "W":
        count_cycle(n_levels, level + 1, "W", amg, acc)
        count_cycle(n_levels, level + 1, "W", amg, acc)
    elif shape == "F":
        count_cycle(n_levels, level + 1, "F", amg, acc)
        count_cycle(n_levels, level + 1, "V", amg, acc)
    else:
        raise ValueError(f"unknown cycle {shape!r}")


def spmv_bytes(nnz: int, rows: int, cols: int, value_bytes: int,
               vector_bytes: int = 4) -> int:
    """Each stored value once, the source read once, the destination
    written once."""
    return nnz * value_bytes + vector_bytes * (rows + cols)


def levels_of(hierarchy) -> list:
    """The host hierarchy as plain numbers: per level its rows, nnz and
    (rows, cols, nnz) of P (to it from the next level) and R."""
    def shape(M):
        return None if M is None else (M.shape[0], M.shape[1], int(M.nnz))
    return [{"n": lev.A.shape[0], "nnz": int(lev.A.nnz),
             "P": shape(lev.P), "R": shape(lev.R)}
            for lev in hierarchy.levels]


def solve_bytes(levels: list, amg: dict, krylov: dict) -> dict:
    """{"iteration": bytes of one Krylov iteration, "pass": bytes of one
    refinement pass's fp64 residual} for the hierarchy `levels`
    (``levels_of``) under the configuration's parameters."""
    vb = VALUE_BYTES[amg["band_dtype"]]
    n_levels = len(levels)
    acc = [{"A": 0.0, "T": 0.0, "C": 0.0} for _ in range(n_levels)]
    count_cycle(n_levels, 0, amg["cycle"], amg, acc)
    cycle = 0.0
    for lev, c in zip(levels, acc):
        n, nnz = lev["n"], lev["nnz"]
        cycle += c["A"] * spmv_bytes(nnz, n, n, vb)
        if c["T"] and lev["P"] is not None:
            for rows, cols, t_nnz in (lev["P"], lev["R"]):
                cycle += c["T"] / 2 * spmv_bytes(t_nnz, rows, cols, vb)
        if c["C"]:
            if (n <= amg["coarse_inv_max"]
                    and amg["coarse_solver"] != "smooth"):
                # the explicit fp32 inverse, one dense matvec
                cycle += c["C"] * spmv_bytes(n * n, n, n, 4)
            else:
                cycle += (c["C"] * amg["coarse_smooth_sweeps"]
                          * spmv_bytes(nnz, n, n, vb))
    fine_n, fine_nnz = levels[0]["n"], levels[0]["nnz"]
    mv, pc = (2, 2) if krylov["method"] == "bicgstab" else (1, 1)
    krylov_vb = VALUE_BYTES[amg["dtype"]]
    iteration = mv * spmv_bytes(fine_nnz, fine_n, fine_n, krylov_vb) \
        + pc * cycle
    # each pass ends in one fp64 residual b - A x on the fine operator
    per_pass = spmv_bytes(fine_nnz, fine_n, fine_n, 8, 8)
    return {"iteration": iteration, "pass": per_pass}
