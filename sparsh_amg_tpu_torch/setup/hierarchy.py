"""AMG hierarchy construction (SURVEY.md §3.2 `amg_setup`).

Recursively: strength -> coarsen (RS | PMIS | aggregation) -> build P ->
R = P^T -> Galerkin RAP, until the coarse problem is small enough.  Runs
entirely on the host in float64 (the reference's CPU setup phase); the
resulting hierarchy is then frozen into padded device layouts by
:mod:`sparsh_amg_tpu.ops.device_hierarchy`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from ..params import AMGParams
from ..utils import trace
from .strength import classical_strength, symmetric_strength
from .splitting import rs_splitting, pmis_splitting
from .interp import (direct_interpolation, extpi_interpolation,
                     truncate_rows)
from .aggregate import (greedy_aggregation, tentative_prolongator,
                        tentative_prolongator_nullspace, smooth_prolongator)
from .galerkin import galerkin_product, spgemm
from .transpose import csr_transpose


@dataclasses.dataclass
class Level:
    """One level of the hierarchy (host-side, float64 CSR)."""
    A: sp.csr_matrix
    P: sp.csr_matrix | None = None   # prolongation to THIS level from coarser
    R: sp.csr_matrix | None = None   # restriction from this level to coarser
    cf: np.ndarray | None = None     # C/F split used here (None for agg)
    agg: np.ndarray | None = None    # aggregate map (aggregation coarsening)
    bs: int = 1                      # dofs per node of THIS level's block
                                     # structure (fine: params.agg_blocksize;
                                     # SA coarse levels: the nullspace dim —
                                     # drives the block-GELL device layout)

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def nnz(self) -> int:
        return self.A.nnz


@dataclasses.dataclass
class Hierarchy:
    levels: list[Level]
    params: AMGParams

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def operator_complexity(self) -> float:
        return sum(l.nnz for l in self.levels) / max(self.levels[0].nnz, 1)

    def grid_complexity(self) -> float:
        return sum(l.n for l in self.levels) / max(self.levels[0].n, 1)

    def __repr__(self):
        rows = [
            f"  level {i}: n={l.n:>12,d}  nnz={l.nnz:>14,d}"
            for i, l in enumerate(self.levels)
        ]
        return (f"Hierarchy({self.params.coarsening}, "
                f"{self.n_levels} levels, opC={self.operator_complexity():.2f})\n"
                + "\n".join(rows))


def _rap(A: sp.csr_matrix, P: sp.csr_matrix, R: sp.csr_matrix,
         drop_tol: float) -> sp.csr_matrix:
    """One Galerkin product R A P (span ``setup.rap``, counted in
    ``setup.rap_products``)."""
    with trace.span("setup.rap"):
        trace.count("setup.rap_products")
        return galerkin_product(A, P, R=R, drop_tol=drop_tol)


def _transpose(P: sp.csr_matrix) -> sp.csr_matrix:
    with trace.span("setup.transpose"):
        return csr_transpose(P)


def _coarsen_once(A: sp.csr_matrix, params: AMGParams,
                  B: np.ndarray | None = None, blocksize: int = 1):
    """One setup step: returns (P, cf, agg, B_coarse) or None on stall.

    ``blocksize`` > 1 amalgamates `blocksize` dofs per node before
    aggregation (systems like elasticity; pyamg/ML convention) — the
    aggregates then never split a node's dof group."""
    if params.coarsening in ("rs", "pmis", "hmis"):
        with trace.span("setup.strength"):
            strong_mask, S = classical_strength(A, params.theta)
        with trace.span("setup.coarsen"):
            if params.coarsening == "rs":
                cf = rs_splitting(S)
            elif params.coarsening == "hmis":
                # one-pass RS (no F-F second pass): the serial core of
                # HMIS (De Sterck/Yang/Heys 2006) — aggressive like PMIS
                # but seeded by the RS measure; pair with distance-2 interp
                cf = rs_splitting(S, second_pass=False)
            else:
                cf = pmis_splitting(S)
        n_c = int((cf == 1).sum())
        if n_c == 0 or n_c >= A.shape[0]:
            return None
        with trace.span("setup.interp"):
            if params.interpolation == "extpi":
                P = extpi_interpolation(A, strong_mask, cf)
            else:
                P = direct_interpolation(A, strong_mask, cf)
            P = truncate_rows(P, params.interp_max)
        return P, cf, None, None
    elif params.coarsening == "aggregation":
        with trace.span("setup.strength"):
            strong_mask, S = symmetric_strength(A, params.agg_theta)
        if blocksize > 1 and A.shape[0] % blocksize == 0:
            from .aggregate import amalgamate
            with trace.span("setup.coarsen"):
                N = amalgamate(A, blocksize)
            with trace.span("setup.strength"):
                _, Sn = symmetric_strength(N, params.agg_theta)
            with trace.span("setup.coarsen"):
                aggn, n_agg = greedy_aggregation(Sn)
                agg = np.repeat(aggn, blocksize)
        else:
            with trace.span("setup.coarsen"):
                agg, n_agg = greedy_aggregation(S)
        if n_agg == 0 or n_agg >= A.shape[0]:
            return None
        B_c = None
        with trace.span("setup.interp"):
            if B is not None:
                # near-nullspace SA (rigid-body modes for elasticity):
                # aggregate-local QR of B becomes P_tent; R becomes
                # coarse B
                P, B_c = tentative_prolongator_nullspace(agg, n_agg, B)
            else:
                P = tentative_prolongator(agg, n_agg)
            if params.interpolation == "smoothed":
                P = smooth_prolongator(
                    A, P, params.jacobi_omega_smooth_P,
                    strong_mask=(strong_mask if params.p_smooth_filter
                                 else None),
                    compensation=params.p_smooth_compensation,
                    spectral=params.p_smooth_spectral)
        return P, None, agg, B_c
    raise ValueError(f"unknown coarsening {params.coarsening!r}")


def _coarsen_aggressive(A: sp.csr_matrix, params: AMGParams):
    """One AGGRESSIVE setup step, hypre-style (aggressive="pmis2"): a
    second PMIS round on the distance-2 C-C strength graph picks the
    final C set, and multipass interpolation builds P straight from the
    fine A — the composed path's intermediate RAP + second ext+i round
    (~22 s of the 41 s 192^3 setup) never happens.  Returns
    (P, cf_final) or None on stall."""
    from .splitting import dist2_cc_graph, CPT, FPT
    from .interp import multipass_interpolation
    with trace.span("setup.strength"):
        strong_mask, S = classical_strength(A, params.theta)
    with trace.span("setup.coarsen"):
        if params.coarsening == "hmis":
            cf1 = rs_splitting(S, second_pass=False)
        else:
            cf1 = pmis_splitting(S)
    n_c1 = int((cf1 == CPT).sum())
    if n_c1 == 0 or n_c1 >= A.shape[0]:
        return None
    with trace.span("setup.coarsen"):
        S2 = dist2_cc_graph(S, cf1)
        cf2 = pmis_splitting(S2, seed=1)
        cf = cf1.copy()
        c1_idx = np.flatnonzero(cf1 == CPT)
        cf[c1_idx[cf2 == FPT]] = FPT
    n_c = int((cf == CPT).sum())
    if n_c == 0 or n_c >= A.shape[0]:
        return None
    cap = params.interp_max_composed or params.interp_max or 5
    omega = params.jacobi_omega_smooth_P if params.multipass_smooth else None
    with trace.span("setup.interp"):
        P = multipass_interpolation(A, strong_mask, cf, max_per_row=cap,
                                    smooth_omega=omega)
    return P, cf


@trace.spanned("setup")
def amg_setup(A: sp.csr_matrix, params: AMGParams | None = None,
              nullspace: np.ndarray | None = None) -> Hierarchy:
    """Build the AMG hierarchy for CSR matrix A (host, float64).

    ``nullspace`` is an optional (n, k) near-nullspace basis for
    aggregation coarsening (e.g. rigid-body modes for elasticity); it is
    carried down the hierarchy via the aggregate-local QR coarse basis.
    Traced as the span ``setup``, one ``setup.level`` a coarsening step.
    """
    params = params or AMGParams()
    A = A.tocsr()
    if A.dtype != np.float64:
        A = A.astype(np.float64)    # astype always copies; skip when clean
    elif not A.has_canonical_format:
        A = A.copy()                # sum_duplicates mutates in place
    A.sum_duplicates()
    levels = [Level(A=A, bs=(params.agg_blocksize
                             if A.shape[0] % max(params.agg_blocksize, 1)
                             == 0 else 1))]
    B = None
    if nullspace is not None:
        B = np.ascontiguousarray(nullspace, dtype=np.float64)
        if B.ndim == 1:
            B = B[:, None]
    while (levels[-1].n > params.coarse_size
           and len(levels) < params.max_levels):
        with trace.span("setup.level", level=len(levels) - 1,
                        rows=levels[-1].n, nnz=levels[-1].nnz):
            if (len(levels) <= params.agg_levels
                    and params.coarsening in ("rs", "pmis", "hmis")
                    and params.aggressive == "pmis2"):
                out = _coarsen_aggressive(levels[-1].A, params)
                if out is None:
                    break
                P, cf = out
                R = _transpose(P)
                Ac = _rap(levels[-1].A, P, R, params.rap_drop_tol)
                levels[-1].P = P
                levels[-1].R = R
                levels[-1].cf = cf
                if Ac.shape[0] >= 0.95 * levels[-1].n and len(levels) > 1:
                    levels[-1].P = None
                    levels[-1].R = None
                    break
                levels.append(Level(A=Ac))
                continue
            # finest level: user-declared dofs-per-node; coarser levels
            # carry the near-nullspace dimension as the natural block size
            # (each aggregate contributed a k-column block to P)
            if len(levels) == 1:
                bs = params.agg_blocksize
            else:
                bs = B.shape[1] if B is not None else 1
            out = _coarsen_once(levels[-1].A, params, B, blocksize=bs)
            if out is None:
                break
            P, cf, agg, B_c = out
            R = _transpose(P)
            # when this step composes two coarsenings AND re-forms the
            # final operator from the fine A (interp_max_composed), the
            # first RAP is a throwaway used only to seed the second
            # split/interp — filter it harder (intermediate_drop_tol) to
            # cut its SpGEMM + extpi cost
            composing = (len(levels) <= params.agg_levels
                         and params.coarsening in ("rs", "pmis", "hmis"))
            drop = params.rap_drop_tol
            if (composing and params.interp_max_composed > 0
                    and params.intermediate_drop_tol > 0.0):
                drop = params.intermediate_drop_tol
            Ac = _rap(levels[-1].A, P, R, drop)
            ac_is_throwaway = drop != params.rap_drop_tol
            # aggressive coarsening: compose a second coarsening round so
            # the intermediate grid never becomes a cycle level.  The
            # Galerkin operator is exactly the two-step one
            # (A2 = P2^T (P1^T A P1) P2); only the stored transfer is the
            # product P1@P2.
            if (len(levels) <= params.agg_levels
                    and params.coarsening in ("rs", "pmis", "hmis")
                    and Ac.shape[0] > params.coarse_size):
                out2 = _coarsen_once(Ac, params)
                if out2 is not None:
                    ac_is_throwaway = False  # Ac re-formed below
                    P2, _, _, _ = out2
                    R2 = _transpose(P2)
                    cf = None           # composed split has no single C/F
                    if params.interp_max_composed > 0:
                        # hypre-style truncation of the composed
                        # interpolation (sign-separated rescaling), then
                        # the Galerkin operator is re-formed from the
                        # FINE-level A so the hierarchy stays variational
                        # wrt the stored P/R
                        from .interp import truncate_rows
                        with trace.span("setup.interp"):
                            P = truncate_rows(spgemm(P, P2),
                                              params.interp_max_composed)
                        R = _transpose(P)
                        Ac = _rap(levels[-1].A, P, R, params.rap_drop_tol)
                    else:
                        # (P1 P2)^T as a parallel product of the two
                        # transposes — transposing the composed fine-level
                        # P would be a serial scipy csc pass over the
                        # largest operator
                        with trace.span("setup.interp"):
                            P = spgemm(P, P2)
                        with trace.span("setup.transpose"):
                            R = spgemm(R2, R)
                        Ac = _rap(Ac, P2, R2, params.rap_drop_tol)
            if ac_is_throwaway:
                # the second coarsening never happened (level small enough
                # or stalled): the hard-filtered intermediate would become
                # a real cycle level — rebuild it at the standard tolerance
                trace.count("setup.rap_discarded")
                Ac = _rap(levels[-1].A, P, R, params.rap_drop_tol)
            B = B_c
            levels[-1].P = P
            levels[-1].R = R
            levels[-1].cf = cf
            levels[-1].agg = agg
            # guard against stagnating coarsening (ratio too close to 1)
            if Ac.shape[0] >= 0.95 * levels[-1].n and len(levels) > 1:
                levels[-1].P = None
                levels[-1].R = None
                break
            # SA-with-nullspace coarse dofs come in aggregate blocks of k
            # — the block structure the block-GELL device layout exploits
            bs_c = B_c.shape[1] if B_c is not None \
                and Ac.shape[0] % B_c.shape[1] == 0 else 1
            levels.append(Level(A=Ac, bs=bs_c))
    return Hierarchy(levels=levels, params=params)
