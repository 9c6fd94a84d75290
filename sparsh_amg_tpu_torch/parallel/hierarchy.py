"""Distributed device hierarchy (the port of
``sparsh_amg_tpu/parallel/hierarchy.py``).

Every level above ``params.replicate_size`` rows is row-partitioned over
the ranks (``Partition``: identical padded blocks), and each rank freezes
only its own block: rank r's arrays equal the JAX package's stacked
``[r]`` slice.  Smaller levels are replicated: every rank holds the whole
level as a serial ``DeviceLevel`` and runs its smoothers and transfers
with no collective (the reference's "gather small coarse grids onto fewer
processors").  The level above them crosses the boundary through
``GatherOut`` / ``ReplSrc``.  A distributed coarsest level agglomerates:
its dense inverse is split by rows, so each rank computes its rows of
``A_c^-1 (all_gather r_c)``.

``DistLevel`` keeps ``DeviceLevel``'s field names, so the serial
smoothers, cycles and Krylov steps run on it unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.formats import _round_up, csr_to_dense, csr_to_device, csr_to_ell
from ..ops.fp64 import _hi_lo
from ..params import AMGParams
from ..setup.hierarchy import Hierarchy
from ..solve.device import (DeviceLevel, _f32, _torch_dtype, abs_row_sum,
                            dense_inverse, lambda_max_estimate)
from .dist import (DistDia, DistEll, GatherOut, RankGroup, ReplSrc,
                   csr_to_dist)
from .partition import Partition


@dataclasses.dataclass(frozen=True)
class DistFp64:
    """The fine operator of the refinement residuals in native fp64 (the
    JAX package's df64 pair hi + lo), and ``A_hi``, the same layout in fp32
    for the Krylov matvec (the cycle may hold bf16 bands)."""
    A: object                 # DistDia | DistEll, fp64 values
    A_hi: object              # the same layout, fp32 values

    def spmv64(self, x: torch.Tensor) -> torch.Tensor:
        return self.A.spmv_plain(x)


@dataclasses.dataclass(frozen=True)
class DistLevel:
    """One distributed level: this rank's block of each operator and
    vector, under ``DeviceLevel``'s field names."""
    A: object                  # DistDia | DistEll | DistDense
    dinv: torch.Tensor         # (n_loc,)
    l1_dinv: torch.Tensor
    lam_max: float
    P: object | None           # coarse -> fine (None on the coarsest)
    R: object | None           # fine -> coarse
    coarse_inv: torch.Tensor | None   # (n_loc, n_pad): rows of A_c^-1
    ranks: RankGroup
    L: object | None = None    # strict lower triangle (two-stage GS)
    U: object | None = None    # strict upper triangle
    n: int = 0
    coarse_sweeps: int = 16    # l1-Jacobi sweeps when coarse_inv is None

    @property
    def n_pad(self) -> int:
        return self.dinv.shape[0]

    def coarse_solve(self, b: torch.Tensor) -> torch.Tensor:
        """(A_c^-1 b) on this rank's rows: all-gather b, then the local
        row slice of the dense inverse; without an inverse,
        coarse_sweeps of l1-Jacobi."""
        if self.coarse_inv is None:
            from ..solve.smoothers import l1_jacobi
            return l1_jacobi(self, b, torch.zeros_like(b),
                             sweeps=self.coarse_sweeps, zero_start=True)
        return torch.mv(self.coarse_inv, self.ranks.all_gather(b))


@dataclasses.dataclass(frozen=True)
class DistHierarchy:
    levels: tuple              # DistLevel | DeviceLevel (replicated)
    parts: tuple               # Partition per level
    ranks: RankGroup

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def _vec(part: Partition, rank: int, v: np.ndarray, dtype, device):
    """This rank's block of a length-n vector, zero-padded to n_loc."""
    out = np.zeros(part.n_loc)
    r0 = min(rank * part.n_loc, part.n)
    r1 = min(r0 + part.n_loc, part.n)
    out[: r1 - r0] = v[r0:r1]
    return torch.from_numpy(out).to(device=device, dtype=dtype)


def _diag_stats(A: sp.csr_matrix):
    """(1/a_ii, 1/(a_ii + sum_j!=i |a_ij|), diagonal, abs row sums), 0
    where the denominator is 0."""
    d = A.diagonal()
    absrow = abs_row_sum(A)
    l1d = d + (absrow - np.abs(d))
    return (np.where(d != 0, 1.0 / d, 0.0),
            np.where(l1d != 0, 1.0 / l1d, 0.0), d, absrow)


def _replicated_level(lev, part: Partition, next_part: Partition | None,
                      params: AMGParams, dtype, bdtype, is_coarsest: bool,
                      *, device) -> DeviceLevel:
    """A level in replicated form: the whole serial DeviceLevel on every
    rank, vectors of length part.n_pad so that the GatherOut all-gather
    at the boundary lines up."""
    A = lev.A
    n = A.shape[0]
    L_pad = part.n_pad
    dev_A = csr_to_device(A, dtype=bdtype, prefer_dia=params.prefer_dia,
                          dia_max_bands=params.dia_max_bands,
                          dense_size=params.dense_size, pad_multiple=L_pad,
                          device=device)
    dinv_h, l1_h, d, absrow = _diag_stats(A)
    dinv, l1_dinv = np.zeros(L_pad), np.zeros(L_pad)
    dinv[:n], l1_dinv[:n] = dinv_h, l1_h
    lam = lambda_max_estimate(A, d, absrow, params.lambda_max) \
        if not is_coarsest or n > 1 else 1.0

    P = R = coarse_inv = None
    if not is_coarsest:
        nc = lev.P.shape[1]
        M_pad = next_part.n_pad
        if max(n, nc) <= params.dense_size:
            # tight dense blocks; spmv re-pads to the level vector lengths
            P = csr_to_dense(lev.P.tocsr(), dtype=bdtype, out_pad=L_pad,
                             in_pad=M_pad, device=device)
            R = csr_to_dense(lev.R.tocsr(), dtype=bdtype, out_pad=M_pad,
                             in_pad=L_pad, device=device)
        else:
            P = csr_to_ell(lev.P.tocsr(), dtype=bdtype, pad_multiple=L_pad,
                           device=device)
            R = csr_to_ell(lev.R.tocsr(), dtype=bdtype, pad_multiple=M_pad,
                           device=device)
    elif n <= params.coarse_inv_max and params.coarse_solver != "smooth":
        # tight 256-pad; DeviceLevel.coarse_solve slices and pads
        r = min(_round_up(max(n, 1), 256), L_pad)
        dense = np.zeros((r, r), dtype=np.float32)
        dense[:n, :n] = dense_inverse(A, params.coarse_solver)
        coarse_inv = torch.from_numpy(dense).to(device=device, dtype=dtype)

    Lt = Ut = None
    if params.smoother == "gs2" and coarse_inv is None:
        conv = lambda T: csr_to_device(
            T.tocsr(), dtype=bdtype, prefer_dia=params.prefer_dia,
            dia_max_bands=params.dia_max_bands,
            dense_size=params.dense_size, pad_multiple=L_pad, device=device)
        Lt = conv(sp.tril(A, -1))
        Ut = conv(sp.triu(A, 1))

    t = lambda v: torch.from_numpy(v).to(device=device, dtype=dtype)
    return DeviceLevel(A=dev_A, dinv=t(dinv), l1_dinv=t(l1_dinv),
                       lam_max=_f32(lam), P=P, R=R, coarse_inv=coarse_inv,
                       n=n, coarse_sweeps=params.coarse_smooth_sweeps,
                       L=Lt, U=Ut)


def partitions(ns: list, nranks: int, params: AMGParams) -> list:
    """The Partition of each level of sizes `ns`: coarse levels get a
    shard height of at least params.sub_mesh_min_rows (their rows on the
    leading ranks, trailing ranks all padding), never the finest."""
    parts = []
    for li, n in enumerate(ns):
        part = Partition.make(n, nranks,
                              pad_multiple=params.row_align or 128)
        if (li > 0 and params.sub_mesh_min_rows
                and n > params.replicate_size
                and part.n_loc < params.sub_mesh_min_rows):
            part = Partition(n=n, nd=nranks, n_loc=_round_up(
                params.sub_mesh_min_rows, max(128, params.row_align)))
        parts.append(part)
    return parts


def to_dist(hier: Hierarchy, rank: int, nranks: int,
            params: AMGParams | None = None, dtype=None, group=None, *,
            device) -> DistHierarchy:
    """Freeze rank `rank`'s block of a host hierarchy over `nranks` ranks
    (collectives over `group`, None: the default process group).

    Levels with n <= params.replicate_size (never the finest) are
    replicated; the level above them carries GatherOut / ReplSrc."""
    params = params or hier.params
    dtype = _torch_dtype(dtype or params.dtype)
    bdtype = _torch_dtype(params.band_dtype)
    ranks = RankGroup(rank, nranks, group)
    parts = partitions([lev.A.shape[0] for lev in hier.levels], nranks,
                       params)
    n_lv = len(hier.levels)
    rep_from = n_lv
    if params.replicate_size > 0:
        for i in range(1, n_lv):
            if hier.levels[i].A.shape[0] <= params.replicate_size:
                rep_from = i
                break
    conv = lambda M, pd, ps, **kw: csr_to_dist(
        M.tocsr(), pd, ps, ranks, dtype=bdtype, device=device, **kw)
    levels = []
    for li, lev in enumerate(hier.levels):
        A = lev.A
        n = A.shape[0]
        part = parts[li]
        is_coarsest = li == n_lv - 1 or lev.P is None
        if li >= rep_from:
            levels.append(_replicated_level(
                lev, part, parts[li + 1] if not is_coarsest else None,
                params, dtype, bdtype, is_coarsest, device=device))
            continue
        dev_A = conv(A, part, part, prefer_dia=params.prefer_dia,
                     dia_max_bands=params.dia_max_bands,
                     dense_size=params.dense_size)
        dinv, l1_dinv, d, absrow = _diag_stats(A)
        lam = lambda_max_estimate(A, d, absrow, params.lambda_max) \
            if not is_coarsest or n > 1 else 1.0

        P = R = coarse_inv = None
        if not is_coarsest:
            cpart = parts[li + 1]
            nc = lev.P.shape[1]
            pr_dense = params.dense_size \
                if max(n, nc) <= params.dense_size else 0
            if li + 1 >= rep_from:
                # replication boundary: R all-gathers its distributed
                # product; P consumes the already-full coarse vector
                # (gather-mode columns, no collective)
                R = GatherOut(op=conv(lev.R, cpart, part, prefer_dia=False,
                                      dense_size=pr_dense))
                P = ReplSrc(op=conv(lev.P, part, cpart, prefer_dia=False,
                                    dense_size=pr_dense,
                                    max_halo_frac=-1.0))
            else:
                P = conv(lev.P, part, cpart, prefer_dia=False,
                         dense_size=pr_dense)
                R = conv(lev.R, cpart, part, prefer_dia=False,
                         dense_size=pr_dense)
        elif n <= params.coarse_inv_max and params.coarse_solver != "smooth":
            r0 = min(rank * part.n_loc, n)
            r1 = min(r0 + part.n_loc, n)
            inv = dense_inverse(A, params.coarse_solver)
            rows = np.zeros((part.n_loc, part.n_pad), dtype=np.float32)
            rows[: r1 - r0, :n] = inv[r0:r1]
            # fp32 always, not band_dtype (as solve/device.py)
            coarse_inv = torch.from_numpy(rows).to(device=device,
                                                   dtype=dtype)

        L = U = None
        if params.smoother == "gs2" and coarse_inv is None:
            tri = lambda T: conv(T, part, part,
                                 prefer_dia=params.prefer_dia,
                                 dia_max_bands=params.dia_max_bands,
                                 dense_size=params.dense_size)
            L = tri(sp.tril(A, -1))
            U = tri(sp.triu(A, 1))

        vec = lambda v: _vec(part, rank, v, dtype, device)
        levels.append(DistLevel(
            A=dev_A, dinv=vec(dinv), l1_dinv=vec(l1_dinv), lam_max=_f32(lam),
            P=P, R=R, coarse_inv=coarse_inv, ranks=ranks, L=L, U=U, n=n,
            coarse_sweeps=params.coarse_smooth_sweeps))
    return DistHierarchy(levels=tuple(levels), parts=tuple(parts),
                         ranks=ranks)


def fp64_operator(A_fp64, dtype=torch.float32) -> DistFp64:
    """DistFp64 from the fp64 layout: A_hi is its values cast to fp32."""
    if isinstance(A_fp64, DistDia):
        hi = dataclasses.replace(A_fp64, bands=A_fp64.bands.to(dtype))
    else:
        assert isinstance(A_fp64, DistEll)
        ext = None if A_fp64.mode != "halo" else torch.zeros(
            A_fp64.n_src + 2 * A_fp64.h, dtype=torch.float32,
            device=A_fp64.local.vals.device)
        hi = dataclasses.replace(A_fp64, local=A_fp64.local.astype(dtype),
                                 ext=ext)
    return DistFp64(A=A_fp64, A_hi=hi)


def fine_fp64(hier: Hierarchy, dist: DistHierarchy, params: AMGParams, *,
              device) -> DistFp64:
    """The fp64 fine operator of the distributed refinement (the JAX
    package's ``fine_df64``): values hi + lo of the df64 split."""
    A = hier.levels[0].A.copy()
    A.data = _hi_lo(A.data)
    part = dist.parts[0]
    A64 = csr_to_dist(A, part, part, dist.ranks, dtype=torch.float64,
                      prefer_dia=params.prefer_dia,
                      dia_max_bands=params.dia_max_bands, device=device)
    return fp64_operator(A64)
