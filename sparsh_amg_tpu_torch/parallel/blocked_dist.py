"""Process-local freeze of a BlockedHierarchy (the port of
``sparsh_amg_tpu/parallel/blocked_dist.py``).

``to_dist`` freezes rank r's block from the GLOBAL host hierarchy, which
every rank must then hold.  Here each rank freezes its block from its own
:class:`~..setup.blocked.BlockedHierarchy` (its rows of every blocked
level, and the gathered coarse tail), agreeing with the other ranks on
the shared static metadata (DIA offsets, ELL K and halo widths, Chebyshev
lambda_max) through the same :class:`~..setup.comm.BlockComm` the blocked
setup used.  Each rank's block equals what ``to_dist`` builds for it from
the global hierarchy, value for value (tests/test_torch_blocked.py), so no
rank ever holds a global matrix, hierarchy or O(n) vector (the replicated
coarse tail is small by construction).  One process per rank: the JAX
package's several devices per process (``dpp``) become ranks.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.fp64 import _hi_lo
from ..params import AMGParams
from ..setup.blocked import BlockedHierarchy
from ..setup.comm import BlockComm
from ..solve.device import _f32, _torch_dtype, abs_row_sum
from .dist import (DistDia, DistDense, GatherOut, RankGroup, ReplSrc,
                   _dist_ell, _upload)
from .hierarchy import (DistHierarchy, DistLevel, _replicated_level,
                        fp64_operator, partitions)
from .partition import Partition, _round_up

_I64 = np.int64


# ---------------------------------------------------------------------------
# Small per-block helpers (copied from the JAX package's module)
# ---------------------------------------------------------------------------

def _rows_of_nnz(A: sp.csr_matrix) -> np.ndarray:
    return np.repeat(np.arange(A.shape[0], dtype=_I64), np.diff(A.indptr))


def block_diag(A_own: sp.csr_matrix, r0: int) -> np.ndarray:
    """Diagonal entries of a row-block CSR with global columns (the
    diagonal of local row i sits at column r0 + i)."""
    rows = _rows_of_nnz(A_own)
    mask = A_own.indices == (rows + r0)
    d = np.zeros(A_own.shape[0], dtype=np.float64)
    d[rows[mask]] = A_own.data[mask]
    return d


def block_tri(A_own: sp.csr_matrix, r0: int, upper: bool) -> sp.csr_matrix:
    """Strict upper/lower triangle of a row-block CSR with global
    columns (scipy's tril/triu compare against LOCAL row ids)."""
    rows = _rows_of_nnz(A_own) + r0
    keep = (A_own.indices > rows) if upper else (A_own.indices < rows)
    return sp.csr_matrix(
        (A_own.data[keep], A_own.indices[keep],
         np.concatenate([[0], np.cumsum(
             np.bincount(rows - r0, weights=keep,
                         minlength=A_own.shape[0])).astype(_I64)])),
        shape=A_own.shape)


def lambda_max_blocked(A_own: sp.csr_matrix, r0: int, n: int,
                       d_own: np.ndarray, absrow_own: np.ndarray,
                       comm: BlockComm, method: str = "hybrid") -> float:
    """Distributed lambda_max(D^-1 A) upper bound, numerically identical
    to `solve.device.lambda_max_estimate` on the assembled matrix:
    Gershgorin is an allreduce_max of the local row ratios; the hybrid
    power refinement (n <= _POWER_MAX_N only) runs the same row-wise
    recurrence with an allgather of the owned rows per iteration."""
    from ..solve.device import _POWER_MAX_N
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = np.where(d_own != 0, absrow_own / np.abs(d_own), 0.0)
    g_loc = float(ratios.max()) if ratios.size else 0.0
    g = float(comm.allreduce_max(g_loc))
    if g <= 0.0 or not np.isfinite(g):
        g = 1.0
    if method == "gershgorin":
        return g
    if method != "power" and n > _POWER_MAX_N:
        return g
    p = _power_blocked(A_own, d_own, n, comm)
    return p if method == "power" else min(p, g)


def _power_blocked(A_own: sp.csr_matrix, d_own: np.ndarray, n: int,
                   comm: BlockComm, iters: int = 20,
                   seed: int = 0) -> float:
    """Blocked twin of `solve.device._lambda_max_dinv_a`: every rank
    holds the same seeded global iterate, computes its owned rows of
    D^-1 A v, and the allgather reassembles it in rank order."""
    dinv = np.where(d_own != 0, 1.0 / d_own, 0.0)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v) + 1e-30
    lam = 1.0
    for _ in range(iters):
        w = np.concatenate(comm.allgather(dinv * (A_own @ v)))
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 1.0
        v = w / lam
    return lam * 1.05


def gather_csr(comm: BlockComm, A_own: sp.csr_matrix) -> sp.csr_matrix:
    """Assemble the (small) global CSR from every rank's row block —
    used only for matrices at or below the dense threshold."""
    blocks = comm.allgather((A_own.indptr, A_own.indices, A_own.data,
                             A_own.shape))
    rows = sum(b[3][0] for b in blocks)
    indptr = np.zeros(rows + 1, dtype=_I64)
    off = 0
    for ip, _, _, shp in blocks:
        indptr[off + 1: off + shp[0] + 1] = indptr[off] + ip[1:]
        off += shp[0]
    return sp.csr_matrix(
        (np.concatenate([b[2] for b in blocks]),
         np.concatenate([b[1] for b in blocks]),
         indptr), shape=(rows, blocks[0][3][1]))


# ---------------------------------------------------------------------------
# Process-local csr_to_dist
# ---------------------------------------------------------------------------

def csr_rows_to_dist(A_own: sp.csr_matrix, r0: int, part_dst: Partition,
                     part_src: Partition, comm: BlockComm, ranks: RankGroup,
                     dtype=torch.float32, prefer_dia: bool = True,
                     dia_max_bands: int = 32, max_halo_frac: float = 1.0,
                     dense_size: int = 0, *, device):
    """Process-local ``parallel.dist.csr_to_dist``: this rank's rows
    (global columns) in the layout the global builder picks, with the
    format and every static field agreed through `comm`."""
    nd, rank = part_dst.nd, ranks.rank
    n, m = int(part_dst.n), int(part_src.n)
    assert A_own.shape[1] == m
    nl_d, nl_s = part_dst.n_loc, part_src.n_loc
    assert r0 == min(rank * nl_d, n), "rank rows must align to its block"
    n_own = A_own.shape[0]

    nnz_g = int(comm.allreduce_sum(int(A_own.nnz)))

    if dense_size and n <= dense_size and m <= dense_size:
        A = gather_csr(comm, A_own)
        dense = np.zeros((nl_d, part_src.n_pad))
        dense[:n_own, :m] = A[r0:r0 + n_own].toarray()
        return DistDense(mat=_upload(dense, device, dtype), ranks=ranks,
                         n_rows=n, n_cols=m)

    rows_g = _rows_of_nnz(A_own) + r0
    cols = A_own.indices.astype(_I64)
    data = A_own.data

    if prefer_dia and n == m and nl_d == nl_s and nnz_g > 0:
        offs_loc = np.unique(cols - rows_g)
        offs = np.unique(np.concatenate(comm.allgather(offs_loc))) \
            if comm.size > 1 else offs_loc
        maxoff = int(np.abs(offs).max()) if len(offs) else 0
        h = _round_up(maxoff, 128) if maxoff else 0
        if (len(offs) <= dia_max_bands and h <= max_halo_frac * nl_s
                and len(offs) * n <= 4 * nnz_g):
            bands = np.zeros((len(offs), nl_d), dtype=np.float64)
            pos = np.searchsorted(offs, cols - rows_g)
            bands[pos, rows_g - r0] = data
            return DistDia(bands=_upload(bands, device, dtype),
                           offsets=tuple(int(o) for o in offs), h=h,
                           ranks=ranks, n_rows=n, n_cols=m)

    nnz_per_row = np.diff(A_own.indptr)
    K_loc = int(nnz_per_row.max()) if n_own > 0 and A_own.nnz else 0
    K = max(int(comm.allreduce_max(K_loc)), 1)
    s_idx = rows_g // nl_d
    t_idx, c_loc = np.divmod(cols, nl_s)
    d = t_idx - s_idx
    ok_loc = bool(np.all(np.abs(d) <= 1)) if len(d) else True
    feasible = nnz_g > 0 and \
        bool(comm.allreduce_sum(int(not ok_loc)) == 0)
    if feasible:
        h_r = int((c_loc[d == 1] + 1).max()) if np.any(d == 1) else 0
        h_l = int((nl_s - c_loc[d == -1]).max()) if np.any(d == -1) else 0
        h_r = int(comm.allreduce_max(h_r))
        h_l = int(comm.allreduce_max(h_l))
        h = _round_up(max(h_r, h_l), 128) if (h_r or h_l) else 0
    else:
        h = nl_s + 1
    mode = "halo" if h <= max_halo_frac * nl_s else "gather"

    if mode == "halo":
        ext = np.where(d == 0, h + c_loc,
                       np.where(d == 1, h + nl_s + c_loc,
                                c_loc - (nl_s - h)))
        fill = h
    else:
        ext = cols
        fill = 0
        h = 0

    slot = np.arange(A_own.nnz, dtype=_I64) - np.repeat(
        A_own.indptr[:-1].astype(_I64), nnz_per_row)
    r_loc = rows_g - r0
    cols_arr = np.full((K, nl_d), fill, dtype=np.int32)
    vals_arr = np.zeros((K, nl_d), dtype=np.float64)
    cols_arr[slot, r_loc] = ext
    vals_arr[slot, r_loc] = data
    lens = np.zeros(nl_d, dtype=np.int32)
    lens[:n_own] = nnz_per_row
    return _dist_ell(cols_arr, vals_arr, lens, h, mode, ranks, n, m, n_own,
                     nl_s, dtype, device)


# ---------------------------------------------------------------------------
# Hierarchy freeze + fp64 fine operator
# ---------------------------------------------------------------------------

def blocked_to_dist(bh: BlockedHierarchy, comm: BlockComm,
                    params: AMGParams | None = None, dtype=None,
                    group=None, *, device) -> DistHierarchy:
    """This rank's block of a BlockedHierarchy: the process-local twin of
    ``to_dist``.  Blocked levels become DistLevels, the gathered coarse
    tail replicated levels, exactly as the global path replicates every
    level at or below params.replicate_size."""
    params = params or bh.params
    dtype = _torch_dtype(dtype or params.dtype)
    bdtype = _torch_dtype(params.band_dtype)
    ranks = RankGroup(comm.rank, comm.size, group)
    blk, tail = bh.levels, bh.tail
    assert blk, "no blocked levels (problem below the blocked threshold)"
    ns = [l.n for l in blk] + [lev.A.shape[0] for lev in tail.levels]
    parts = partitions(ns, comm.size, params.replace(sub_mesh_min_rows=0))
    # the split must reproduce to_dist's replicate_size boundary: every
    # tail level replicated, every blocked level distributed
    assert all(l.n > params.replicate_size for l in blk)
    assert tail.levels[0].A.shape[0] <= params.replicate_size
    n_blk = len(blk)
    levels = []
    for li, bl in enumerate(blk):
        part = parts[li]
        assert bl.r0 == min(comm.rank * part.n_loc, bl.n), \
            "blocked level not aligned to the rank partition " \
            "(build with bounds_fn=partition_bounds)"
        A_own = bl.A
        conv = lambda M, r0_, pd, ps, **kw: csr_rows_to_dist(
            M, r0_, pd, ps, comm, ranks, dtype=bdtype, device=device, **kw)
        dev_A = conv(A_own, bl.r0, part, part,
                     prefer_dia=params.prefer_dia,
                     dia_max_bands=params.dia_max_bands,
                     dense_size=params.dense_size)
        d_own = block_diag(A_own, bl.r0)
        absrow_own = abs_row_sum(A_own)
        l1d = d_own + (absrow_own - np.abs(d_own))
        vec = lambda v: _upload(np.pad(v, (0, part.n_loc - v.shape[0])),
                                device, dtype)
        lam = lambda_max_blocked(A_own, bl.r0, bl.n, d_own, absrow_own,
                                 comm, params.lambda_max)

        cpart = parts[li + 1]
        nc = bl.P.shape[1]
        pr_dense = params.dense_size \
            if max(bl.n, nc) <= params.dense_size else 0
        c0 = min(comm.rank * cpart.n_loc, nc)
        if li + 1 >= n_blk:
            # replication boundary into the gathered tail
            R = GatherOut(op=conv(bl.R, c0, cpart, part, prefer_dia=False,
                                  dense_size=pr_dense))
            Pp = ReplSrc(op=conv(bl.P, bl.r0, part, cpart, prefer_dia=False,
                                 dense_size=pr_dense, max_halo_frac=-1.0))
        else:
            Pp = conv(bl.P, bl.r0, part, cpart, prefer_dia=False,
                      dense_size=pr_dense)
            R = conv(bl.R, c0, cpart, part, prefer_dia=False,
                     dense_size=pr_dense)

        L = U = None
        if params.smoother == "gs2":
            tri = lambda up: conv(block_tri(A_own, bl.r0, up), bl.r0,
                                  part, part, prefer_dia=params.prefer_dia,
                                  dia_max_bands=params.dia_max_bands,
                                  dense_size=params.dense_size)
            L = tri(False)
            U = tri(True)

        levels.append(DistLevel(
            A=dev_A, dinv=vec(np.where(d_own != 0, 1.0 / d_own, 0.0)),
            l1_dinv=vec(np.where(l1d != 0, 1.0 / l1d, 0.0)),
            lam_max=_f32(lam), P=Pp, R=R, coarse_inv=None, ranks=ranks,
            L=L, U=U, n=bl.n, coarse_sweeps=params.coarse_smooth_sweeps))

    n_tail = len(tail.levels)
    for ti, lev in enumerate(tail.levels):
        li = n_blk + ti
        is_coarsest = ti == n_tail - 1 or lev.P is None
        levels.append(_replicated_level(
            lev, parts[li], parts[li + 1] if not is_coarsest else None,
            params, dtype, bdtype, is_coarsest, device=device))
    return DistHierarchy(levels=tuple(levels), parts=tuple(parts),
                         ranks=ranks)


def fine_fp64_blocked(A_own: sp.csr_matrix, r0: int, part: Partition,
                      comm: BlockComm, params: AMGParams, ranks: RankGroup,
                      *, device):
    """Process-local twin of ``fine_fp64``: the fp64 values (hi + lo of
    the df64 split) of the owned fine rows, and their fp32 cast."""
    A = A_own.copy()
    A.data = _hi_lo(A_own.data)
    A64 = csr_rows_to_dist(A, r0, part, part, comm, ranks,
                           dtype=torch.float64, prefer_dia=params.prefer_dia,
                           dia_max_bands=params.dia_max_bands, device=device)
    return fp64_operator(A64)


def slice_to_blocked(hier, rank: int, nd: int, n_procs: int,
                     params: AMGParams | None = None) -> BlockedHierarchy:
    """Slice a GLOBAL Hierarchy into one rank's BlockedHierarchy view
    (partition-aligned row blocks; levels above params.replicate_size
    blocked, the rest the replicated tail): the test bridge,
    ``blocked_to_dist(slice_to_blocked(H, r, ...))`` must equal
    ``to_dist(H, r, ...)`` value for value."""
    from ..setup.blocked import BlockedLevel, partition_bounds
    from ..setup.hierarchy import Hierarchy
    params = params or hier.params
    levels = []
    li = 0
    align = params.row_align
    while (li < hier.n_levels - 1 and hier.levels[li].P is not None
           and hier.levels[li].n > params.replicate_size):
        lev = hier.levels[li]
        n = lev.n
        bounds = partition_bounds(n, nd, n_procs, align=align)
        r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
        nc = lev.P.shape[1]
        bounds_c = partition_bounds(nc, nd, n_procs, align=align)
        c0, c1 = int(bounds_c[rank]), int(bounds_c[rank + 1])
        levels.append(BlockedLevel(
            A=lev.A[r0:r1].tocsr(), r0=r0, r1=r1, n=n, bounds=bounds,
            P=lev.P[r0:r1].tocsr(), R=lev.R[c0:c1].tocsr(),
            cf=lev.cf[r0:r1] if lev.cf is not None else None))
        li += 1
    tail = Hierarchy(levels=hier.levels[li:], params=params)
    return BlockedHierarchy(levels=levels, tail=tail, params=params)
