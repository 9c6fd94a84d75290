"""Process-local (per-host) AMG setup over row blocks (SURVEY.md §3.2:
the reference coarsens under MPI with boundary exchanges; VERDICT r3
next #1/#2/#7).

Every rank owns a contiguous row block of each level and builds strength,
PMIS, interpolation, R = P^T and the Galerkin RAP for its rows only,
exchanging nothing but BOUNDARY data through a :class:`~..setup.comm.
BlockComm` (ghost rows, halo C/F states, prefix counts) — no rank ever
materializes the global matrix or hierarchy.  The exchanges, in pod
order:

  1. ST-degrees: additive routing of per-rank strength-column counts to
     their owners (PMIS weights w_i = deg_i + hash01(i) are then local).
  2. incoming strength edges: outgoing boundary edges (j -> i, i remote)
     routed to i's owner — every rank holds ST rows for its owned points.
  3. per-PMIS-round: C/F states of halo points, twice per round (after
     selection, after F-marking) — distributed PMIS exactly as in
     De Sterck/Yang/Heys 2006 (hypre's pattern).
  4. pre-interpolation: ghost A rows at distance 1 plus (cf, coarse id)
     at distance 2, and the exclusive prefix scan of per-rank C counts
     that globalizes coarse numbering.
  5. per-multipass-round (aggressive "pmis2" scheme): pass numbers + P
     rows of halo points — Stuben multipass with the SAME native row
     kernels (`multipass_step`) the global path runs, so rows are
     bit-identical.
  6. transpose: P entries routed to their coarse-row owners (R rows
     assemble in ascending fine order, matching `csr_transpose`).
  7. RAP: local W = A P and P^T W contributions routed to coarse-row
     owners and summed in rank order; the ML-style drop/lump filter runs
     row-local with fetched column diagonals.

Bit-identity: (cf, P) per level are bit-identical to the global setup —
PMIS weights are pure functions of global index + exchanged degrees, and
every interpolation row is computed by the same native kernel on the
same (ghost-extended, order-preserving) inputs.  The RAP sums
contributions in a different (rank) order than the fused global kernel,
so coarse operators agree to rounding; iteration counts match within the
±1 the VERDICT allows, asserted in tests/test_blocked.py.

Run under :func:`~.comm.run_blocked` (threads; tests) or with a
:class:`~.comm.GlooComm` from real `torch.distributed` processes
(parallel/multihost.py).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import scipy.sparse as sp

from ..params import AMGParams
from .comm import BlockComm
from .strength import classical_strength
from .splitting import _hash01, FPT, CPT
from .interp import (extpi_interpolation, direct_interpolation,
                     truncate_rows)
from .galerkin import spgemm
from .._native import get_lib, csr_arrays

UNASSIGNED = -1
_I64 = np.int64
# fused-RAP size gate (blocked_rap): below this the two-pass SpGEMM's
# simplicity wins; module-level so tests can force the fused branch at
# toy sizes
_FUSED_MIN_NNZ = 1 << 16


# ---------------------------------------------------------------------------
# Bounds / ownership
# ---------------------------------------------------------------------------

def block_bounds(n: int, n_blocks: int) -> np.ndarray:
    """Balanced contiguous row-block boundaries (n_blocks+1,)."""
    base, rem = divmod(n, n_blocks)
    sizes = np.full(n_blocks, base, dtype=_I64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def partition_bounds(n: int, nd: int, n_procs: int,
                     align: int = 0) -> np.ndarray:
    """Device-ALIGNED bounds: rank b owns the rows of its nd/n_procs
    device shards under ``parallel.partition.Partition.make(n, nd)`` —
    the blocked hierarchy then freezes into per-shard device arrays with
    no re-partitioning exchange.  ``align`` overrides the shard pad
    multiple (params.row_align: node alignment for systems problems)."""
    from ..parallel.partition import Partition
    part = Partition.make(n, nd, pad_multiple=align or 128)
    dpp = nd // n_procs
    cuts = np.minimum(np.arange(n_procs + 1, dtype=_I64) * dpp * part.n_loc,
                      n)
    return cuts


def owner_of(idx: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    return np.searchsorted(bounds, np.asarray(idx, dtype=_I64),
                           side="right") - 1


# ---------------------------------------------------------------------------
# Fetch primitives (request/reply routing over comm.alltoall)
# ---------------------------------------------------------------------------

def _stable_order(keys: np.ndarray, nkeys: int) -> np.ndarray:
    """Stable ascending order of small-domain integer keys — native
    counting sort (np.argsort(kind="stable") was ~1 s per 5.3M keys per
    rank in the exchange preambles; the domains are tiny: rank owners,
    coarse-local rows)."""
    k = np.ascontiguousarray(keys, dtype=_I64)
    lib = get_lib()
    if lib is None or k.size < (1 << 14):
        return np.argsort(k, kind="stable")
    order = np.empty(k.size, dtype=_I64)
    lib.stable_counting_order(k.size, k, int(nkeys), order)
    return order


def _split_by_owner(want: np.ndarray, bounds: np.ndarray, size: int):
    """want must be sorted; returns per-destination slices (views)."""
    own = owner_of(want, bounds)
    cuts = np.searchsorted(own, np.arange(size + 1))
    return [want[cuts[d]:cuts[d + 1]] for d in range(size)]


class GhostFetcher:
    """Repeated halo-value fetches for a FIXED ghost set.

    The request routing (which of my rows each peer wants) is exchanged
    ONCE; every subsequent refresh is a single alltoall of reply
    payloads.  The blocked PMIS/multipass round loops are latency-bound
    on real process boundaries (±5 collectives per round before this),
    so halving the collective count is worth more than any numpy micro-
    optimization in those loops."""

    def __init__(self, comm: BlockComm, bounds: np.ndarray, r0: int,
                 want: np.ndarray):
        self.comm = comm
        self.want = want
        reqs = _split_by_owner(want, bounds, comm.size)
        got = comm.alltoall(reqs)
        self._locs = [np.asarray(g, dtype=_I64) - r0 for g in got]

    def fetch(self, arrays: dict, reduce_scalar=None):
        """One alltoall of reply payloads.  ``reduce_scalar`` piggybacks
        an allreduce-sum on the same message (the PMIS round loop's
        frontier count — one collective per round instead of two)."""
        replies = [{k: np.asarray(a)[loc] for k, a in arrays.items()}
                   for loc in self._locs]
        if reduce_scalar is not None:
            for r in replies:
                r["__red"] = reduce_scalar
        resp = self.comm.alltoall(replies)
        out = {k: (np.concatenate([r[k] for r in resp])
                   if self.want.size
                   else np.empty((0,) + np.asarray(arrays[k]).shape[1:],
                                 np.asarray(arrays[k]).dtype))
               for k in arrays}
        if reduce_scalar is not None:
            return out, sum(r["__red"] for r in resp)
        return out


def fetch_values(comm: BlockComm, bounds: np.ndarray, r0: int,
                 arrays: dict, want: np.ndarray) -> dict:
    """Values of rank-owned arrays at the (sorted) global indices
    ``want`` — the generic halo-data fetch (2 alltoalls)."""
    reqs = _split_by_owner(want, bounds, comm.size)
    got = comm.alltoall(reqs)
    replies = []
    for g in got:
        loc = np.asarray(g, dtype=_I64) - r0
        replies.append({k: np.asarray(a)[loc] for k, a in arrays.items()})
    resp = comm.alltoall(replies)
    return {k: (np.concatenate([r[k] for r in resp])
                if want.size else np.empty(0, arrays[k].dtype))
            for k in arrays}


def fetch_rows(comm: BlockComm, bounds: np.ndarray, r0: int,
               M_own: sp.csr_matrix, want: np.ndarray,
               with_data: bool = True) -> sp.csr_matrix:
    """CSR rows of a rank-owned row-block matrix at the (sorted) global
    indices ``want`` (ghost-row exchange; native sub-row gather on the
    reply side — no Python row loops, VERDICT r3 weak #4)."""
    reqs = _split_by_owner(want, bounds, comm.size)
    got = comm.alltoall(reqs)
    replies = []
    for g in got:
        loc = np.asarray(g, dtype=_I64) - r0
        replies.append(_take_rows(M_own, loc, with_data))
    resp = comm.alltoall(replies)
    indptrs = [r[0] for r in resp]
    counts = (np.concatenate([np.diff(ip) for ip in indptrs])
              if want.size else np.empty(0, _I64))
    indptr = np.zeros(want.size + 1, dtype=_I64)
    np.cumsum(counts, out=indptr[1:])
    indices = (np.concatenate([r[1] for r in resp])
               if want.size else np.empty(0, np.int32))
    shape = (int(want.size), M_own.shape[1])
    if not with_data:
        return _pattern_csr(indptr, indices, shape)
    data = (np.concatenate([r[2] for r in resp])
            if want.size else np.empty(0, np.float64))
    out = sp.csr_matrix(shape)
    out.data, out.indices, out.indptr = data, indices, indptr
    return out


def _take_rows(M: sp.csr_matrix, rows: np.ndarray, with_data: bool):
    """(indptr, indices[, data]) of the selected local rows — native
    gather_subrows when available (one parallel pass, no per-row Python;
    pattern-only variant for strength CSRs whose .data is a broadcast
    view)."""
    rows = np.asarray(rows, dtype=_I64)
    lo = M.indptr[rows].astype(_I64)
    counts = (M.indptr[rows + 1] - M.indptr[rows]).astype(_I64)
    indptr = np.zeros(len(rows) + 1, dtype=_I64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    idx = np.empty(nnz, dtype=np.int32)
    dat = np.empty(nnz, dtype=np.float64) if with_data else None
    lib = get_lib()
    if lib is not None and nnz:
        Mi = np.ascontiguousarray(M.indices, dtype=np.int32)
        dst = np.ascontiguousarray(indptr[:-1])
        if with_data:
            Md = np.ascontiguousarray(M.data, dtype=np.float64)
            lib.gather_subrows(len(rows), lo, dst, counts, Mi, Md,
                               idx, dat)
        else:
            lib.gather_subrows_pattern(len(rows), lo, dst, counts, Mi,
                                       idx)
    else:
        o = 0
        for a, c in zip(lo, counts):
            idx[o:o + c] = M.indices[a:a + c]
            if with_data:
                dat[o:o + c] = M.data[a:a + c]
            o += int(c)
    if with_data:
        return indptr, idx, dat
    return indptr, idx


def _scatter_rows(B: sp.csr_matrix, dst_off: np.ndarray,
                  out_idx: np.ndarray,
                  out_dat: np.ndarray | None = None) -> None:
    """Copy each row of B into out arrays at ``dst_off[i]`` — the native
    row-copy (gather_subrows) replacing the repeat/arange/fancy-scatter
    numpy triple pass of the local-CSR assemblies."""
    if B.nnz == 0:
        return
    ln = np.ascontiguousarray(np.diff(B.indptr), dtype=_I64)
    lo = np.ascontiguousarray(B.indptr[:-1], dtype=_I64)
    dst = np.ascontiguousarray(dst_off, dtype=_I64)
    lib = get_lib()
    if lib is not None and B.nnz >= (1 << 14):
        Mi = np.ascontiguousarray(B.indices, dtype=np.int32)
        if out_dat is not None:
            Md = np.ascontiguousarray(B.data, dtype=np.float64)
            lib.gather_subrows(B.shape[0], lo, dst, ln, Mi, Md,
                               out_idx, out_dat)
        else:
            lib.gather_subrows_pattern(B.shape[0], lo, dst, ln, Mi,
                                       out_idx)
        return
    pos = np.repeat(dst, ln) + (np.arange(B.nnz, dtype=_I64)
                                - np.repeat(lo, ln))
    out_idx[pos] = B.indices
    if out_dat is not None:
        out_dat[pos] = B.data


def _pattern_csr(indptr, indices, shape) -> sp.csr_matrix:
    """Pattern-only CSR with broadcast-ones data (4 bytes, not nnz*4)."""
    out = sp.csr_matrix(shape)
    out.data = np.broadcast_to(np.float32(1.0), (int(indptr[-1]),))
    out.indices, out.indptr = indices, indptr
    return out


def _ghosts_of(cols: np.ndarray, r0: int, r1: int) -> np.ndarray:
    """Sorted unique global column ids outside the owned range.

    Filter BEFORE the unique: the remote entries are the halo few
    percent, and np.unique on the full 12M-entry column array was a
    full sort per call x ~6 calls per setup level (round-5 profile:
    2.1 s of the 14.3 s rank wall at 192^3/4)."""
    if np.size(cols) == 0:
        return np.empty(0, dtype=_I64)
    cols = np.asarray(cols, dtype=_I64)
    rem = cols[(cols < r0) | (cols >= r1)]
    return np.unique(rem)


def _local_pos(idx: np.ndarray, r0: int, r1: int,
               ghosts: np.ndarray) -> np.ndarray:
    """Positions in the local node space [ghosts<r0 | owned | ghosts>=r1]
    — i.e. the SORTED array nodes = union(owned, ghosts).  Owned rows
    stay contiguous, and local order preserves global order (the native
    row kernels then scan columns in the same order as the global path,
    keeping interpolation rows bit-identical)."""
    idx = np.ascontiguousarray(idx, dtype=_I64)
    n_left = int(np.searchsorted(ghosts, r0))
    lib = get_lib()
    if lib is not None and idx.size >= (1 << 14):
        out = np.empty(idx.shape, dtype=_I64)
        g = np.ascontiguousarray(ghosts, dtype=_I64)
        lib.ext_col_map_local(idx.size, idx.reshape(-1), int(r0), int(r1),
                              g, g.size, n_left, out.reshape(-1))
        return out
    out = np.empty(idx.shape, dtype=_I64)
    left = idx < r0
    right = idx >= r1
    mid = ~(left | right)
    out[mid] = n_left + (idx[mid] - r0)
    out[left] = np.searchsorted(ghosts, idx[left])
    out[right] = n_left + (r1 - r0) + (
        np.searchsorted(ghosts, idx[right]) - n_left)
    return out


def _local_nodes(r0: int, r1: int, ghosts: np.ndarray):
    """(nodes, own_start): sorted global node ids of the local space and
    the local position of owned row 0."""
    n_left = int(np.searchsorted(ghosts, r0))
    nodes = np.concatenate([ghosts[:n_left],
                            np.arange(r0, r1, dtype=_I64),
                            ghosts[n_left:]])
    return nodes, n_left


# ---------------------------------------------------------------------------
# Distributed PMIS (generic over the index space: fine level or C-graph)
# ---------------------------------------------------------------------------

def blocked_pmis_comm(S_own: sp.csr_matrix, r0: int, r1: int,
                      bounds: np.ndarray, comm: BlockComm,
                      seed: int = 0, weight: str = "degree_hash",
                      symmetric: bool = False,
                      iso_cpt: bool = False) -> np.ndarray:
    """Distributed PMIS on owned strength rows (global columns),
    replicating the native `pmis_cf` semantics exactly: w = |ST_i| +
    hash01(i, seed); per round an unassigned i becomes C when no
    unassigned j != i in S(i) ∪ ST(i) has w_j >= w_i, then unassigned
    points strongly depending on a C become F.  Returns cf for the owned
    rows.

    ``weight="lexid"`` runs the same rounds with w = -(global id): the
    fixpoint is then the LEXICOGRAPHIC maximal independent set — exactly
    the root set of the sequential greedy Vanek pass (blocked SA,
    setup/blocked_sa.py).  ``symmetric=True`` skips the degree/transpose
    exchanges (ST == S for a symmetric graph).  ``iso_cpt`` makes
    isolated points C instead of F (a greedy pass-1 root with an empty
    neighborhood is a singleton aggregate)."""
    nloc = r1 - r0
    size = comm.size
    S_cols = np.asarray(S_own.indices, dtype=_I64)
    S_rows_g = r0 + np.repeat(np.arange(nloc, dtype=_I64),
                              np.diff(S_own.indptr))

    if symmetric:
        ST_own = S_own
        deg = np.diff(S_own.indptr).astype(_I64)
    else:
        # exchange 1: ST degrees (additive reduction routed to owners).
        # Owned columns contribute through a bincount; only the REMOTE
        # few percent go through unique+counts (the full-array
        # np.unique was a 12M-entry sort per level).  Integer addition
        # is exact, so deg is bit-identical to the old all-unique path.
        own_m = (S_cols >= r0) & (S_cols < r1)
        deg = (np.bincount(S_cols[own_m] - r0, minlength=nloc)
               .astype(_I64) if nloc else np.zeros(0, _I64))
        rem = S_cols[~own_m]
        uniq, cnt = (np.unique(rem, return_counts=True) if rem.size
                     else (np.empty(0, _I64), np.empty(0, _I64)))
        parts = _split_by_owner(uniq, bounds, size)
        send = []
        o = 0
        for d in range(size):
            k = parts[d].size
            if d == comm.rank:
                send.append((np.empty(0, _I64), np.empty(0, _I64)))
            else:
                send.append((parts[d], cnt[o:o + k]))
            o += k
        got = comm.alltoall(send)
        for gidx, gcnt in got:
            np.add.at(deg, np.asarray(gidx, dtype=_I64) - r0, gcnt)

        # exchange 2: incoming strength edges (ST rows for owned points)
        tgt_owner = owner_of(S_cols, bounds)
        order = _stable_order(tgt_owner, size)
        so_cols, so_src = S_cols[order], S_rows_g[order]
        cuts = np.searchsorted(tgt_owner[order], np.arange(size + 1))
        send = [(so_cols[cuts[d]:cuts[d + 1]], so_src[cuts[d]:cuts[d + 1]])
                for d in range(size)]
        got = comm.alltoall(send)
        in_t = (np.concatenate([g[0] for g in got]) if got
                else np.empty(0, _I64))
        in_s = (np.concatenate([g[1] for g in got]) if got
                else np.empty(0, _I64))
        n_cols = S_own.shape[1]
        lib0 = get_lib()
        if lib0 is not None and in_t.size >= (1 << 14) and nloc:
            # native COO->CSR with sorted rows (scipy's coo_tocsr +
            # sort_indices was ~0.7 s/rank at 5.3M entries)
            rows_l = np.asarray(in_t, dtype=_I64) - r0
            st_ip = np.zeros(nloc + 1, dtype=_I64)
            st_cols = np.empty(rows_l.size, dtype=np.int32)
            lib0.coo_to_csr_pattern(nloc, rows_l.size, rows_l,
                                    np.ascontiguousarray(in_s, dtype=_I64),
                                    st_ip, st_cols)
            ST_own = sp.csr_matrix(
                (np.ones(rows_l.size, dtype=np.int8), st_cols, st_ip),
                shape=(nloc, n_cols))
            ST_own.has_sorted_indices = True
            ST_own.has_canonical_format = True
        else:
            ST_own = sp.csr_matrix(
                (np.ones(in_t.size, dtype=np.int8),
                 (np.asarray(in_t, dtype=_I64) - r0, in_s)),
                shape=(max(nloc, 1), n_cols))[:nloc]
            ST_own.sort_indices()

    # ghost value space
    ST_cols = np.asarray(ST_own.indices, dtype=_I64)
    ghosts = _ghosts_of(np.concatenate([S_cols, ST_cols]), r0, r1)
    fetcher = GhostFetcher(comm, bounds, r0, ghosts)
    if weight == "lexid":
        w_own = -np.arange(r0, r1, dtype=np.float64)
        w_g = -ghosts.astype(np.float64)
    else:
        deg_g = fetcher.fetch({"deg": deg})["deg"]
        w_own = deg.astype(np.float64) + _hash01(
            np.arange(r0, r1, dtype=np.uint64), seed)
        w_g = deg_g.astype(np.float64) + _hash01(
            ghosts.astype(np.uint64), seed)
    w_ext = np.concatenate([w_own, w_g])

    # extended-index maps for the nnz of S_own and ST_own
    ghosts_c = np.ascontiguousarray(ghosts, dtype=_I64)

    def ecol(cols):
        lib0 = get_lib()
        if lib0 is not None and cols.size >= (1 << 14):
            out = np.empty(cols.shape, dtype=np.int32)
            lib0.ext_col_map_ecol(cols.size,
                                  np.ascontiguousarray(cols, _I64),
                                  r0, r1, ghosts_c, ghosts_c.size, out)
            return out
        out = np.empty(cols.shape, dtype=_I64)
        own = (cols >= r0) & (cols < r1)
        out[own] = cols[own] - r0
        out[~own] = nloc + np.searchsorted(ghosts, cols[~own])
        return out

    s_e = ecol(S_cols)
    st_e = ecol(ST_cols)
    s_rows = np.repeat(np.arange(nloc, dtype=_I64), np.diff(S_own.indptr))
    st_rows = np.repeat(np.arange(nloc, dtype=_I64), np.diff(ST_own.indptr))
    s_self = S_cols == (s_rows + r0)
    st_self = ST_cols == (st_rows + r0)

    ne = nloc + ghosts.size
    cf_ext = np.full(ne, UNASSIGNED, dtype=np.int8)
    cf_own = cf_ext[:nloc]                 # view: round kernels write here
    iso = (np.diff(S_own.indptr) == 0) & (np.diff(ST_own.indptr) == 0)
    cf_own[iso] = CPT if iso_cpt else FPT

    def refresh_ghost_cf(count=None):
        """Refresh ghost C/F states; optionally piggyback the global
        frontier count on the same alltoall (one collective per round
        instead of two)."""
        if count is None:
            cf_ext[nloc:] = fetcher.fetch({"cf": cf_own})["cf"]
            return None
        got, tot = fetcher.fetch({"cf": cf_own}, reduce_scalar=count)
        cf_ext[nloc:] = got["cf"]
        return int(tot)

    # frontier-based rounds with native select/F-assign bodies (the
    # numpy maximum.at/logical_or.at full-nnz passes were 30 of 54
    # rank-seconds at 96^3/8; the native kernels visit only still-
    # unassigned owned rows, exactly like pmis_cf's frontier loop, so
    # the split stays bit-identical to the global native PMIS)
    lib = get_lib()
    S_ip = np.ascontiguousarray(S_own.indptr, dtype=_I64)
    ST_ip = np.ascontiguousarray(ST_own.indptr, dtype=_I64)
    s_e32 = np.ascontiguousarray(s_e, dtype=np.int32)
    st_e32 = np.ascontiguousarray(st_e, dtype=np.int32)
    frontier = np.flatnonzero(cf_own == UNASSIGNED).astype(np.int32)
    prev_un = refresh_ghost_cf(count=int(frontier.size))
    while prev_un > 0:
        if lib is not None and frontier.size:
            newc = np.empty(frontier.size, dtype=np.uint8)
            lib.pmis_round_select(frontier.size, frontier, S_ip, s_e32,
                                  ST_ip, st_e32, w_ext, cf_ext, newc)
            cf_own[frontier[newc.view(bool)]] = CPT
        elif frontier.size:
            un_ext = cf_ext == UNASSIGNED
            m = np.full(nloc, -np.inf)
            for rows_nnz, e, self_m in ((s_rows, s_e, s_self),
                                        (st_rows, st_e, st_self)):
                if e.size == 0:
                    continue
                wj = np.where(un_ext[e] & ~self_m, w_ext[e], -np.inf)
                np.maximum.at(m, rows_nnz, wj)
            cf_own[(cf_own == UNASSIGNED) & (w_own > m)] = CPT
        refresh_ghost_cf()                         # exchange 3a
        if lib is not None and frontier.size:
            lib.pmis_round_fassign(frontier.size, frontier, S_ip, s_e32,
                                   cf_ext)
        elif frontier.size:
            un_loc = cf_own == UNASSIGNED
            if s_e.size:
                hit = np.zeros(nloc, dtype=bool)
                np.logical_or.at(hit, s_rows, cf_ext[s_e] == CPT)
                cf_own[un_loc & hit] = FPT
        # exchange 3b: ghost refresh + piggybacked frontier count (the
        # post-F-assign frontier is a pure local filter, so the count is
        # known before the exchange)
        frontier = frontier[cf_own[frontier] == UNASSIGNED]
        now_un = refresh_ghost_cf(count=int(frontier.size))
        if now_un == prev_un:
            break                                  # stall guard (native)
        prev_un = now_un
    cf_own[cf_own == UNASSIGNED] = CPT
    return cf_own.copy()


def _coarse_numbering(cf_own: np.ndarray, comm: BlockComm):
    """Exclusive prefix scan of per-rank C counts -> (c0, n_c, gmap_own)
    where gmap_own[i] is the GLOBAL coarse id of owned C point i (-1 at
    F points)."""
    nc_own = int((cf_own == CPT).sum())
    counts = comm.allgather(nc_own)
    c0 = int(sum(counts[: comm.rank]))
    n_c = int(sum(counts))
    gmap = np.where(cf_own == CPT,
                    c0 + np.cumsum(cf_own == CPT, dtype=_I64) - 1,
                    -1)
    return c0, n_c, gmap


# ---------------------------------------------------------------------------
# Blocked interpolation builders
# ---------------------------------------------------------------------------

def _extpi_block(A_own, r0, r1, bounds, comm, cf_own, gmap_own, n_c,
                 params) -> sp.csr_matrix:
    """ext+i / direct interpolation rows for the owned block: fetch ghost
    A rows at distance 1 and (cf, gmap) at distance 2, run the SAME
    native kernel on the ghost-extended local square matrix, keep owned
    rows with global coarse columns."""
    nloc = r1 - r0
    A_cols = np.asarray(A_own.indices, dtype=_I64)
    g1 = _ghosts_of(A_cols, r0, r1)
    A_g1 = fetch_rows(comm, bounds, r0, A_own, g1)          # ghost A rows
    g2 = _ghosts_of(np.asarray(A_g1.indices, dtype=_I64), r0, r1)
    ghosts = np.union1d(g1, g2)
    info = fetch_values(comm, bounds, r0,
                        {"cf": cf_own, "gmap": gmap_own}, ghosts)
    nodes, own0 = _local_nodes(r0, r1, ghosts)
    ne = nodes.size
    # local square CSR: rows for owned + distance-1 ghosts (ext+i never
    # reads beyond distance-1 rows), columns remapped to local space
    fill_rows = _local_pos(np.concatenate([np.arange(r0, r1, dtype=_I64),
                                           g1]), r0, r1, ghosts)
    blocks = [A_own, A_g1]
    counts = np.zeros(ne, dtype=_I64)
    counts[fill_rows] = np.concatenate([np.diff(A_own.indptr),
                                        np.diff(A_g1.indptr)])
    indptr = np.zeros(ne + 1, dtype=_I64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    lidx = np.empty(nnz, dtype=np.int32)
    ldat = np.empty(nnz, dtype=np.float64)
    off = indptr[fill_rows].copy()
    for B in blocks:
        ln = np.diff(B.indptr)
        k = len(ln)
        dst = off[:k] if B is A_own else off[nloc:]
        # row-major scatter of each block's rows into the local CSR
        pos = np.repeat(dst, ln) + (np.arange(B.nnz, dtype=_I64)
                                    - np.repeat(B.indptr[:-1].astype(_I64),
                                                ln))
        lidx[pos] = _local_pos(np.asarray(B.indices, dtype=_I64),
                               r0, r1, ghosts).astype(np.int32)
        ldat[pos] = B.data
    A_loc = sp.csr_matrix((ldat, lidx, indptr), shape=(ne, ne))
    A_loc.has_sorted_indices = True     # order-preserving remap
    strong_loc, _ = classical_strength(A_loc, params.theta)
    cf_loc = np.empty(ne, dtype=np.int8)
    gmap_loc = np.empty(ne, dtype=_I64)
    own_sl = slice(own0, own0 + nloc)
    cf_loc[own_sl] = cf_own
    gmap_loc[own_sl] = gmap_own
    gpos = _local_pos(ghosts, r0, r1, ghosts)
    cf_loc[gpos] = info["cf"]
    gmap_loc[gpos] = info["gmap"]
    if params.interpolation == "extpi":
        P_loc = extpi_interpolation(A_loc, strong_loc, cf_loc)
    else:
        P_loc = direct_interpolation(A_loc, strong_loc, cf_loc)
    P_own = P_loc[own_sl]
    # local coarse k -> k-th local C node -> global coarse id
    col_map = gmap_loc[cf_loc == CPT]
    P_own = sp.csr_matrix(
        (P_own.data, col_map[P_own.indices].astype(np.int32),
         P_own.indptr), shape=(nloc, n_c))
    return truncate_rows(P_own, params.interp_max)


def _multipass_block(A_own, strong_own, r0, r1, bounds, comm, cf_own,
                     gmap_own, n_c, cap, smooth_omega) -> sp.csr_matrix:
    """Stuben multipass + optional fused Jacobi repair over the owned
    block, with per-pass halo exchanges of (pass, P rows) — the same
    native row kernels as the global `multipass_interp`, hence
    bit-identical rows (exchange 5 in the module docstring)."""
    lib = get_lib()
    nloc = r1 - r0
    A_cols = np.asarray(A_own.indices, dtype=_I64)
    ghosts = _ghosts_of(A_cols, r0, r1)
    nodes, own0 = _local_nodes(r0, r1, ghosts)
    ne = nodes.size
    own_sl = slice(own0, own0 + nloc)
    gpos = _local_pos(ghosts, r0, r1, ghosts)
    info = fetch_values(comm, bounds, r0,
                        {"cf": cf_own, "gmap": gmap_own}, ghosts)
    # local square CSR with OWNED rows only (ghost P rows arrive via
    # exchanges, never computed here)
    counts = np.zeros(ne, dtype=_I64)
    counts[own_sl] = np.diff(A_own.indptr)
    indptr = np.zeros(ne + 1, dtype=_I64)
    np.cumsum(counts, out=indptr[1:])
    lidx = _local_pos(A_cols, r0, r1, ghosts).astype(np.int32)
    ldat = np.ascontiguousarray(A_own.data, dtype=np.float64)
    strong_loc = np.ascontiguousarray(strong_own, dtype=np.uint8)
    cf_loc = np.zeros(ne, dtype=np.int8)
    cf_loc[own_sl] = cf_own
    cf_loc[gpos] = info["cf"]
    cmap_loc = np.full(ne, -1, dtype=np.int32)
    cmap_loc[own_sl] = gmap_own.astype(np.int32)
    cmap_loc[gpos] = info["gmap"].astype(np.int32)

    pass_loc = np.where(cf_loc == CPT, 0, -1).astype(np.int32)
    P_cols = np.zeros((ne, cap), dtype=np.int32)
    P_vals = np.zeros((ne, cap), dtype=np.float64)
    P_len = np.zeros(ne, dtype=np.int32)
    isC = cf_loc == CPT
    P_cols[isC, 0] = cmap_loc[isC]
    P_vals[isC, 0] = 1.0
    P_len[isC] = 1

    frontier = (own0 + np.flatnonzero(cf_own != CPT)).astype(np.int32)
    pass_own_view = pass_loc[own_sl]

    fetcher = GhostFetcher(comm, bounds, r0 - own0, ghosts)
    # r0-own0 offset: the fetcher's reply gather indexes the EXTENDED
    # arrays, whose owned block sits at [own0, own0+nloc)

    def fetch_p_rows():
        """Refresh ghost (pass, P rows) after a pass (exchange 5)."""
        got = fetcher.fetch({"pass": pass_loc, "len": P_len,
                             "cols": P_cols, "vals": P_vals})
        if ghosts.size:
            pass_loc[gpos] = got["pass"]
            P_len[gpos] = got["len"]
            P_cols[gpos] = got["cols"]
            P_vals[gpos] = got["vals"]

    p = 1
    indptr_c = np.ascontiguousarray(indptr)
    while True:
        if frontier.size and lib is not None:
            ready = np.empty(frontier.size, dtype=np.uint8)
            lib.multipass_ready(frontier.size, frontier, indptr_c, lidx,
                                strong_loc, p, pass_loc, ready)
            ready = ready.view(bool)
        elif frontier.size:
            ready = np.array([
                any(strong_loc[k] and lidx[k] != i
                    and 0 <= pass_loc[lidx[k]] < p
                    for k in range(indptr_c[i], indptr_c[i + 1]))
                for i in frontier], dtype=bool)
        else:
            ready = np.empty(0, dtype=bool)
        cur = frontier[ready]
        if comm.allreduce_sum(int(cur.size)) == 0:
            break                          # global isolated remainder
        if cur.size:
            if lib is not None:
                lib.multipass_step(p, indptr_c, lidx, ldat, strong_loc,
                                   cf_loc, cmap_loc, cap, pass_loc,
                                   np.ascontiguousarray(cur), cur.size,
                                   P_cols.reshape(-1), P_vals.reshape(-1),
                                   P_len)
            else:
                _multipass_step_py(p, indptr_c, lidx, ldat, strong_loc,
                                   cf_loc, cmap_loc, cap, pass_loc, cur,
                                   P_cols, P_vals, P_len)
            pass_loc[cur] = p              # commit AFTER the rows
        frontier = frontier[~ready]
        fetch_p_rows()
        p += 1

    if smooth_omega:
        # ghost P rows are current (last fetch); fused Jacobi repair on
        # the same local layout
        if lib is not None:
            Q_cols = np.zeros_like(P_cols)
            Q_vals = np.zeros_like(P_vals)
            Q_len = np.zeros_like(P_len)
            lib.interp_jacobi_smooth(ne, indptr_c, lidx, ldat, strong_loc,
                                     float(smooth_omega), n_c, cap,
                                     P_cols.reshape(-1),
                                     P_vals.reshape(-1), P_len,
                                     Q_cols.reshape(-1),
                                     Q_vals.reshape(-1), Q_len)
            P_cols, P_vals, P_len = Q_cols, Q_vals, Q_len
        else:
            P_cols, P_vals, P_len = _jacobi_smooth_py(
                ne, indptr_c, lidx, ldat, strong_loc, float(smooth_omega),
                cap, P_cols, P_vals, P_len)

    # owned slots -> CSR with global coarse columns
    lens = P_len[own_sl].astype(_I64)
    P_indptr = np.zeros(nloc + 1, dtype=_I64)
    np.cumsum(lens, out=P_indptr[1:])
    nnz = int(P_indptr[-1])
    rowpos = np.repeat(np.arange(nloc, dtype=_I64), lens)
    slot = np.arange(nnz, dtype=_I64) - np.repeat(P_indptr[:-1], lens)
    P_indices = P_cols[own_sl][rowpos, slot].astype(np.int32)
    P_data = P_vals[own_sl][rowpos, slot]
    P = sp.csr_matrix((P_data, P_indices, P_indptr), shape=(nloc, n_c))
    P.sort_indices()                       # rows come out discovery-order
    return P


def _multipass_step_py(p, indptr, indices, data, strong, cf, cmap, cap,
                       pass_loc, cur, P_cols, P_vals, P_len):
    """Pure-python fallback mirroring the native multipass_step (no
    toolchain environments only; oracle-tested against it)."""
    for i in cur:
        i = int(i)
        sl = slice(indptr[i], indptr[i + 1])
        js, vs, st = indices[sl], data[sl], strong[sl]
        if p == 1:
            diag = sneg_all = spos_all = sneg_C = spos_C = 0.0
            for j, v, s in zip(js, vs, st):
                if j == i:
                    diag += v
                    continue
                if v < 0:
                    sneg_all += v
                else:
                    spos_all += v
                if s and cf[j] == CPT:
                    if v < 0:
                        sneg_C += v
                    else:
                        spos_C += v
            alpha = sneg_all / sneg_C if sneg_C else 0.0
            if spos_C:
                beta = spos_all / spos_C
            else:
                beta = 0.0
                diag += spos_all
            cols, vals = [], []
            if diag:
                for j, v, s in zip(js, vs, st):
                    if j == i or not s or cf[j] != CPT:
                        continue
                    w = (-alpha if v < 0 else -beta) * v / diag
                    if w:
                        cols.append(int(cmap[j]))
                        vals.append(w)
        else:
            denom = 0.0
            acc: dict = {}
            for j, v, s in zip(js, vs, st):
                if j == i:
                    denom += v
                    continue
                if s and 0 <= pass_loc[j] < p and P_len[j] > 0:
                    for t in range(P_len[j]):
                        c = int(P_cols[j, t])
                        acc[c] = acc.get(c, 0.0) + v * P_vals[j, t]
                else:
                    denom += v
            cols, vals = [], []
            if denom:
                for c, w in acc.items():
                    if w:
                        cols.append(c)
                        vals.append(-w / denom)
        _truncate_slots_py(cols, vals, cap, P_cols, P_vals, P_len, i)


def _truncate_slots_py(cols, vals, cap, P_cols, P_vals, P_len, i):
    if len(cols) > cap:
        order = sorted(range(len(cols)),
                       key=lambda s: (-abs(vals[s]), s))[:cap]
        pos_all = sum(v for v in vals if v > 0)
        neg_all = sum(v for v in vals if v < 0)
        pos_k = sum(vals[s] for s in order if vals[s] > 0)
        neg_k = sum(vals[s] for s in order if vals[s] < 0)
        s_pos = pos_all / pos_k if pos_k else 1.0
        s_neg = neg_all / neg_k if neg_k else 1.0
        order.sort()
        cols = [cols[s] for s in order]
        vals = [vals[s] * (s_pos if vals[s] > 0 else s_neg)
                for s in order]
    P_len[i] = len(cols)
    for s, (c, v) in enumerate(zip(cols, vals)):
        P_cols[i, s] = c
        P_vals[i, s] = v


def _jacobi_smooth_py(ne, indptr, indices, data, strong, omega, cap,
                      P_cols, P_vals, P_len):
    Q_cols = np.zeros_like(P_cols)
    Q_vals = np.zeros_like(P_vals)
    Q_len = np.zeros_like(P_len)
    for i in range(ne):
        acc: dict = {}
        D = 0.0
        for k in range(indptr[i], indptr[i + 1]):
            j, v = int(indices[k]), data[k]
            if j == i:
                D += v
                continue
            if strong[k]:
                for t in range(P_len[j]):
                    c = int(P_cols[j, t])
                    acc[c] = acc.get(c, 0.0) + v * P_vals[j, t]
            else:
                D += v
        s0 = -omega / D if D != 0.0 else 0.0
        for c in acc:
            acc[c] *= s0
        for t in range(P_len[i]):
            c = int(P_cols[i, t])
            w = (1.0 - omega) * P_vals[i, t]
            if w:
                acc[c] = acc.get(c, 0.0) + w
        cols = [c for c, w in acc.items() if w != 0.0]
        vals = [acc[c] for c in cols]
        _truncate_slots_py(cols, vals, cap, Q_cols, Q_vals, Q_len, i)
    return Q_cols, Q_vals, Q_len


# ---------------------------------------------------------------------------
# Aggressive (pmis2) blocked step: dist-2 C-C graph + second PMIS
# ---------------------------------------------------------------------------

def _dist2_block(S_own, r0, r1, bounds, comm, cf_own, gmap_own, n_c):
    """Owned rows of the distance-2 C-C strength graph (global C-index
    columns): fetch ghost S rows at distance 1 + (cf, gmap) at distance
    2, run the native dist2 kernel on the local extension, keep owned C
    rows."""
    nloc = r1 - r0
    S_cols = np.asarray(S_own.indices, dtype=_I64)
    g1 = _ghosts_of(S_cols, r0, r1)
    S_g1 = fetch_rows(comm, bounds, r0, S_own, g1, with_data=False)
    g2 = _ghosts_of(np.asarray(S_g1.indices, dtype=_I64), r0, r1)
    ghosts = np.union1d(g1, g2)
    info = fetch_values(comm, bounds, r0,
                        {"cf": cf_own, "gmap": gmap_own}, ghosts)
    nodes, own0 = _local_nodes(r0, r1, ghosts)
    ne = nodes.size
    own_sl = slice(own0, own0 + nloc)
    gpos = _local_pos(ghosts, r0, r1, ghosts)
    fill_rows = np.concatenate([
        np.arange(own0, own0 + nloc, dtype=_I64),
        _local_pos(g1, r0, r1, ghosts)])
    counts = np.zeros(ne, dtype=_I64)
    counts[fill_rows] = np.concatenate([np.diff(S_own.indptr),
                                        np.diff(S_g1.indptr)])
    indptr = np.zeros(ne + 1, dtype=_I64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    lidx = np.empty(nnz, dtype=np.int32)
    for B, rows_dst in ((S_own, fill_rows[:nloc]), (S_g1, fill_rows[nloc:])):
        if B.nnz == 0:
            continue
        ln = np.diff(B.indptr)
        pos = np.repeat(indptr[rows_dst], ln) + (
            np.arange(B.nnz, dtype=_I64)
            - np.repeat(B.indptr[:-1].astype(_I64), ln))
        lidx[pos] = _local_pos(np.asarray(B.indices, dtype=_I64),
                               r0, r1, ghosts).astype(np.int32)
    cf_loc = np.full(ne, FPT, dtype=np.int8)
    cf_loc[own_sl] = cf_own
    cf_loc[gpos] = info["cf"]
    cmap_loc = np.full(ne, -1, dtype=np.int32)
    cmap_loc[own_sl] = gmap_own.astype(np.int32)
    cmap_loc[gpos] = info["gmap"].astype(np.int32)
    n_c_loc = int((cf_loc == CPT).sum())
    # the native kernel indexes rows AND labels columns with cmap — feed
    # it the LOCAL C numbering (its count arrays are n_c_loc-sized), then
    # remap the output columns to global coarse ids
    cmap_l2l = (np.cumsum(cf_loc == CPT, dtype=_I64) - 1).astype(np.int32)
    c_global = cmap_loc[cf_loc == CPT]          # local C order -> global id
    lib = get_lib()
    if lib is not None:
        cf8 = np.ascontiguousarray(cf_loc)
        S2p = np.empty(n_c_loc + 1, dtype=_I64)
        nnz2 = int(lib.dist2_cc_symbolic(ne, indptr, lidx, cf8, cmap_l2l,
                                         n_c_loc, S2p))
        S2i = np.empty(nnz2, dtype=np.int32)
        lib.dist2_cc_fill(ne, indptr, lidx, cf8, cmap_l2l, S2p, S2i)
    else:
        S2p, S2i = _dist2_py(ne, indptr, lidx, cf_loc, cmap_l2l, n_c_loc)
    S2i = c_global[S2i].astype(np.int32)
    # owned C rows are contiguous in the local C ordering
    cpos = np.cumsum(cf_loc == CPT, dtype=_I64)
    lo_c = int(cpos[own0 - 1]) if own0 > 0 else 0
    hi_c = int(cpos[own0 + nloc - 1]) if nloc else lo_c
    sub_p = (S2p[lo_c:hi_c + 1] - S2p[lo_c]).astype(_I64)
    sub_i = np.ascontiguousarray(S2i[S2p[lo_c]:S2p[hi_c]])
    return _pattern_csr(sub_p, sub_i, (hi_c - lo_c, n_c))


def _dist2_py(ne, indptr, lidx, cf_loc, cmap_loc, n_c_loc):
    rows = []
    for i in range(ne):
        if cf_loc[i] != CPT:
            continue
        out = set()
        for k in range(indptr[i], indptr[i + 1]):
            j = int(lidx[k])
            if j == i:
                continue
            if cf_loc[j] == CPT:
                out.add(int(cmap_loc[j]))
            else:
                for k2 in range(indptr[j], indptr[j + 1]):
                    j2 = int(lidx[k2])
                    if j2 != i and cf_loc[j2] == CPT:
                        out.add(int(cmap_loc[j2]))
        out.discard(int(cmap_loc[i]))
        rows.append(sorted(out))
    indptr2 = np.zeros(len(rows) + 1, dtype=_I64)
    np.cumsum([len(r) for r in rows], out=indptr2[1:])
    idx = (np.concatenate([np.asarray(r, np.int32) for r in rows])
           if indptr2[-1] else np.empty(0, np.int32))
    return indptr2, idx


# ---------------------------------------------------------------------------
# Transpose and Galerkin product exchanges
# ---------------------------------------------------------------------------

def blocked_transpose(P_own: sp.csr_matrix, r0: int, n_fine: int,
                      bounds_c: np.ndarray, comm: BlockComm
                      ) -> sp.csr_matrix:
    """R = P^T rows for the coarse points this rank owns under
    ``bounds_c`` (exchange 6): every rank routes its P entries to the
    coarse-row owner; rows assemble in ascending fine order (sources are
    rank-ordered, entries CSR-ordered within each source), matching the
    global `csr_transpose` layout."""
    nloc, n_c = P_own.shape
    cols = np.asarray(P_own.indices, dtype=_I64)
    rows_g = r0 + np.repeat(np.arange(nloc, dtype=_I64),
                            np.diff(P_own.indptr))
    dest = owner_of(cols, bounds_c)
    order = _stable_order(dest, comm.size)
    cuts = np.searchsorted(dest[order], np.arange(comm.size + 1))
    send = [(cols[order[cuts[d]:cuts[d + 1]]],
             rows_g[order[cuts[d]:cuts[d + 1]]],
             P_own.data[order[cuts[d]:cuts[d + 1]]])
            for d in range(comm.size)]
    got = comm.alltoall(send)
    c0, c1 = int(bounds_c[comm.rank]), int(bounds_c[comm.rank + 1])
    nc_loc = c1 - c0
    rc = (np.concatenate([g[0] for g in got]) if got else
          np.empty(0, _I64)) - c0
    ri = np.concatenate([g[1] for g in got]) if got else np.empty(0, _I64)
    rv = np.concatenate([g[2] for g in got]) if got else np.empty(0)
    ordr = _stable_order(rc, nc_loc)
    counts = (np.bincount(rc, minlength=nc_loc) if rc.size else
              np.zeros(nc_loc, dtype=_I64))
    indptr = np.zeros(nc_loc + 1, dtype=_I64)
    np.cumsum(counts, out=indptr[1:])
    return sp.csr_matrix((rv[ordr], ri[ordr].astype(np.int32), indptr),
                         shape=(nc_loc, n_fine))


def blocked_rap(A_own, P_own, r0, r1, bounds, bounds_c, comm,
                drop_tol: float) -> sp.csr_matrix:
    """Owned coarse rows of R A P (exchange 7): local W = A_loc P_ext,
    per-rank contributions P_own^T W routed to coarse-row owners and
    summed in rank order, then the ML-style drop/lump filter with the
    diagonal-collapse guard, row-local with fetched column diagonals."""
    nloc = r1 - r0
    n_c = P_own.shape[1]
    A_cols = np.asarray(A_own.indices, dtype=_I64)
    g1 = _ghosts_of(A_cols, r0, r1)
    P_g1 = fetch_rows(comm, bounds, r0, P_own, g1)
    nodes, own0 = _local_nodes(r0, r1, g1)
    ne = nodes.size
    # P over the local node space
    counts = np.zeros(ne, dtype=_I64)
    counts[own0:own0 + nloc] = np.diff(P_own.indptr)
    counts[_local_pos(g1, r0, r1, g1)] = np.diff(P_g1.indptr)
    indptr = np.zeros(ne + 1, dtype=_I64)
    np.cumsum(counts, out=indptr[1:])
    pi = np.empty(int(indptr[-1]), dtype=np.int32)
    pv = np.empty(int(indptr[-1]), dtype=np.float64)
    for B, dst in ((P_own, np.arange(own0, own0 + nloc, dtype=_I64)),
                   (P_g1, _local_pos(g1, r0, r1, g1))):
        if B.shape[0] == 0:
            continue
        _scatter_rows(B, indptr[dst], pi, pv)
    P_ext = sp.csr_matrix((pv, pi, indptr), shape=(ne, n_c))
    P_ext.has_sorted_indices = True
    # A_loc: owned rows, columns remapped to the local node space
    lidx = _local_pos(A_cols, r0, r1, g1).astype(np.int32)
    A_loc = sp.csr_matrix(
        (np.ascontiguousarray(A_own.data, np.float64), lidx,
         np.ascontiguousarray(A_own.indptr, _I64)), shape=(nloc, ne))
    A_loc.has_sorted_indices = True
    lib = get_lib()
    PT = P_own.T.tocsr()                           # (n_c, nloc) — local nnz
    # Gate on GLOBAL quantities (one batched allreduce) so every rank —
    # and the global galerkin_product on the same problem (dup =
    # R.nnz/n_fine, size = A.nnz + P.nnz) — picks the same branch
    # deterministically (ADVICE r4: per-rank local gates let ranks
    # diverge in summation order near the thresholds).
    g = comm.allreduce_sum(np.array([A_own.nnz, P_own.nnz], dtype=_I64))
    n_fine = int(bounds[-1])
    dup = int(g[1]) / max(n_fine, 1)
    if (lib is not None and dup <= 8.0
            and int(g[0]) + int(g[1]) >= _FUSED_MIN_NNZ
            and not os.environ.get("SPARSH_NO_FUSED_RAP")):
        # fused local triple product PT A_loc P_ext — no W intermediate
        # (the same economics as the global galerkin_product: dup-gated,
        # same SPARSH_NO_FUSED_RAP kill switch).  The native staging
        # arena is thread_local, so every transport takes the SAME
        # branch (ThreadComm ranks are threads, PipeComm/GlooComm ranks
        # are processes) and thread-vs-process hierarchies stay
        # identical at every scale.
        R_ip, R_ix, R_d = csr_arrays(PT)
        Al_ip, Al_ix, Al_d = csr_arrays(A_loc)
        Pe_ip, Pe_ix, Pe_d = csr_arrays(P_ext)
        lib.rap_fused_compute(PT.shape[0], n_c, R_ip, R_ix, R_d,
                              Al_ip, Al_ix, Al_d, Pe_ip, Pe_ix, Pe_d)
        C_indptr = np.empty(PT.shape[0] + 1, dtype=_I64)
        nnz_c = lib.rap_fused_extract(0.0, C_indptr)
        C_ix = np.empty(nnz_c, dtype=np.int32)
        C_d = np.empty(nnz_c, dtype=np.float64)
        lib.rap_fused_emit(C_indptr, C_ix, C_d)
        C_part = sp.csr_matrix((C_d, C_ix, C_indptr),
                               shape=(PT.shape[0], n_c))
        C_part.has_sorted_indices = True
        C_part.has_canonical_format = True
    else:
        W = spgemm(A_loc, P_ext)                   # (nloc, n_c)
        C_part = spgemm(PT, W)                     # contributions
    # route contribution rows to coarse owners; nonzero rows only
    nz_rows = np.flatnonzero(np.diff(C_part.indptr))
    dest = owner_of(nz_rows, bounds_c)
    cuts = np.searchsorted(dest, np.arange(comm.size + 1))
    send = []
    for d in range(comm.size):
        rws = nz_rows[cuts[d]:cuts[d + 1]]
        send.append((rws, *_take_rows(C_part, rws, True)))
    got = comm.alltoall(send)
    c0, c1 = int(bounds_c[comm.rank]), int(bounds_c[comm.rank + 1])
    nc_loc = c1 - c0
    acc = None
    for rws, ip, ix, dt in got:                    # rank order: determinate
        if len(rws) == 0:
            continue
        full_ip = np.zeros(nc_loc + 1, dtype=_I64)
        cnt = np.zeros(nc_loc, dtype=_I64)
        cnt[np.asarray(rws, _I64) - c0] = np.diff(ip)
        np.cumsum(cnt, out=full_ip[1:])
        B = sp.csr_matrix((dt, ix, full_ip), shape=(nc_loc, n_c))
        B.has_sorted_indices = True
        if acc is None:
            acc = B
        else:
            from .galerkin import csr_add
            acc = csr_add(1.0, acc, 1.0, B)
    if acc is None:
        acc = sp.csr_matrix((nc_loc, n_c))
    acc.sum_duplicates()
    acc.eliminate_zeros()
    # gate COLLECTIVELY: _filter_block fetches ghost diagonals, so a rank
    # whose coarse block is empty (partition_bounds rounding can leave
    # trailing ranks with zero rows) must still enter the exchange — a
    # local acc.nnz gate desynchronizes the collective sequence
    if drop_tol > 0.0 and int(comm.allreduce_sum(int(acc.nnz))):
        acc = _filter_block(acc, c0, bounds_c, comm, drop_tol)
    return acc


def _filter_block(Ac, c0, bounds_c, comm, drop_tol):
    """Row-local ML filter + diagonal-collapse guard on an owned coarse
    block (mirrors galerkin_product's filter; column diagonals fetched
    from their owners)."""
    nc_loc = Ac.shape[0]
    rows = np.repeat(np.arange(nc_loc, dtype=_I64), np.diff(Ac.indptr))
    cols = np.asarray(Ac.indices, dtype=_I64)
    dmask = cols == (rows + c0)
    diag_own = np.zeros(nc_loc)
    diag_own[rows[dmask]] = Ac.data[dmask]
    ghosts = _ghosts_of(cols, c0, c0 + nc_loc)
    dg = fetch_values(comm, bounds_c, c0, {"d": diag_own}, ghosts)["d"]
    diag_col = np.empty(cols.shape)
    own = ~((cols < c0) | (cols >= c0 + nc_loc))
    diag_col[own] = np.abs(diag_own[cols[own] - c0])
    diag_col[~own] = np.abs(dg[np.searchsorted(ghosts, cols[~own])])
    cut = drop_tol * np.sqrt(np.abs(diag_own[rows]) * diag_col)
    keep = dmask | (np.abs(Ac.data) >= cut)
    lump = np.zeros(nc_loc)
    np.add.at(lump, rows[~keep], Ac.data[~keep])
    nd = diag_own + lump
    bad = np.where(diag_own > 0, nd < 0.1 * diag_own,
                   np.where(diag_own < 0, nd > 0.1 * diag_own, True))
    keep = keep | bad[rows]
    lump = np.where(bad, 0.0, lump)
    data = np.where(keep, Ac.data, 0.0)
    data = np.where(dmask, data + lump[rows], data)
    out = sp.csr_matrix((data, Ac.indices.copy(), Ac.indptr.copy()),
                        shape=Ac.shape)
    out.eliminate_zeros()
    return out


# ---------------------------------------------------------------------------
# Level step + full blocked hierarchy driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockedLevel:
    """One rank's slice of one distributed level (global column ids)."""
    A: sp.csr_matrix              # (nloc, n) owned rows
    r0: int
    r1: int
    n: int                        # global level size
    bounds: np.ndarray            # (size+1,) global bounds of this level
    P: sp.csr_matrix | None = None   # (nloc, n_c) owned fine rows
    R: sp.csr_matrix | None = None   # (nc_loc, n) owned coarse rows
    cf: np.ndarray | None = None


@dataclasses.dataclass
class BlockedHierarchy:
    """Per-rank distributed levels + the gathered (tiny) coarse tail."""
    levels: list                  # list[BlockedLevel]
    tail: object                  # setup.hierarchy.Hierarchy (global, small)
    params: AMGParams

    @property
    def n_levels(self) -> int:
        return len(self.levels) + self.tail.n_levels


def blocked_coarsen_step(A_own: sp.csr_matrix, r0: int, r1: int,
                         bounds: np.ndarray, comm: BlockComm,
                         params: AMGParams, aggressive: bool):
    """One blocked setup step: returns (P_own, cf_own, n_c, gmap_own) or
    None on a (globally agreed) stall."""
    assert params.coarsening in ("pmis", "hmis", "rs") or not aggressive
    n = int(bounds[-1])
    strong_own, S_own = classical_strength(A_own, params.theta,
                                           row_offset=r0)
    cf_own = blocked_pmis_comm(S_own, r0, r1, bounds, comm, seed=0)
    c0, n_c1, gmap_own = _coarse_numbering(cf_own, comm)
    if n_c1 == 0 or n_c1 >= n:
        return None
    if aggressive:
        assert params.aggressive == "pmis2", \
            "blocked aggressive setup implements the pmis2 scheme " \
            "(the composed scheme needs the intermediate RAP the pmis2 " \
            "path exists to avoid)"
        S2_own = _dist2_block(S_own, r0, r1, bounds, comm, cf_own,
                              gmap_own, n_c1)
        nc_own = S2_own.shape[0]
        counts = comm.allgather(nc_own)
        bounds_c1 = np.concatenate([[0], np.cumsum(counts)]).astype(_I64)
        cf2 = blocked_pmis_comm(S2_own, c0, c0 + nc_own, bounds_c1, comm,
                                seed=1)
        own_c = np.flatnonzero(cf_own == CPT)
        cf_own = cf_own.copy()
        cf_own[own_c[cf2 == FPT]] = FPT
        c0, n_c, gmap_own = _coarse_numbering(cf_own, comm)
        if n_c == 0 or n_c >= n:
            return None
        cap = params.interp_max_composed or params.interp_max or 5
        omega = params.jacobi_omega_smooth_P if params.multipass_smooth \
            else None
        P_own = _multipass_block(A_own, strong_own, r0, r1, bounds, comm,
                                 cf_own, gmap_own, n_c, cap, omega)
        return P_own, cf_own, n_c, gmap_own
    P_own = _extpi_block(A_own, r0, r1, bounds, comm, cf_own, gmap_own,
                         n_c1, params)
    return P_own, cf_own, n_c1, gmap_own


def blocked_amg_setup(A_own: sp.csr_matrix, bounds: np.ndarray,
                      comm: BlockComm, params: AMGParams,
                      blocked_threshold: int | None = None,
                      bounds_fn=None,
                      nullspace_own: np.ndarray | None = None
                      ) -> BlockedHierarchy:
    """Full per-rank AMG setup: blocked levels down to
    ``blocked_threshold`` (default: params.replicate_size — every level
    the distributed solver keeps row-sharded), then the small coarse
    remainder is allgathered and finished with the global `amg_setup`
    on every rank (identical, tiny — the reference's 'gather small
    coarse grids' strategy applied to setup).

    ``bounds_fn(n) -> bounds`` chooses each coarse level's ownership
    (default: balanced blocks; the device path passes partition_bounds
    so blocks align with device shards).

    ``coarsening="aggregation"`` runs the process-local smoothed-
    aggregation path (setup/blocked_sa.py; bit-identical aggregates to
    the serial greedy) with ``nullspace_own`` = this rank's rows of the
    near-nullspace basis (RBM-SA elasticity); row blocks must be
    node-aligned (params.row_align)."""
    is_sa = params.coarsening == "aggregation"
    assert params.coarsening == "pmis" or is_sa, \
        "blocked setup: PMIS (flagship) or aggregation (SA) coarsening"
    if blocked_threshold is None:
        blocked_threshold = max(params.replicate_size, params.coarse_size)
    if bounds_fn is None:
        bounds_fn = lambda n: block_bounds(n, comm.size)
    r0, r1 = int(bounds[comm.rank]), int(bounds[comm.rank + 1])
    levels = []
    A_own = A_own.tocsr()
    if A_own.dtype != np.float64:
        A_own = A_own.astype(np.float64)
    A_own.sum_duplicates()
    B_own = None
    if nullspace_own is not None:
        B_own = np.ascontiguousarray(nullspace_own, dtype=np.float64)
        if B_own.ndim == 1:
            B_own = B_own[:, None]
    lvl = 0
    while int(bounds[-1]) > blocked_threshold \
            and len(levels) < params.max_levels - 1:
        n = int(bounds[-1])
        if is_sa:
            from .blocked_sa import blocked_sa_step, route_coarse_nullspace
            bs = params.agg_blocksize if lvl == 0 else (
                B_own.shape[1] if B_own is not None else 1)
            out = blocked_sa_step(A_own, r0, r1, bounds, comm, params,
                                  B_own, bs)
            if out is None:
                break
            P_own, n_c, bparts = out
            cf_own = None
        else:
            aggressive = (lvl < params.agg_levels
                          and params.coarsening in ("rs", "pmis", "hmis")
                          and params.aggressive == "pmis2")
            out = blocked_coarsen_step(A_own, r0, r1, bounds, comm,
                                       params, aggressive)
            if out is None:
                break
            P_own, cf_own, n_c, gmap_own = out
            bparts = None
        if n_c >= 0.95 * n and levels:
            break                                   # stagnation guard
        bounds_c = np.asarray(bounds_fn(n_c), dtype=_I64)
        R_own = blocked_transpose(P_own, r0, n, bounds_c, comm)
        Ac_own = blocked_rap(A_own, P_own, r0, r1, bounds, bounds_c, comm,
                             params.rap_drop_tol)
        levels.append(BlockedLevel(A=A_own, r0=r0, r1=r1, n=n,
                                   bounds=bounds, P=P_own, R=R_own,
                                   cf=cf_own))
        if bparts is not None:
            from .blocked_sa import route_coarse_nullspace
            B_own = route_coarse_nullspace(bparts, bounds_c, comm,
                                           B_own.shape[1])
        elif is_sa:
            B_own = None
        A_own = Ac_own
        bounds = bounds_c
        r0, r1 = int(bounds[comm.rank]), int(bounds[comm.rank + 1])
        lvl += 1

    # gather the small remainder and finish globally (identical per rank)
    from .hierarchy import amg_setup
    blocks = comm.allgather((A_own.indptr, A_own.indices, A_own.data,
                             A_own.shape))
    n_tail = int(bounds[-1])
    indptr = np.zeros(n_tail + 1, dtype=_I64)
    off = 0
    idx_parts, dat_parts = [], []
    for b, (ip, ix, dt, shp) in enumerate(blocks):
        rows = shp[0]
        indptr[off + 1: off + rows + 1] = indptr[off] + ip[1:]
        idx_parts.append(ix)
        dat_parts.append(dt)
        off += rows
    A_tail = sp.csr_matrix(
        (np.concatenate(dat_parts) if dat_parts else np.empty(0),
         np.concatenate(idx_parts) if idx_parts else np.empty(0, np.int32),
         indptr), shape=(n_tail, n_tail))
    tail_params = params.replace(
        agg_levels=max(0, params.agg_levels - len(levels)))
    B_tail = None
    if is_sa and B_own is not None:
        B_tail = np.concatenate(comm.allgather(B_own), axis=0)
    if is_sa and levels:
        # the tail continues the hierarchy at coarse levels, where the
        # finest-level agg_blocksize no longer applies — coarse levels
        # are amalgamated by the nullspace dimension (amg_setup's own
        # bs-chain rule, entered here at level >= 1 semantics)
        tail_params = tail_params.replace(
            agg_blocksize=(B_tail.shape[1] if B_tail is not None else 1))
    tail = amg_setup(A_tail, tail_params, nullspace=B_tail)
    return BlockedHierarchy(levels=levels, tail=tail, params=params)


# ---------------------------------------------------------------------------
# Stitching (tests / single-host consumers) + compatibility wrappers
# ---------------------------------------------------------------------------

def _vstack_blocks(blocks: list) -> sp.csr_matrix:
    parts = [(b.indptr, b.indices, b.data, b.shape) for b in blocks]
    rows = sum(p[3][0] for p in parts)
    indptr = np.zeros(rows + 1, dtype=_I64)
    off = 0
    for ip, _, _, shp in parts:
        indptr[off + 1: off + shp[0] + 1] = indptr[off] + ip[1:]
        off += shp[0]
    return sp.csr_matrix(
        (np.concatenate([p[2] for p in parts]),
         np.concatenate([p[1] for p in parts]),
         indptr), shape=(rows, parts[0][3][1]))


def stitch_blocked(parts: list) -> "Hierarchy":
    """Assemble per-rank BlockedHierarchy objects into one global
    Hierarchy (tests; also the escape hatch for single-host consumers)."""
    from .hierarchy import Hierarchy, Level
    levels = []
    n_blk = len(parts[0].levels)
    for li in range(n_blk):
        blks = [p.levels[li] for p in parts]
        A = _vstack_blocks([b.A for b in blks])
        P = _vstack_blocks([b.P for b in blks])
        R = _vstack_blocks([b.R for b in blks])
        cf = (np.concatenate([b.cf for b in blks])
              if blks[0].cf is not None else None)   # SA levels: no C/F
        levels.append(Level(A=A, P=P, R=R, cf=cf))
    tail = parts[0].tail
    for i, lev in enumerate(tail.levels):
        levels.append(lev)
    return Hierarchy(levels=levels, params=parts[0].params)


def blocked_coarsen_once(A: sp.csr_matrix, params: AMGParams,
                         n_blocks: int):
    """One block-parallel setup step simulated on threads (tests): slice
    A into balanced row blocks, run the SPMD step, stitch (P, cf)."""
    from .comm import run_blocked
    A = A.tocsr()
    n = A.shape[0]
    bounds = block_bounds(n, n_blocks)

    def fn(rank, comm):
        r0, r1 = int(bounds[rank]), int(bounds[rank + 1])
        return blocked_coarsen_step(A[r0:r1], r0, r1, bounds, comm,
                                    params, aggressive=False)

    outs = run_blocked(fn, n_blocks)
    P = _vstack_blocks([o[0] for o in outs])
    cf = np.concatenate([o[1] for o in outs])
    return P, cf
