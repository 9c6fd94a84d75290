"""Distributed sparse operators and collectives over ``torch.distributed``
(the port of ``sparsh_amg_tpu/parallel/dist.py``).

One process per rank: rank r holds row block r of every distributed level
(``Partition``: blocks of ``n_loc`` rows, block == n_loc) on its own
device, and every operator here holds that block only.  The JAX package's
single controller drives a 1-D mesh through ``shard_map``; its
collectives map to

* ``ppermute`` of boundary slices -> ``RankGroup.halo`` (point-to-point
  ``batch_isend_irecv`` with the neighbour ranks; zeros at the ends of
  the domain);
* ``psum`` -> ``RankGroup.all_reduce``;
* ``all_gather(tiled=True)`` -> ``RankGroup.all_gather``
  (``all_gather_into_tensor``).

Transport follows the process group's backend: NCCL moves device tensors
directly; gloo (the CPU tests, and several ranks sharing one card) takes
host tensors, so a CUDA tensor is copied to a pinned host buffer and back
explicitly around each gloo collective.  The kernels still run on the card.

Every collective a RankGroup issues adds 1 to the tally
``dist.collectives`` and every halo the bytes this rank sends to
``dist.halo_bytes`` (``trace.Tally``: counted whether tracing is on or
off, and again at each replay of a graph that captured them).

Operators:

* ``DistDia``: every product (SpMV and the fused tails of
  ``ops/formats.py::FusedDia``) is the DIA kernel with its tail on the
  local block (x = 0 outside [0, n_loc), TPU kernel 1's boundary rule)
  while the halo is in flight, then one boundary launch that redoes the
  tail on the rows whose bands reach the neighbours' entries, from the
  received halos (``ops/dia_spmv.dia_fused_boundary``).
* ``DistEll``: the ELL kernel (``ops/ell_spmv.ell_spmv``) on the rank's
  rows, packed as one serial layout, over one preallocated extended
  source [left halo | x_loc | right halo] (halo mode) or the
  all-gathered source (gather mode, coarse levels whose columns reach
  past the neighbours).
* ``DistDense``: a small level's row block times the gathered source.
* ``GatherOut`` / ``ReplSrc``: the crossing into the replicated coarse
  levels (one all-gather, and none).

Each operator also has ``spmv_plain``: the same product in plain torch in
the vector's dtype (the fp64 refinement residual, and the plain version
the kernels are held to).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ..ops.dia_spmv import (CHEB, CHEB_LAST, CHEB_START, JACOBI, RESIDUAL,
                            SPMV, dia_fused_boundary)
from ..ops.ell_spmv import ell_plain, ell_spmv
from ..ops.formats import (DenseMatrix, DiaMatrix, EllMatrix, FusedDia,
                           dia_offsets, pack_ell)
from ..utils.trace import Tally
from .partition import Partition, _round_up

COLLECTIVES = Tally("dist.collectives")
HALO_BYTES = Tally("dist.halo_bytes")

# all_gather_into_tensor was renamed all_gather_single in later torch
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (the copy is synchronous)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """This process's place in the ranks that share the distributed
    levels: ``rank`` of ``size``, collectives over ``group`` (None: the
    default process group).  With ``size == 1`` no collective is issued
    and no process group is needed."""
    rank: int
    size: int
    group: object = None

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def _staged(self, t: torch.Tensor) -> bool:
        """gloo collectives take host tensors: stage CUDA tensors."""
        return t.is_cuda and dist.get_backend(self.group) == "gloo"

    def halo_start(self, x: torch.Tensor, h: int):
        """Post the exchange of x's boundary slices with the neighbour
        ranks and return a call that waits for it and gives (left,
        right): left = the last h entries of rank-1's x, right = the first
        h of rank+1's, zeros at the ends of the domain.  Work issued in
        between overlaps the transfer."""
        n = x.shape[0]
        zeros = lambda: torch.zeros(h, dtype=x.dtype, device=x.device)
        lo, hi = self.rank > 0, self.rank < self.size - 1
        if h == 0 or self.size == 1:
            return lambda: (zeros(), zeros())
        staged = self._staged(x)
        if staged:
            io = _pinned
            buf = lambda: torch.empty(h, dtype=x.dtype, pin_memory=True)
        else:
            io = lambda t: t
            buf = lambda: torch.empty(h, dtype=x.dtype, device=x.device)
        left = buf() if lo else zeros()
        right = buf() if hi else zeros()
        ops, sends = [], []     # sends stay referenced until the wait
        if lo:
            peer = self._peer(self.rank - 1)
            sends.append(io(x[:h]))
            ops += [dist.P2POp(dist.isend, sends[-1], peer, self.group),
                    dist.P2POp(dist.irecv, left, peer, self.group)]
        if hi:
            peer = self._peer(self.rank + 1)
            sends.append(io(x[n - h:]))
            ops += [dist.P2POp(dist.isend, sends[-1], peer, self.group),
                    dist.P2POp(dist.irecv, right, peer, self.group)]
        reqs = dist.batch_isend_irecv(ops)
        COLLECTIVES.add()
        HALO_BYTES.add(len(sends) * h * x.element_size())

        def finish():
            for req in reqs:
                req.wait()
            sends.clear()
            if staged:
                return left.to(x.device), right.to(x.device)
            return left, right
        return finish

    def halo(self, x: torch.Tensor, h: int, out: torch.Tensor | None = None):
        """The extended vector [left | x | right] (see halo_start), written
        into `out` (length len(x) + 2h) when given."""
        n = x.shape[0]
        finish = self.halo_start(x, h)
        if out is None:
            out = torch.empty(n + 2 * h, dtype=x.dtype, device=x.device)
        out[h:h + n].copy_(x)
        if h:
            out[:h], out[h + n:] = finish()
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x, concatenated in rank order."""
        if self.size == 1:
            return x
        COLLECTIVES.add()
        if self._staged(x):
            out = torch.empty(self.size * x.shape[0], dtype=x.dtype,
                              pin_memory=True)
            _gather_into(out, _pinned(x), group=self.group)
            return out.to(x.device)
        out = torch.empty(self.size * x.shape[0], dtype=x.dtype,
                          device=x.device)
        _gather_into(out, x.contiguous(), group=self.group)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the ranks (t itself with one rank)."""
        if self.size == 1:
            return t
        COLLECTIVES.add()
        if self._staged(t):
            h = _pinned(t)
            dist.all_reduce(h, group=self.group)
            return h.to(t.device)
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t


def pdot(x: torch.Tensor, y: torch.Tensor, ranks: RankGroup,
         compensated: bool = True) -> torch.Tensor:
    """Global inner product: each rank's partial, then one all-reduce.
    With `compensated`, fp32 partials are accumulated in fp64 and reduced
    in fp64 before the cast (the JAX package's df64 dot and psum)."""
    if compensated and x.dtype == torch.float32:
        return ranks.all_reduce(torch.dot(x.double(), y.double())).to(x.dtype)
    return ranks.all_reduce(torch.dot(x, y))


# ---------------------------------------------------------------------------
# Distributed operators (this rank's block)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistDia(FusedDia):
    """Row-block DIA operator: bands[d, i] = A[r*n_loc + i,
    r*n_loc + i + offsets[d]] for this rank r; offsets are global and equal
    the local ones because block == n_loc.  Its products give this rank's
    rows of the serial products of the whole matrix, with their bits."""
    bands: torch.Tensor       # (n_diags, n_loc)
    offsets: tuple
    h: int                    # halo width, |off| <= h
    ranks: RankGroup
    n_rows: int               # logical global rows
    n_cols: int

    @property
    def n_loc(self) -> int:
        return self.bands.shape[-1]

    def as_local(self) -> DiaMatrix:
        """The local block as the serial layout the kernel runs on."""
        return DiaMatrix(self.bands, self.offsets, self.n_loc, self.n_loc)

    def _fused(self, local, tail, v, **vecs):
        """`local` (the serial product on the local block, v = 0 outside
        it) while v's halo is in flight, then the boundary launch of
        `tail` over its outputs.  One rank, or no halo: `local` alone."""
        r, size = self.ranks.rank, self.ranks.size
        if self.h == 0 or size == 1:
            return local()
        finish = self.ranks.halo_start(v, self.h)
        out = local()                        # overlaps the exchange
        left, right = finish()
        dia_fused_boundary(tail, self.bands, self.offsets, v, left, right,
                           out if isinstance(out, tuple) else (out,),
                           lo=r > 0, hi=r < size - 1, **vecs)
        return out

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """(A x) on this rank's rows."""
        return self._fused(lambda: self.as_local().spmv(x), SPMV, x)

    def residual(self, x, b):
        return self._fused(lambda: self.as_local().residual(x, b),
                           RESIDUAL, x, b=b)

    def jacobi_sweep(self, x, b, dinv, omega):
        return self._fused(
            lambda: self.as_local().jacobi_sweep(x, b, dinv, omega), JACOBI,
            x, b=b, dinv=dinv, x=x, s0=omega)

    def cheb_start(self, x, b, dinv, theta):
        local = lambda: self.as_local().cheb_start(x, b, dinv, theta)
        if x is None:                        # no product, so no halo
            return local()
        return self._fused(local, CHEB_START, x, b=b, dinv=dinv, s0=theta)

    def cheb_step(self, x, d, r, dinv, a, c):
        return self._fused(
            lambda: self.as_local().cheb_step(x, d, r, dinv, a, c), CHEB, d,
            b=r, dinv=dinv, x=x, s0=a, s1=c)

    def cheb_last(self, x, d, r, dinv, a, c):
        return self._fused(
            lambda: self.as_local().cheb_last(x, d, r, dinv, a, c),
            CHEB_LAST, d, b=r, dinv=dinv, x=x, s0=a, s1=c)

    def spmv_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The same product in plain torch, in the promoted dtype of the
        bands and x: shifted slices of the extended vector."""
        n, h = self.n_loc, self.h
        ext = self.ranks.halo(x, h)
        y = torch.zeros(n, dtype=torch.promote_types(self.bands.dtype,
                                                     x.dtype),
                        device=x.device)
        for d, off in enumerate(self.offsets):
            y = y + self.bands[d] * ext[h + off: h + off + n]
        return y


@dataclasses.dataclass(frozen=True)
class DistEll:
    """Row-block ELL operator: this rank's rows as one packed serial
    layout (``local``, ``ops/formats.py::pack_ell``).

    mode "halo": its columns index the extended source [left | x_loc |
    right] (length n_src + 2h); mode "gather": the all-gathered source
    (length size * n_src).  Padding slots hold val 0 and col h."""
    local: EllMatrix          # n_loc rows, `rows` of them real
    h: int
    mode: str                 # "halo" | "gather"
    ranks: RankGroup
    n_rows: int               # logical global rows
    n_cols: int
    n_src: int                # the source's local length (its n_loc)
    ext: torch.Tensor | None = None   # the halo-mode extended source

    @property
    def n_loc(self) -> int:
        return self.local.n_pad

    @property
    def rows(self) -> int:
        """This rank's real rows."""
        return self.local.n_rows

    def as_local(self) -> EllMatrix:
        """The local block as the serial layout the kernel runs on (its
        columns index the extended or gathered source)."""
        return self.local

    def source(self, x: torch.Tensor, into: torch.Tensor | None = None):
        """The vector the columns index: extended or gathered."""
        if self.mode == "halo":
            return self.ranks.halo(x, self.h, into)
        return self.ranks.all_gather(x)

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmv(self.local, self.source(x, self.ext))

    def spmv_plain(self, x: torch.Tensor) -> torch.Tensor:
        return ell_plain(self.local, self.source(x))


@dataclasses.dataclass(frozen=True)
class DistDense:
    """Densified small level, row-sliced: this rank's (n_loc, m_pad)
    slice times the all-gathered source."""
    mat: torch.Tensor         # (n_loc, m_pad)
    ranks: RankGroup
    n_rows: int
    n_cols: int

    @property
    def n_loc(self) -> int:
        return self.mat.shape[-2]

    def as_local(self) -> DenseMatrix:
        return DenseMatrix(self.mat, self.n_loc, self.mat.shape[1],
                           self.n_loc)

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mv(self.mat.to(x.dtype), self.ranks.all_gather(x))

    spmv_plain = spmv


@dataclasses.dataclass(frozen=True)
class GatherOut:
    """Restriction across the replication boundary: distributed input,
    replicated output (the wrapped product, then one all-gather)."""
    op: object                # DistEll | DistDense

    def as_local(self):
        return self.op.as_local()

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.ranks.all_gather(self.op.spmv(x))


@dataclasses.dataclass(frozen=True)
class ReplSrc:
    """Prolongation across the replication boundary: replicated input,
    distributed output.  The wrapped operator indexes the gathered source
    (gather mode), which every rank already holds: no collective."""
    op: object                # DistEll(mode="gather") | DistDense

    def as_local(self):
        return self.op.as_local()

    def spmv(self, x_full: torch.Tensor) -> torch.Tensor:
        op = self.op
        if isinstance(op, DistDense):
            return torch.mv(op.mat.to(x_full.dtype), x_full)
        return ell_spmv(op.local, x_full)


# ---------------------------------------------------------------------------
# Host-side construction of this rank's block
# ---------------------------------------------------------------------------

def _upload(a: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    """Host table to the device; bf16 through fp32, as the serial freeze
    (ops/formats.py) rounds it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == torch.bfloat16 and t.dtype == torch.float64:
        t = t.float()
    return t.to(device=device, dtype=dtype)


def _csr_fields(A: sp.csr_matrix):
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                     np.diff(A.indptr))
    return rows, A.indices.astype(np.int64), A.data


def _dia_offsets(A: sp.csr_matrix, rows, cols, dia_max_bands: int):
    """Sorted distinct offsets of A (the native pass where it serves)."""
    if A.nnz >= (1 << 16):
        offs = dia_offsets(A, dia_max_bands)
        if offs is None:
            return None
        return np.asarray(offs, dtype=np.int64)
    return np.unique(cols - rows)


def csr_to_dist(A: sp.csr_matrix, part_dst: Partition, part_src: Partition,
                ranks: RankGroup, dtype=torch.float32,
                prefer_dia: bool = True, dia_max_bands: int = 32,
                max_halo_frac: float = 1.0, dense_size: int = 0, *,
                device):
    """This rank's block of a host CSR operator, in the layout the JAX
    package's ``csr_to_dist`` picks (no GELL: that layout exists for the
    TPU):

    1. DistDense below `dense_size` on both sides;
    2. DistDia: square, same partition, at most `dia_max_bands` bands
       within the halo budget, at most 4x fill (no gathers);
    3. DistEll halo mode: every column on the rank itself or a neighbour;
    4. DistEll gather mode: anything else.

    The format and its static metadata (offsets, K, halo width) are
    decided on the whole matrix, so every rank picks the same layout."""
    nd, r = part_dst.nd, ranks.rank
    assert nd == part_src.nd == ranks.size
    n, m = A.shape
    assert n == part_dst.n and m == part_src.n
    nl_d, nl_s = part_dst.n_loc, part_src.n_loc
    r0, r1 = min(r * nl_d, n), min((r + 1) * nl_d, n)

    if dense_size and n <= dense_size and m <= dense_size:
        dense = np.zeros((nl_d, part_src.n_pad))
        dense[: r1 - r0, :m] = A[r0:r1].toarray()
        return DistDense(mat=_upload(dense, device, dtype), ranks=ranks,
                         n_rows=n, n_cols=m)

    rows, cols, data = _csr_fields(A)
    if prefer_dia and n == m and nl_d == nl_s and A.nnz > 0:
        offs = _dia_offsets(A, rows, cols, dia_max_bands)
        if offs is not None:
            maxoff = int(np.abs(offs).max()) if len(offs) else 0
            h = _round_up(maxoff, 128) if maxoff else 0
            if (len(offs) <= dia_max_bands and h <= max_halo_frac * nl_s
                    and len(offs) * n <= 4 * A.nnz):
                lo, hi = A.indptr[r0], A.indptr[r1]
                bands = np.zeros((len(offs), nl_d), dtype=np.float64)
                pos = np.searchsorted(offs, cols[lo:hi] - rows[lo:hi])
                bands[pos, rows[lo:hi] - r0] = data[lo:hi]
                return DistDia(bands=_upload(bands, device, dtype),
                               offsets=tuple(int(o) for o in offs), h=h,
                               ranks=ranks, n_rows=n, n_cols=m)

    nnz_per_row = np.diff(A.indptr)
    K = max(int(nnz_per_row.max()) if n > 0 else 0, 1)
    s_idx = rows // nl_d
    t_idx, c_loc = np.divmod(cols, nl_s)
    # halo feasibility: every column on shard s-1, s or s+1
    d = t_idx - s_idx
    if len(d) and np.all(np.abs(d) <= 1):
        h_r = int((c_loc[d == 1] + 1).max()) if np.any(d == 1) else 0
        h_l = int((nl_s - c_loc[d == -1]).max()) if np.any(d == -1) else 0
        h = _round_up(max(h_r, h_l), 128) if (h_r or h_l) else 0
    else:
        h = nl_s + 1  # force gather
    mode = "halo" if h <= max_halo_frac * nl_s else "gather"

    lo, hi = A.indptr[r0], A.indptr[r1]
    cl, dl = c_loc[lo:hi], d[lo:hi]
    if mode == "halo":
        ext = np.where(dl == 0, h + cl,
                       np.where(dl == 1, h + nl_s + cl, cl - (nl_s - h)))
        fill = h
    else:
        ext = cols[lo:hi]     # blocked global == plain global (block == n_loc)
        fill = 0
        h = 0
    nr = nnz_per_row[r0:r1]
    slot = np.arange(hi - lo, dtype=np.int64) - np.repeat(
        (A.indptr[r0:r1] - lo).astype(np.int64), nr)
    r_loc = rows[lo:hi] - r0
    cols_arr = np.full((K, nl_d), fill, dtype=np.int32)
    vals_arr = np.zeros((K, nl_d), dtype=np.float64)
    cols_arr[slot, r_loc] = ext
    vals_arr[slot, r_loc] = data[lo:hi]
    lens = np.zeros(nl_d, dtype=np.int32)
    lens[: r1 - r0] = nr
    return _dist_ell(cols_arr, vals_arr, lens, h, mode, ranks, n, m,
                     r1 - r0, nl_s, dtype, device)


def _dist_ell(cols, vals, lens, h, mode, ranks, n, m, rows, n_src, dtype,
              device) -> DistEll:
    ext = None
    if mode == "halo" and dtype != torch.float64:
        ext = torch.zeros(n_src + 2 * h, dtype=torch.float32, device=device)
    n_ext = n_src + 2 * h if mode == "halo" else ranks.size * n_src
    local = pack_ell(cols, vals, lens, rows, n_ext, dtype, device=device,
                     fill=h)
    return DistEll(local=local, h=int(h), mode=mode, ranks=ranks, n_rows=n,
                   n_cols=m, n_src=n_src, ext=ext)
