"""Device sparse-matrix layouts and SpMV over torch tensors (the port of
``sparsh_amg_tpu/ops/formats.py``).

Host CSR matrices are frozen at setup into one of three padded layouts:

* DIA: ``bands (D, n_pad)`` with ``bands[d, i] = A[i, i + offsets[d]]``;
  stencil levels.  SpMV and its fused tails run in ``ops/dia_spmv.py``.
* ELL, stored as sliced ELL with T lanes per row (``EllMatrix``, SELL-P:
  SELL-C-sigma with T threads per row); every irregular operator (P, R,
  coarse A).  ``pack_ell`` builds it from host ELL-T tables
  ``cols``/``vals`` ``(K, n_pad)`` and row lengths; ``ops/ell_spmv.py``
  runs it.
* Dense: small levels, a plain matrix-vector product.

The host tables come from the same native fillers as the JAX package;
there is no GELL layout (its window tables exist only for the TPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from .._native import csr_arrays, get_lib
from ..utils import trace
from .dia_spmv import (dia_cheb_last, dia_cheb_start, dia_cheb_step,
                       dia_jacobi_sweep, dia_residual, dia_spmv)
from .ell_spmv import (ell_jacobi_sweep, ell_residual, ell_spmv,
                       ell_spmv_add, fusable)
from .split_rows import choose_lanes

# pack_ell sorts an operator's rows only when its slots fill this much:
# below it a launch is latency-bound (a few microseconds), so the slots
# sorting saves cost no time, while its scattered stores of y do (rank
# blocks of the flagship, scripts/torch_split_sweep.py, PERF.md)
SORT_MIN_BYTES = 1 << 24


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class FusedDia:
    """A layout whose products are the DIA kernel with its fused tails
    (``ops/dia_spmv.py``): a ``DiaMatrix``, or a rank's block of one
    (``parallel/dist.py::DistDia``).  The smoothers and ``residual`` take
    these products where the operator is one; every other layout runs an
    SpMV and plain elementwise PyTorch.

    ``residual(x, b)``: b - A x; ``jacobi_sweep(x, b, dinv, omega)``: x +
    omega dinv (b - A x); ``cheb_start(x, b, dinv, theta)``: (r, r /
    theta), r = dinv (b - A x); ``cheb_step(x, d, r, dinv, a, c)``: (x +
    d, r', a d + c r') with r' = r - dinv A d; ``cheb_last(x, d, r, dinv,
    a, c)``: (x + d) + (a d + c r').  The Chebyshev products take x None for a zero x, which
    they do not read (``cheb_start`` then has no product, and
    ``cheb_step`` returns d as x')."""


@dataclasses.dataclass(frozen=True)
class DiaMatrix(FusedDia):
    """Diagonal storage. bands[d, i] = A[i, i + offsets[d]] (0 outside)."""
    bands: torch.Tensor       # (n_diags, n_pad)
    offsets: tuple            # ints, sorted
    n_rows: int
    n_cols: int

    @property
    def n_pad(self) -> int:
        return self.bands.shape[1]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y[i] = sum_d bands[d,i] * x[i + off_d];  x padded to n_pad."""
        return dia_spmv(self.bands, x, self.offsets)

    def residual(self, x, b):
        return dia_residual(self.bands, x, b, self.offsets)

    def jacobi_sweep(self, x, b, dinv, omega):
        return dia_jacobi_sweep(self.bands, x, b, dinv, omega, self.offsets)

    def cheb_start(self, x, b, dinv, theta):
        return dia_cheb_start(self.bands, x, b, dinv, theta, self.offsets)

    def cheb_step(self, x, d, r, dinv, a, c):
        return dia_cheb_step(self.bands, x, d, r, dinv, a, c, self.offsets)

    def cheb_last(self, x, d, r, dinv, a, c):
        return dia_cheb_last(self.bands, x, d, r, dinv, a, c, self.offsets)


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Sliced ELL with T lanes per row (``pack_ell`` builds it).

    Rows are sorted by descending length within windows of ``sigma`` rows
    (sigma 1: in their own order, ``perm`` empty); packed row r (original
    row ``perm[r]``) lies in slice r // C, C = 32 / T rows per slice (the
    rows one warp serves).  Slice s stores
    ``slice_width[s]`` slots per row (its longest row rounded up to T * V)
    from entry ``slice_off[s]``: at step j, lane l (lane t = l % T of row
    l // T) holds the row's slots (j*T + t)*V ... (j*T + t)*V + V - 1 at
    entries slice_off[s] + (j*32 + l)*V ...  Padding slots hold val 0 and a
    valid column.  Every row of [0, n_pad) is packed, padding rows with
    length 0."""
    cols: torch.Tensor          # (E,) int32
    vals: torch.Tensor          # (E,)
    slice_off: torch.Tensor     # (n_slices,) int32
    slice_width: torch.Tensor   # (n_slices,) int32
    perm: torch.Tensor          # (n_pad,) int32: original row of packed
                                # row; (0,) for rows in their own order
    lens: torch.Tensor          # (n_pad,) int32: slots in use, packed order
    n_rows: int
    n_cols: int
    lanes: int                  # T
    vec: int                    # V: slots a lane loads at once
    sigma: int                  # rows of a sorting window
    k: int                      # the longest row
    nnz: int                    # slots in use

    @property
    def n_pad(self) -> int:
        return self.lens.shape[0]

    @property
    def n_slices(self) -> int:
        return self.slice_off.shape[0]

    def astype(self, dtype: torch.dtype) -> "EllMatrix":
        """The same layout with its values cast (on their device)."""
        return dataclasses.replace(self, vals=self.vals.to(dtype))

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x over the real slots.  x must have length >= n_cols."""
        self._covers(x)
        return ell_spmv(self, x)

    def _covers(self, x: torch.Tensor) -> None:
        if x.shape[0] < self.n_cols:
            raise ValueError(f"x has {x.shape[0]} entries, the matrix "
                             f"{self.n_cols} columns")


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Densified small-level operator, padded tight (256-multiples); spmv
    slices its input to mat's columns and zero-pads its output back to
    `out_pad`, the level vector length."""
    mat: torch.Tensor         # (r_pad, c_pad)
    n_rows: int
    n_cols: int
    out_pad: int

    @property
    def n_pad(self) -> int:
        return self.out_pad

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        r, c = self.mat.shape
        y = torch.mv(self.mat.to(x.dtype), x[:c])
        if self.out_pad > r:
            y = F.pad(y, (0, self.out_pad - r))
        return y


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """Polymorphic SpMV over device layouts."""
    return A.spmv(x)


def residual(A, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b - A x, the fused product on DIA levels, rank blocks and ELL
    levels."""
    if isinstance(A, FusedDia):
        return A.residual(x, b)
    if isinstance(A, EllMatrix) and fusable(A, x, b):
        A._covers(x)
        return ell_residual(A, x, b)
    return b - A.spmv(x)


def jacobi_sweep(A, x: torch.Tensor, b: torch.Tensor, dinv: torch.Tensor,
                 omega: float) -> torch.Tensor:
    """x + omega dinv (b - A x), the fused product on DIA levels, rank
    blocks and ELL levels."""
    if isinstance(A, FusedDia):
        return A.jacobi_sweep(x, b, dinv, omega)
    if isinstance(A, EllMatrix) and fusable(A, x, b, dinv, x):
        A._covers(x)
        return ell_jacobi_sweep(A, x, b, dinv, omega)
    return x + omega * dinv * (b - spmv(A, x))


def spmv_add(A, e: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x + A e (a prolongation's correction), one fused launch where A is
    an ELL operator."""
    if isinstance(A, EllMatrix) and fusable(A, e, x):
        A._covers(e)
        return ell_spmv_add(A, e, x)
    return x + spmv(A, e)


# ---------------------------------------------------------------------------
# Host -> device conversion
# ---------------------------------------------------------------------------

def _upload(a: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    """The one host-to-device copy of the freeze (span ``freeze.upload``,
    its bytes counted in ``freeze.upload_bytes``)."""
    with trace.span("freeze.upload"):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                         dtype=dtype)
    trace.count("freeze.upload_bytes", t.numel() * t.element_size())
    return t


def dia_offsets(A: sp.csr_matrix, dia_max_bands: int):
    """Sorted distinct (col - row) offsets when A is DIA-worthy (at most
    dia_max_bands diagonals, at most 4x fill), else None."""
    n = A.shape[0]
    lib = get_lib()
    if lib is not None:
        indptr, indices, _ = csr_arrays(A)
        uoffs = np.empty(dia_max_bands + 1, dtype=np.int64)
        k = int(lib.dia_offsets(n, indptr, indices, dia_max_bands, uoffs))
        # DIA wastes (n_diags*n - nnz) slots; accept if <= 4x
        return uoffs[:k].copy() if 0 < k and k * n <= 4 * A.nnz else None
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    uoffs = np.unique(A.indices.astype(np.int64) - rows)
    if len(uoffs) <= dia_max_bands and len(uoffs) * n <= 4 * A.nnz:
        return uoffs
    return None


def csr_to_dia(A: sp.csr_matrix, dtype=torch.float32, pad_multiple: int = 128,
               offsets: np.ndarray | None = None, *, device) -> DiaMatrix:
    n, m = A.shape
    if n != m:
        raise ValueError("DIA layout requires a square matrix")
    n_pad = _round_up(max(n, 1), pad_multiple)
    indptr, indices, data = csr_arrays(A)
    rows = None
    if offsets is None:
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
        offsets = np.unique(indices.astype(np.int64) - rows)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lib = get_lib()
    if lib is not None:
        # one OpenMP pass fills the fp32 band table
        bands = np.empty((len(offsets), n_pad), dtype=np.float32)
        lib.dia_fill_f32(n, n_pad, len(offsets), indptr, indices, data,
                         offsets, bands)
    else:
        if rows is None:
            rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
        bands = np.zeros((len(offsets), n_pad), dtype=np.float64)
        pos = np.searchsorted(offsets, indices.astype(np.int64) - rows)
        bands[pos, rows] = data
        bands = bands.astype(np.float32)
    return DiaMatrix(bands=_upload(bands, device, dtype),
                     offsets=tuple(int(o) for o in offsets),
                     n_rows=n, n_cols=m)


def ell_tables(A: sp.csr_matrix, pad_multiple: int, vals_dtype=np.float32):
    """Host ELL-T tables (cols int32, vals) of shape (K, n_pad) and the row
    lengths (n_pad,) int32, 0 on padding rows."""
    n, m = A.shape
    nnz_per_row = np.diff(A.indptr)
    K = max(int(nnz_per_row.max()) if n > 0 else 0, 1)
    n_pad = _round_up(max(n, 1), pad_multiple)
    lens = np.zeros(n_pad, dtype=np.int32)
    lens[:n] = nnz_per_row
    lib = get_lib()
    if lib is not None and A.nnz >= (1 << 16) and vals_dtype == np.float32:
        # block-tiled parallel fill (the numpy scatter below takes seconds
        # on the 192^3 restriction)
        indptr, indices, data = csr_arrays(A)
        cols = np.empty((K, n_pad), dtype=np.int32)
        vals = np.empty((K, n_pad), dtype=np.float32)
        lib.ell_fill_f32(n, n_pad, K, indptr, indices, data,
                         cols.reshape(-1), vals.reshape(-1))
        return cols, vals, lens
    cols = np.zeros((K, n_pad), dtype=np.int32)
    vals = np.zeros((K, n_pad), dtype=vals_dtype)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    # slot index of each nnz within its row
    slot = np.arange(A.nnz, dtype=np.int64) - np.repeat(
        A.indptr[:-1].astype(np.int64), nnz_per_row)
    cols[slot, rows] = A.indices
    vals[slot, rows] = A.data
    return cols, vals, lens


def csr_to_ell(A: sp.csr_matrix, dtype=torch.float32, pad_multiple: int = 128,
               *, device, **pack) -> EllMatrix:
    """``pack_ell`` of the CSR matrix's ELL-T tables (`pack`: its
    ``lanes``, ``vec``, ``sigma``)."""
    cols, vals, lens = ell_tables(A, pad_multiple)
    return pack_ell(cols, vals, lens, A.shape[0], A.shape[1], dtype,
                    device=device, **pack)


def _slices(plen: np.ndarray, n_pad: int, c: int, tv: int) -> tuple:
    """(widths, offsets) of the slices of c packed rows of lengths
    `plen`, each as wide as its longest row rounded up to tv slots."""
    n_slices = -(-n_pad // c)
    full = np.zeros(n_slices * c, dtype=np.int64)
    full[:n_pad] = plen
    width = -(-full.reshape(n_slices, c).max(axis=1) // tv) * tv
    off = np.zeros(n_slices, dtype=np.int64)
    np.cumsum(width[:-1] * c, out=off[1:])
    return width, off


def pack_ell(cols: np.ndarray, vals: np.ndarray, lens: np.ndarray,
             n_rows: int, n_cols: int, dtype=torch.float32, *, device,
             lanes: int | None = None, vec: int | None = None,
             sigma: int | None = None, fill: int = 0) -> EllMatrix:
    """The one packing of an ELL operator: host ELL-T tables ``cols``,
    ``vals`` (K, n_pad), whose slots past each row's length hold val 0
    (and col `fill`), and the row lengths ``lens`` (n_pad,), to the sliced
    layout on `device`.  T, V and sigma come from
    ``split_rows.choose_lanes`` unless given; a chosen sigma falls to 1
    (rows in their own order, no ``perm`` stored) when sorting would not
    save more slot bytes than ``perm`` costs, or the sorted slots would
    fill less than SORT_MIN_BYTES.  Slots the tables lack hold
    val 0, col `fill`.  bf16 values are rounded through fp32, as every
    host table is."""
    K, n_pad = cols.shape
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    if lens[n_rows:].any():
        raise ValueError("padding rows must have length 0")
    k = int(lens.max()) if n_pad else 0
    nnz = int(lens.sum())
    chosen = sigma is None
    if None in (lanes, vec, sigma):
        t, v, w = choose_lanes(n_rows, max(k, 1), nnz / max(n_rows, 1))
        lanes, vec, sigma = lanes or t, vec or v, sigma or w
    tv, c = lanes * vec, 32 // lanes
    lib = get_lib()
    perm = np.arange(n_pad)
    width, off = _slices(lens, n_pad, c, tv)
    if sigma > 1:
        # descending length within each window of sigma rows (stable)
        if lib is not None:
            order = np.empty(n_pad, dtype=np.int64)
            lib.ell_sort_windows(n_pad, sigma, lens, order)
        else:
            order = np.argsort(perm // sigma * (k + 1) + (k - lens),
                               kind="stable")
        w_sorted, o_sorted = _slices(lens[order], n_pad, c, tv)
        slot_bytes = 4 + torch.empty((), dtype=dtype).element_size()
        if not chosen or (
                slot_bytes * c * int((width - w_sorted).sum()) > 4 * n_pad
                and slot_bytes * c * int(w_sorted.sum()) >= SORT_MIN_BYTES):
            perm, width, off = order, w_sorted, o_sorted
        else:
            sigma = 1
    total = int((width * c).sum())
    if total >= 1 << 31:
        raise ValueError(f"{total} slots exceed the int32 range")
    if vals.dtype == np.float64 and dtype != torch.float64:
        vals = vals.astype(np.float32)
    n_slices = width.shape[0]
    if lib is not None and vals.dtype in (np.float32, np.float64):
        pcols = np.empty(total, dtype=np.int32)
        pvals = np.empty(total, dtype=vals.dtype)
        pack = lib.ell_pack_f32 if vals.dtype == np.float32 \
            else lib.ell_pack_f64
        pack(n_pad, K, n_slices, lanes, vec,
             perm.ctypes.data if sigma > 1 else None, width, off,
             np.ascontiguousarray(cols, dtype=np.int32),
             np.ascontiguousarray(vals), fill, pcols, pvals)
    else:
        # the tables in packed row order, padded to whole slices and to a
        # multiple of T * V slots, as (slice, step, row, lane, slot of
        # load); each slice keeps its first width / (T * V) steps
        kk = -(-max(K, 1) // tv) * tv
        shape = (kk // tv, lanes, vec, n_slices, c)
        keep = np.arange(kk // tv)[None, :] < (width // tv)[:, None]

        def packed(table, pad):
            t = np.full((kk, n_slices * c), pad, dtype=table.dtype)
            t[:K, :n_pad] = table[:, perm] if sigma > 1 else table
            return t.reshape(shape).transpose(3, 0, 4, 1, 2)[keep] \
                .reshape(-1)

        pcols, pvals = packed(cols, fill), packed(vals, 0)
    i32 = lambda a: _upload(a.astype(np.int32), device, torch.int32)
    return EllMatrix(cols=i32(pcols), vals=_upload(pvals, device, dtype),
                     slice_off=i32(off), slice_width=i32(width),
                     perm=i32(perm if sigma > 1 else perm[:0]),
                     lens=i32(lens[perm]), n_rows=n_rows, n_cols=n_cols,
                     lanes=lanes, vec=vec, sigma=sigma, k=k, nnz=nnz)


def csr_to_dense(A: sp.csr_matrix, dtype=torch.float32,
                 pad_multiple: int = 128, out_pad: int | None = None,
                 in_pad: int | None = None, *, device) -> DenseMatrix:
    """mat stays tight (256-multiples); `out_pad` (default: n rounded to
    pad_multiple) is the level vector length spmv emits; `in_pad` caps the
    column pad at the source vector's length."""
    n, m = A.shape
    if out_pad is None:
        out_pad = _round_up(max(n, 1), pad_multiple)
    tight = min(pad_multiple, 256)
    np_, mp_ = _round_up(max(n, 1), tight), _round_up(max(m, 1), tight)
    np_ = min(np_, out_pad)
    if in_pad is not None:
        mp_ = min(mp_, in_pad)
    dense = np.zeros((np_, mp_), dtype=np.float32)
    dense[:n, :m] = A.astype(np.float32).toarray()
    return DenseMatrix(mat=_upload(dense, device, dtype), n_rows=n,
                       n_cols=m, out_pad=out_pad)


def csr_to_device(A: sp.csr_matrix, dtype=torch.float32,
                  prefer_dia: bool = True, dia_max_bands: int = 32,
                  pad_multiple: int = 128, dense_size: int = 0, *, device):
    """Dense below `dense_size` rows; DIA when the matrix is square and
    stencil-structured; ELL-T otherwise."""
    n, m = A.shape
    if dense_size and n <= dense_size and m <= dense_size:
        return csr_to_dense(A, dtype, pad_multiple,
                            in_pad=_round_up(max(m, 1), pad_multiple),
                            device=device)
    if prefer_dia and n == m and A.nnz > 0:
        offsets = dia_offsets(A, dia_max_bands)
        if offsets is not None:
            return csr_to_dia(A, dtype, pad_multiple, offsets, device=device)
    return csr_to_ell(A, dtype, pad_multiple, device=device)
