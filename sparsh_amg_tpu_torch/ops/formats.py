"""Device sparse-matrix layouts and SpMV over torch tensors (the port of
``sparsh_amg_tpu/ops/formats.py``).

Host CSR matrices are frozen at setup into one of three padded layouts:

* DIA: ``bands (D, n_pad)`` with ``bands[d, i] = A[i, i + offsets[d]]``;
  stencil levels.  SpMV and its fused tails run in ``ops/dia_spmv.py``.
* ELL-T: ``cols``/``vals`` of shape ``(K, n_pad)``, padding slots val 0,
  col 0; every irregular operator (P, R, coarse A).  ``ops/ell_spmv.py``.
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

from .._host import csr_arrays, get_lib
from .dia_spmv import dia_residual, dia_spmv
from .ell_spmv import ell_spmv


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
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


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Transposed-ELL storage: cols/vals (K, n_pad); pad entries val=0,col=0."""
    cols: torch.Tensor        # (K, n_pad) int32
    vals: torch.Tensor        # (K, n_pad)
    n_rows: int
    n_cols: int

    @property
    def n_pad(self) -> int:
        return self.cols.shape[1]

    @property
    def k(self) -> int:
        return self.cols.shape[0]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = sum_k vals[k] * x[cols[k]].  x must have length >= n_cols."""
        if x.shape[0] < self.n_cols:
            raise ValueError(f"x has {x.shape[0]} entries, the matrix "
                             f"{self.n_cols} columns")
        return ell_spmv(self.cols, self.vals, x)


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
    """r = b - A x, one fused kernel on DIA levels."""
    if isinstance(A, DiaMatrix):
        return dia_residual(A.bands, x, b, A.offsets)
    return b - A.spmv(x)


# ---------------------------------------------------------------------------
# Host -> device conversion
# ---------------------------------------------------------------------------

def _upload(a: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


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
    """Host ELL-T tables (cols int32, vals) of shape (K, n_pad)."""
    n, m = A.shape
    nnz_per_row = np.diff(A.indptr)
    K = max(int(nnz_per_row.max()) if n > 0 else 0, 1)
    n_pad = _round_up(max(n, 1), pad_multiple)
    lib = get_lib()
    if lib is not None and A.nnz >= (1 << 16) and vals_dtype == np.float32:
        # block-tiled parallel fill (the numpy scatter below takes seconds
        # on the 192^3 restriction)
        indptr, indices, data = csr_arrays(A)
        cols = np.empty((K, n_pad), dtype=np.int32)
        vals = np.empty((K, n_pad), dtype=np.float32)
        lib.ell_fill_f32(n, n_pad, K, indptr, indices, data,
                         cols.reshape(-1), vals.reshape(-1))
        return cols, vals
    cols = np.zeros((K, n_pad), dtype=np.int32)
    vals = np.zeros((K, n_pad), dtype=vals_dtype)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    # slot index of each nnz within its row
    slot = np.arange(A.nnz, dtype=np.int64) - np.repeat(
        A.indptr[:-1].astype(np.int64), nnz_per_row)
    cols[slot, rows] = A.indices
    vals[slot, rows] = A.data
    return cols, vals


def csr_to_ell(A: sp.csr_matrix, dtype=torch.float32, pad_multiple: int = 128,
               *, device) -> EllMatrix:
    cols, vals = ell_tables(A, pad_multiple)
    return EllMatrix(cols=_upload(cols, device, torch.int32),
                     vals=_upload(vals, device, dtype),
                     n_rows=A.shape[0], n_cols=A.shape[1])


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
