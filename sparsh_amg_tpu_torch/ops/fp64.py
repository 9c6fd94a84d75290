"""fp64 fine-level operator for the refinement residuals (the port of
``sparsh_amg_tpu/ops/df64.py`` and ``ops/df64_ops.py``).

The JAX package reaches a 1e-8 residual on fp32 hardware by storing the
fine operator as a df64 pair (hi, lo) and emulating double precision.  The
card has native fp64, so the operator is one DIA (or ELL-T) matrix with
fp64 entries equal to the JAX pair's hi + lo, and ``residual64`` is plain
PyTorch in fp64, as the JAX package's df64 residual is plain XLA.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .._native import csr_arrays, get_lib
from .dia_spmv import dia_plain
from .ell_spmv import ell_plain
from .formats import (DiaMatrix, EllMatrix, _round_up, _upload, dia_offsets,
                      ell_tables)


def _hi_lo(data: np.ndarray) -> np.ndarray:
    """fp64 values of the df64 split: hi = fl32(a), lo = fl32(a - hi)."""
    hi = data.astype(np.float32).astype(np.float64)
    return hi + (data - hi).astype(np.float32).astype(np.float64)


def csr_to_fp64(A: sp.csr_matrix, prefer_dia: bool = True,
                dia_max_bands: int = 32, pad_multiple: int = 2048, *,
                device):
    """fp64 device operator (DiaMatrix or EllMatrix) from a host CSR."""
    n, m = A.shape
    offsets = None
    if prefer_dia and n == m and A.nnz > 0:
        offsets = dia_offsets(A, dia_max_bands)
    if offsets is not None:
        n_pad = _round_up(max(n, 1), pad_multiple)
        lib = get_lib()
        if lib is not None:
            # the native single-pass hi/lo band split
            indptr, indices, data = csr_arrays(A)
            hi = np.empty((len(offsets), n_pad), dtype=np.float32)
            lo = np.empty((len(offsets), n_pad), dtype=np.float32)
            lib.dia_fill_df64(n, n_pad, len(offsets), indptr, indices, data,
                              offsets, hi, lo)
            bands = hi.astype(np.float64)
            bands += lo
        else:
            rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
            pos = np.searchsorted(offsets, A.indices.astype(np.int64) - rows)
            bands = np.zeros((len(offsets), n_pad))
            bands[pos, rows] = _hi_lo(A.data)
        return DiaMatrix(bands=_upload(bands, device, torch.float64),
                         offsets=tuple(int(o) for o in offsets),
                         n_rows=n, n_cols=m)
    split = A.copy()
    split.data = _hi_lo(A.data)
    cols, vals, lens = ell_tables(split, pad_multiple, vals_dtype=np.float64)
    return EllMatrix(cols=_upload(cols, device, torch.int32),
                     vals=_upload(vals, device, torch.float64),
                     lens=_upload(lens, device, torch.int32),
                     n_rows=n, n_cols=m)


def to_fp32(A64):
    """The fp32 Krylov operator, cast from the fp64 one on the device."""
    if isinstance(A64, DiaMatrix):
        return dataclasses.replace(A64, bands=A64.bands.float())
    return dataclasses.replace(A64, vals=A64.vals.float())


def spmv64(A64, x: torch.Tensor) -> torch.Tensor:
    """y = A x in fp64 (plain PyTorch, as the JAX df64 SpMV is plain XLA).
    Other operators (the distributed fp64 operator) bring their own
    ``spmv64``."""
    if isinstance(A64, DiaMatrix):
        return dia_plain(A64.bands, A64.offsets, x)
    if isinstance(A64, EllMatrix):
        return ell_plain(A64.cols, A64.vals, x)
    if hasattr(A64, "spmv64"):
        return A64.spmv64(x)
    raise TypeError(type(A64))


def residual64(A64, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """r = b - A x in fp64."""
    return b - spmv64(A64, x)
