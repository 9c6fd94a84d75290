"""fp64 fine-level operator for the refinement residuals (the port of
``sparsh_amg_tpu/ops/df64.py`` and ``ops/df64_ops.py``).

The JAX package reaches a 1e-8 residual on fp32 hardware by storing the
fine operator as a df64 pair (hi, lo) and emulating double precision.  The
card has native fp64, so the operator is one DIA (or sliced ELL) matrix with
fp64 entries equal to the JAX pair's hi + lo, and ``residual64`` is plain
PyTorch in fp64, as the JAX package's df64 residual is plain XLA.

The refinement pass's finish (x64 += d, r = b64 - A x64, the fp32 cast of
r for the next pass, ||r||^2) runs ``finish64``: on a DIA operator on the
card one hand-written kernel, ``csrc/dia_finish64.cu`` (``dia_finish64``),
in place; anywhere else its plain version, ``finish64_plain``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .._native import csr_arrays, get_lib
from .dia_spmv import MAX_BANDS, PTR_ALIGN, dia_plain
from .ell_spmv import ell_plain
from .formats import (DiaMatrix, EllMatrix, _round_up, _upload, dia_offsets,
                      ell_tables, pack_ell)


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
    return pack_ell(cols, vals, lens, n, m, torch.float64, device=device)


def to_fp32(A64):
    """The fp32 Krylov operator, cast from the fp64 one on the device."""
    if isinstance(A64, DiaMatrix):
        return dataclasses.replace(A64, bands=A64.bands.float())
    return A64.astype(torch.float32)


def spmv64(A64, x: torch.Tensor) -> torch.Tensor:
    """y = A x in fp64 (plain PyTorch, as the JAX df64 SpMV is plain XLA).
    Other operators (the distributed fp64 operator) bring their own
    ``spmv64``."""
    if isinstance(A64, DiaMatrix):
        return dia_plain(A64.bands, A64.offsets, x)
    if isinstance(A64, EllMatrix):
        return ell_plain(A64, x)
    if hasattr(A64, "spmv64"):
        return A64.spmv64(x)
    raise TypeError(type(A64))


def residual64(A64, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """r = b - A x in fp64."""
    return b - spmv64(A64, x)


def finish64_plain(A64, x64: torch.Tensor, d: torch.Tensor,
                   b64: torch.Tensor, dot) -> tuple:
    """The pass finish in plain PyTorch: (x, r, rr) with x = x64 + d (d
    promoted to fp64), r = b64 - A64 x in fp64 and rr = dot(r, r) as a
    1-vector; new tensors, for the caller to store (r cast to fp32)."""
    x = x64 + d
    r = residual64(A64, b64, x)
    return x, r, dot(r, r).reshape(1)


def finish_kernel_applies(A64, device) -> bool:
    """Whether ``finish64`` launches ``dia_finish64``: A64 a DIA operator
    (not sliced ELL, not a rank block) and the vectors on the card."""
    return isinstance(A64, DiaMatrix) and torch.device(device).type == "cuda"


def _check_finish(A64, x64, d, b64, b, rr) -> None:
    bands, n_pad = A64.bands, A64.n_pad
    if bands.dtype != torch.float64 or bands.dim() != 2 \
            or not bands.is_contiguous():
        raise ValueError(f"the finish needs contiguous fp64 bands, got "
                         f"{tuple(bands.shape)} {bands.dtype}")
    if not 1 <= len(A64.offsets) <= MAX_BANDS:
        raise ValueError(f"{len(A64.offsets)} bands (1..{MAX_BANDS} "
                         f"supported)")
    if n_pad % 2 or not 0 < n_pad < 1 << 31:
        raise ValueError(f"n_pad {n_pad}: the finish takes an even n_pad "
                         f"in (0, 2^31)")
    for name, t, dt, shape in (("x64", x64, torch.float64, (n_pad,)),
                               ("d", d, torch.float32, (n_pad,)),
                               ("b64", b64, torch.float64, (n_pad,)),
                               ("b", b, torch.float32, (n_pad,)),
                               ("rr", rr, torch.float64, (1,))):
        if t.shape != shape or t.dtype != dt or not t.is_contiguous() \
                or t.device != bands.device:
            raise ValueError(f"{name} must be contiguous {dt} {shape} on "
                             f"{bands.device}, got {tuple(t.shape)} "
                             f"{t.dtype} {t.device}")


def dia_finish64(A64: DiaMatrix, x64: torch.Tensor, d: torch.Tensor,
                 b64: torch.Tensor, b: torch.Tensor,
                 rr: torch.Tensor) -> tuple:
    """The pass finish on a DIA operator, in place: x64 += d, b =
    fp32(b64 - A64 x64), rr[0] = ||b64 - A64 x64||^2; returns (x64, b,
    rr).  On the card two launches of ``csrc/dia_finish64.cu`` (x64 and b
    with ``finish64_plain``'s bits; rr from the kernel's own fixed order
    of sums); on the CPU ``finish64_plain``, written into the same
    tensors."""
    _check_finish(A64, x64, d, b64, b, rr)
    if x64.device.type == "cpu":
        x, r, s = finish64_plain(A64, x64, d, b64, torch.dot)
        x64.copy_(x)
        b.copy_(r)
        rr.copy_(s)
        return x64, b, rr
    if x64.device.type != "cuda":
        raise ValueError(f"no finish kernel for device {x64.device}")
    from .. import _build
    lib = _build.lib()
    tensors = (A64.bands, x64, d, b64, b)
    if any(t.data_ptr() % PTR_ALIGN for t in tensors):
        raise ValueError(f"the finish kernel needs {PTR_ALIGN}-byte aligned "
                         f"tensors")
    scratch = torch.empty(lib.dia_finish64_scratch(A64.n_pad),
                          dtype=torch.float64, device=x64.device)
    offsets = (ctypes.c_int * len(A64.offsets))(*A64.offsets)
    rc = lib.dia_finish64_launch(
        A64.bands.data_ptr(), len(A64.offsets), offsets, A64.n_pad,
        x64.data_ptr(), d.data_ptr(), b64.data_ptr(), b.data_ptr(),
        scratch.data_ptr(), rr.data_ptr(),
        torch.cuda.current_stream(x64.device).cuda_stream)
    _build.check(rc, "dia_finish64")
    dia_finish64.launches += 2
    return x64, b, rr


dia_finish64.launches = 0


def finish_halo(offsets: tuple) -> int:
    """The halo of x64 that ``dia_finish64``'s kernel stages around each
    tile for these offsets (no CUDA call)."""
    from .. import _build
    return _build.lib().dia_finish64_halo(
        len(offsets), (ctypes.c_int * len(offsets))(*offsets))


def finish64(A64, x64: torch.Tensor, d: torch.Tensor, b64: torch.Tensor,
             b: torch.Tensor, rr: torch.Tensor, dot) -> tuple:
    """The refinement pass's finish: (x, r, rr) to store into (x64, b,
    rr).  ``dia_finish64`` in place where ``finish_kernel_applies``
    (it returns the buffers themselves, r already cast into b), else
    ``finish64_plain`` with `dot` (the solver's: an all-reduce on rank
    blocks)."""
    if finish_kernel_applies(A64, x64.device):
        return dia_finish64(A64, x64, d, b64, b, rr)
    return finish64_plain(A64, x64, d, b64, dot)
