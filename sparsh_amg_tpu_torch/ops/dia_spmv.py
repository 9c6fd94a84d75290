"""DIA SpMV and its fused tails: the Hopper port of the Pallas kernels in
``sparsh_amg_tpu/ops/pallas_spmv.py`` (``dia_spmv_pallas`` and ``_dia_fused``
behind ``dia_residual``, ``dia_dinv_residual``, ``dia_jacobi_sweep`` and
``dia_cheb_step``).  The kernel is ``csrc/dia_spmv.cu``.

Every wrapper takes the kernel's plain PyTorch version (shifted slices)
for tensors on the CPU, launches the CUDA kernel for tensors on the card,
and raises for anything else.  Each wrapper counts its kernel launches in
its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

SPMV, RESIDUAL, DINV_RESIDUAL, JACOBI, CHEB = range(5)
MAX_BANDS = 32          # the kernel's offset table (params.dia_max_bands)
BAND_DTYPES = (torch.float32, torch.bfloat16)
# Each kernel thread reads 16 bytes of a band row (8 bf16 or 4 fp32 rows)
# and of every vector: n_pad must be a multiple of ROW_ALIGN (csr_to_dia
# pads to 128) and every tensor the kernel reads or writes must start on a
# 16-byte boundary.  csrc/dia_spmv.cu checks the same (kRowAlign).
ROW_ALIGN = 8
PTR_ALIGN = 16


def dia_plain(bands: torch.Tensor, offsets: tuple,
              v: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_d bands[d, i] * v[i + off_d], v zero outside [0, n_pad).
    Shifted slices of a zero-padded copy, summed over d in order, in the
    promoted dtype of bands and v (fp32 for bf16 bands)."""
    n_pad = v.shape[0]
    h = max((abs(o) for o in offsets), default=0)
    vp = F.pad(v, (h, h))
    y = torch.zeros(n_pad, dtype=torch.promote_types(bands.dtype, v.dtype),
                    device=v.device)
    for d, off in enumerate(offsets):
        y = y + bands[d] * vp[h + off: h + off + n_pad]
    return y


def dia_fused_plain(tail, bands, offsets, v, b=None, dinv=None, x=None,
                    s0=0.0, s1=0.0):
    """The plain PyTorch version of every kernel entry: `tail` applied to
    az = A v (see csrc/dia_spmv.cu for the five tails)."""
    az = dia_plain(bands, offsets, v)
    if tail == SPMV:
        return az
    if tail == RESIDUAL:
        return b - az
    if tail == DINV_RESIDUAL:
        return dinv * (b - az)
    if tail == JACOBI:
        return x + s0 * dinv * (b - az)
    r2 = b - dinv * az                  # CHEB: v = d, b = r
    return x + v, r2, s0 * v + s1 * r2


def _check(bands, offsets, vecs):
    if bands.dim() != 2 or bands.dtype not in BAND_DTYPES \
            or not bands.is_contiguous():
        raise ValueError(f"bands must be a contiguous 2-D fp32/bf16 tensor, "
                         f"got {tuple(bands.shape)} {bands.dtype}")
    n_bands, n_pad = bands.shape
    if len(offsets) != n_bands or not 1 <= n_bands <= MAX_BANDS:
        raise ValueError(f"{len(offsets)} offsets for {n_bands} bands "
                         f"(1..{MAX_BANDS} supported)")
    if n_pad >= 1 << 31:
        raise ValueError(f"n_pad {n_pad} exceeds the kernel's int32 range")
    if n_pad % ROW_ALIGN:
        raise ValueError(f"n_pad {n_pad} is not a multiple of {ROW_ALIGN}")
    for t in vecs:
        if t.shape != (n_pad,) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != bands.device:
            raise ValueError(
                f"vectors must be contiguous fp32 ({n_pad},) on "
                f"{bands.device}, got {tuple(t.shape)} {t.dtype} {t.device}")


def _c_offsets(offsets: tuple):
    return (ctypes.c_int * len(offsets))(*offsets)


def _check_aligned(tensors):
    for t in tensors:
        if t.data_ptr() % PTR_ALIGN:
            raise ValueError(f"the DIA kernel needs {PTR_ALIGN}-byte aligned "
                             f"tensors; one starts at {t.data_ptr():#x}")


def instantiation(bands: torch.Tensor, offsets: tuple) -> str:
    """Which instantiation of the kernel a band table launches ("NB=<count>"
    where the band count is a template parameter, "runtime" otherwise) and
    the halo of v it stages around each tile, as "NB=7 halo=192"."""
    from .. import _build
    lib, bf16 = _build.lib(), int(bands.dtype == torch.bfloat16)
    nb = lib.dia_instantiation(bf16, len(offsets))
    halo = lib.dia_halo(bf16, len(offsets), _c_offsets(offsets))
    return f"{f'NB={nb}' if nb else 'runtime'} halo={halo}"


def _launch(tail, bands, offsets, v, b, dinv, x, s0, s1, n_out):
    from .. import _build
    _check_aligned([t for t in (bands, v, b, dinv, x) if t is not None])
    outs = [torch.empty_like(v) for _ in range(n_out)]
    ptr = lambda t: None if t is None else t.data_ptr()
    ys = [o.data_ptr() for o in outs] + [None] * (3 - n_out)
    rc = _build.lib().dia_fused_launch(
        int(bands.dtype == torch.bfloat16), tail, bands.data_ptr(),
        bands.shape[0], _c_offsets(offsets), bands.shape[1], ptr(v), ptr(b),
        ptr(dinv), ptr(x), float(s0), float(s1), *ys,
        torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(rc, "dia_fused")
    return outs


def _run(wrapper, tail, bands, offsets, v, b=None, dinv=None, x=None,
         s0=0.0, s1=0.0, n_out=1):
    _check(bands, offsets, [t for t in (v, b, dinv, x) if t is not None])
    if v.device.type == "cpu":
        return dia_fused_plain(tail, bands, offsets, v, b, dinv, x, s0, s1)
    if v.device.type != "cuda":
        raise ValueError(f"no DIA kernel for device {v.device}")
    outs = _launch(tail, bands, offsets, v, b, dinv, x, s0, s1, n_out)
    wrapper.launches += 1
    return outs[0] if n_out == 1 else tuple(outs)


def dia_spmv(bands, x, offsets: tuple):
    """y = A x.  bands (D, n_pad), x (n_pad,)."""
    return _run(dia_spmv, SPMV, bands, offsets, x)


def dia_residual(bands, x, b, offsets: tuple):
    """r = b - A x."""
    return _run(dia_residual, RESIDUAL, bands, offsets, x, b=b)


def dia_dinv_residual(bands, x, b, dinv, offsets: tuple):
    """r = dinv * (b - A x): the Jacobi/Chebyshev residual from nonzero x."""
    return _run(dia_dinv_residual, DINV_RESIDUAL, bands, offsets, x, b=b,
                dinv=dinv)


def dia_jacobi_sweep(bands, x, b, dinv, omega: float, offsets: tuple):
    """x' = x + omega * dinv * (b - A x): one weighted-Jacobi sweep."""
    return _run(dia_jacobi_sweep, JACOBI, bands, offsets, x, b=b, dinv=dinv,
                x=x, s0=omega)


def dia_cheb_step(bands, x, d, r, dinv, a: float, c: float, offsets: tuple):
    """One Chebyshev iteration: x' = x + d; r' = r - dinv * (A d);
    d' = a*d + c*r'.  Returns (x', r', d')."""
    return _run(dia_cheb_step, CHEB, bands, offsets, d, b=r, dinv=dinv, x=x,
                s0=a, s1=c, n_out=3)


WRAPPERS = (dia_spmv, dia_residual, dia_dinv_residual, dia_jacobi_sweep,
            dia_cheb_step)
for _w in WRAPPERS:
    _w.launches = 0
