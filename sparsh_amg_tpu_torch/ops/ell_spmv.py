"""Irregular SpMV on transposed ELLPACK: the Hopper port of the Pallas
window-gather kernel ``sparsh_amg_tpu/ops/gell.py::gell_gather_pallas`` and
its row reduction.  The kernel is ``csrc/ell_spmv.cu``.

The wrapper takes the plain PyTorch version (one gather, a product and a
sum over slots) for tensors on the CPU, launches the CUDA kernel for
tensors on the card, and raises for anything else.  ``ell_spmv.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

VAL_DTYPES = (torch.float32, torch.bfloat16)


def ell_plain(cols: torch.Tensor, vals: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_k vals[k, i] * x[cols[k, i]] in the promoted dtype of
    vals and x (fp32 for bf16 values)."""
    g = torch.index_select(x, 0, cols.reshape(-1)).reshape(cols.shape)
    return (vals * g).sum(dim=0)


def _check(cols, vals, x):
    if cols.dim() != 2 or cols.dtype != torch.int32 \
            or not cols.is_contiguous():
        raise ValueError(f"cols must be a contiguous 2-D int32 tensor, got "
                         f"{tuple(cols.shape)} {cols.dtype}")
    if vals.shape != cols.shape or vals.dtype not in VAL_DTYPES \
            or not vals.is_contiguous():
        raise ValueError(f"vals must be contiguous fp32/bf16 "
                         f"{tuple(cols.shape)}, got {tuple(vals.shape)} "
                         f"{vals.dtype}")
    if cols.shape[1] >= 1 << 31:
        raise ValueError(f"n_pad {cols.shape[1]} exceeds int32 range")
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 1-D fp32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not (cols.device == vals.device == x.device):
        raise ValueError(f"tensors on different devices: {cols.device}, "
                         f"{vals.device}, {x.device}")


def ell_spmv(cols, vals, x):
    """y = A x for an ELL-T matrix; x must cover every column index."""
    _check(cols, vals, x)
    if x.device.type == "cpu":
        return ell_plain(cols, vals, x)
    if x.device.type != "cuda":
        raise ValueError(f"no ELL kernel for device {x.device}")
    from .. import _build
    k, n_pad = cols.shape
    y = torch.empty(n_pad, dtype=torch.float32, device=x.device)
    rc = _build.lib().ell_spmv_launch(
        int(vals.dtype == torch.bfloat16), cols.data_ptr(), vals.data_ptr(),
        k, n_pad, x.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ell_spmv")
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0
