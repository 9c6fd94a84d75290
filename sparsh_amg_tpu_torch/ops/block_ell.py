"""Block SpMV for systems operators: the Hopper port of the Pallas kernel
``sparsh_amg_tpu/ops/block_gell.py::block_gell_pallas`` and the reduction
that ``BlockGellMatrix.spmv`` applies to its streams.  The kernel is
``csrc/block_ell_spmv.cu``.

A dof-interleaved systems matrix with ``bs`` dofs per node is stored over
its NODE pattern (the union of the dof patterns of each bs x bs block),
with every block dense (missing intra-block entries are explicit zeros):

* ``cols (K, nb) int32``: node column of slot k of node row i; padding
  slots have col 0 and a zero block;
* ``vals (K, bs, n_pad)``: position ``bs*i + c`` of plane ``(k, d)`` holds
  ``A[bs*i + c, bs*cols[k, i] + d]``;
* ``lens (nb,) int32``: the slots of node row i in use.

So ``y[t] = sum_{k < lens[t // bs]} sum_d vals[k, d, t] *
x[bs*cols[k, t // bs] + d]``: one output per dof row t, x and y stay
dof-interleaved.  The GELL windows,
16-bit packing, SMEM chunking and de-interleaved source planes of the
TPU layout exist only for Mosaic and are not ported.

``block_ell_spmv`` takes the plain PyTorch version for tensors on the CPU,
launches the CUDA kernel for tensors on the card, and raises for anything
else; its launch shape comes from ``split_rows.launch_shape`` over (dof
rows, node slots).  ``block_ell_spmv.launches`` counts kernel launches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .formats import _round_up
from .split_rows import launch_shape

VAL_DTYPES = (torch.float32, torch.bfloat16)
BLOCK_SIZES = (2, 3, 4, 5, 6)     # the kernel's template instantiations


@dataclasses.dataclass(frozen=True)
class BlockEllMatrix:
    """Node-pattern ELL with dense bs x bs blocks (see the module doc)."""
    cols: torch.Tensor        # (K, nb) int32
    vals: torch.Tensor        # (K, bs, n_pad)
    lens: torch.Tensor        # (nb,) int32
    n_rows: int
    n_cols: int

    @property
    def bs(self) -> int:
        return self.vals.shape[1]

    @property
    def n_pad(self) -> int:
        return self.vals.shape[2]

    @property
    def k(self) -> int:
        return self.cols.shape[0]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x, length n_pad (0 beyond n_rows); x covers n_cols."""
        if x.shape[0] < self.n_cols:
            raise ValueError(f"x has {x.shape[0]} entries, the matrix "
                             f"{self.n_cols} columns")
        return block_ell_spmv(self.cols, self.vals, self.lens, x)


def block_ell_plain(cols: torch.Tensor, vals: torch.Tensor,
                    x: torch.Tensor,
                    lens: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's plain PyTorch version: one gather of the bs source
    entries of every slot, products and a sum over (k, d), in the promoted
    dtype of vals and x (fp32 for bf16 values); with `lens`, over the
    node slots k < lens[t // bs] only, as the kernel sums (the same y
    where padding slots hold zero blocks)."""
    k, nb = cols.shape
    bs, n_pad = vals.shape[1], vals.shape[2]
    n = nb * bs
    src = (cols.long() * bs).unsqueeze(1) + torch.arange(
        bs, device=cols.device).view(1, bs, 1)
    g = x[src].repeat_interleave(bs, dim=2)        # (k, bs, n): x[bs*j + d]
    prod = vals[:, :, :n] * g
    if lens is not None:
        live = torch.arange(k, device=cols.device)[:, None] < lens[None, :]
        prod = torch.where(live.repeat_interleave(bs, dim=1)[:, None, :],
                           prod, torch.zeros((), dtype=prod.dtype,
                                             device=prod.device))
    y = prod.sum(dim=(0, 1))
    out = torch.zeros(n_pad, dtype=y.dtype, device=x.device)
    out[:n] = y
    return out


def _check(cols, vals, lens, x):
    if cols.dim() != 2 or cols.dtype != torch.int32 \
            or not cols.is_contiguous():
        raise ValueError(f"cols must be a contiguous 2-D int32 tensor, got "
                         f"{tuple(cols.shape)} {cols.dtype}")
    if vals.dim() != 3 or vals.shape[0] != cols.shape[0] \
            or vals.dtype not in VAL_DTYPES or not vals.is_contiguous():
        raise ValueError(f"vals must be a contiguous fp32/bf16 "
                         f"({cols.shape[0]}, bs, n_pad) tensor, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    bs, n_pad = vals.shape[1], vals.shape[2]
    if bs not in BLOCK_SIZES:
        raise ValueError(f"block size {bs} is not one of {BLOCK_SIZES}")
    if cols.shape[1] * bs > n_pad or n_pad >= 1 << 31:
        raise ValueError(f"{cols.shape[1]} node rows of {bs} dofs do not fit "
                         f"n_pad {n_pad}, or n_pad exceeds int32 range")
    if lens.shape != (cols.shape[1],) or lens.dtype != torch.int32 \
            or not lens.is_contiguous():
        raise ValueError(f"lens must be a contiguous int32 "
                         f"({cols.shape[1]},) tensor, got "
                         f"{tuple(lens.shape)} {lens.dtype}")
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 1-D fp32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not (cols.device == vals.device == lens.device == x.device):
        raise ValueError(f"tensors on different devices: {cols.device}, "
                         f"{vals.device}, {lens.device}, {x.device}")


def block_ell_spmv(cols, vals, lens, x):
    """y = A x for a BlockEllMatrix's tables; x must cover every column."""
    _check(cols, vals, lens, x)
    if x.device.type == "cpu":
        return block_ell_plain(cols, vals, x, lens)
    if x.device.type != "cuda":
        raise ValueError(f"no block-ELL kernel for device {x.device}")
    from .. import _build
    k, nb = cols.shape
    bs, n_pad = vals.shape[1], vals.shape[2]
    g, s = launch_shape(nb * bs, k, x.device)
    y = torch.empty(n_pad, dtype=torch.float32, device=x.device)
    rc = _build.lib().block_ell_spmv_launch(
        int(vals.dtype == torch.bfloat16), bs, cols.data_ptr(),
        vals.data_ptr(), lens.data_ptr(), k, nb * bs, n_pad, g, s,
        x.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "block_ell_spmv")
    block_ell_spmv.launches += 1
    return y


block_ell_spmv.launches = 0


def block_ell_tables(A: sp.csr_matrix, bs: int, n_pad: int):
    """Host tables (cols int32 (K, nb), vals fp32 (K, bs, n_pad), node row
    lengths int32 (nb,)) of a square-blocked CSR.  scipy's BSR conversion
    builds the node pattern and the dense blocks in one compiled pass
    (duplicates summed); the blocks of each node row are sorted by node
    column, so slot order follows the CSR's column order."""
    n = A.shape[0]
    if n > n_pad:
        raise ValueError(f"{n} rows do not fit n_pad {n_pad}")
    B = A.tocsr().tobsr(blocksize=(bs, bs))
    B.sort_indices()
    nb = n // bs
    deg = np.diff(B.indptr)
    K = max(int(deg.max()) if nb else 0, 1)
    row = np.repeat(np.arange(nb, dtype=np.int64), deg)
    slot = np.arange(B.indices.size, dtype=np.int64) - np.repeat(
        B.indptr[:-1].astype(np.int64), deg)
    cols = np.zeros((K, nb), dtype=np.int32)
    cols[slot, row] = B.indices
    # blocks[k, i, c, d] = A[bs*i + c, bs*cols[k, i] + d]
    blocks = np.zeros((K, nb, bs, bs), dtype=np.float32)
    blocks[slot, row] = B.data
    vals = np.zeros((K, bs, n_pad), dtype=np.float32)
    vals[:, :, :n] = blocks.transpose(0, 3, 1, 2).reshape(K, bs, n)
    return cols, vals, deg.astype(np.int32)


def csr_to_block_ell(A: sp.csr_matrix, bs: int, dtype=torch.float32,
                     n_pad: int | None = None, *,
                     device) -> BlockEllMatrix | None:
    """Pack a dof-interleaved CSR with bs dofs per node into the block
    layout (values rounded to fp32, then to `dtype`).  None when the kernel
    has no instance for bs or the matrix does not split into bs x bs
    blocks (the caller falls back to scalar ELL, as the JAX packer's None
    does)."""
    n, m = A.shape
    if bs not in BLOCK_SIZES or n % bs or m % bs:
        return None
    if n_pad is None:
        n_pad = _round_up(max(n, 1), 2048)
    cols, vals, lens = block_ell_tables(A, bs, n_pad)
    return BlockEllMatrix(
        cols=torch.from_numpy(cols).to(device),
        vals=torch.from_numpy(vals).to(device=device, dtype=dtype),
        lens=torch.from_numpy(lens).to(device), n_rows=n, n_cols=m)
