"""Irregular SpMV on sliced ELL with T lanes per row: the Hopper port of the
Pallas window-gather kernel ``sparsh_amg_tpu/ops/gell.py::
gell_gather_pallas`` and its row reduction.  The kernel is
``csrc/ell_spmv.cu``; the layout is ``ops/formats.py::EllMatrix``, built by
``pack_ell``.

``ell_residual`` (b - A x), ``ell_jacobi_sweep`` (x + omega dinv (b -
A x)) and ``ell_spmv_add`` (x + A e, the prolongation's correction) are
the port's own: the same kernel with a tail applied to each row's sum
before it is stored, so that a Jacobi sweep, a residual or a correction
on an ELL level is one launch, with the bits of the plain composition.

Every wrapper takes the plain PyTorch version (a gather, a product, a
sum per row and a scatter by ``perm``, then the tail) for tensors on the
CPU, launches the CUDA kernel for tensors on the card, and raises for
anything else.  Each wrapper counts its kernel launches in its
``launches`` attribute.  Rows of one lane and one slot per load (T = V =
1) may be split over lanes and clusters, as ``split_rows.launch_shape``
says.
"""
from __future__ import annotations

import torch

from .split_rows import launch_shape

# A tail's code is its wrapper's index in WRAPPERS (csrc/ell_spmv.cu)
SPMV, RESIDUAL, JACOBI, ADD = range(4)
VAL_DTYPES = (torch.float32, torch.bfloat16)
LANES = (1, 2, 4, 8, 16, 32)
VECS = (1, 4)


def _padded_slices(M, table: torch.Tensor, fill) -> torch.Tensor:
    """`table` (one value per stored slot) with every slice padded to the
    widest one's steps, as (n_slices, steps, C, T, V); padding `fill`
    (for ``ell_unpack``)."""
    T, V = M.lanes, M.vec
    C, steps = 32 // T, -(-M.k // (T * V))
    chunk = steps * 32 * V
    dev = table.device
    shift = torch.arange(M.n_slices, device=dev) * chunk \
        - M.slice_off.long()
    dest = torch.arange(table.shape[0], device=dev) + torch.repeat_interleave(
        shift, M.slice_width.long() * C, output_size=table.shape[0])
    out = torch.full((M.n_slices * chunk,), fill, dtype=table.dtype,
                     device=dev)
    out[dest] = table
    return out.view(M.n_slices, steps, C, T, V)


def ell_plain(M, x: torch.Tensor) -> torch.Tensor:
    """y = A x in the promoted dtype of the values and x (fp32 for bf16
    values): every stored slot's product (padding adds 0 * x[col]), summed
    per row (a step's T * V slots, then the slice's steps in order) and
    scattered to y by ``perm``."""
    C, TV = 32 // M.lanes, M.lanes * M.vec
    prod = M.vals * torch.index_select(x, 0, M.cols)
    steps = prod.view(-1, C, TV).sum(dim=-1)     # (every slice's steps, C)
    # unsafe: no host check of the lengths (the packer's), so the sum
    # captures in a CUDA graph (the fp64 residual inside the pass graphs)
    rows = torch.segment_reduce(steps, "sum", axis=0,
                                lengths=M.slice_width.long() // TV,
                                unsafe=True)
    rows = rows.reshape(-1)[: M.n_pad]
    if not M.perm.numel():                  # rows in their own order
        return rows
    y = torch.empty_like(rows)
    y[M.perm.long()] = rows
    return y


def ell_unpack(M, k: int | None = None, fill: int = 0) -> tuple:
    """The ELL-T tables of a packed matrix in its original row order:
    (cols (k, n_pad) int32, vals (k, n_pad), lens (n_pad,) int32), slots
    past each row's length val 0 and col `fill`; k defaults to the
    longest row."""
    k = M.k if k is None else k
    if k < M.k:
        raise ValueError(f"k {k} is below the longest row {M.k}")
    perm = M.perm.long() if M.perm.numel() \
        else torch.arange(M.n_pad, device=M.perm.device)

    def table(t, pad):
        d = _padded_slices(M, t, pad).permute(0, 2, 1, 3, 4)
        d = d.reshape(d.shape[0] * d.shape[1], -1)[: M.n_pad]
        out = torch.full((M.n_pad, max(k, d.shape[1])), pad, dtype=t.dtype,
                         device=t.device)
        out[perm, : d.shape[1]] = d
        return out[:, :k]

    lens = torch.empty_like(M.lens)
    lens[perm] = M.lens
    past = torch.arange(k, device=lens.device)[None, :] >= lens[:, None]
    cols = table(M.cols, fill).masked_fill(past, fill)
    vals = table(M.vals, 0).masked_fill(past, 0)
    return cols.T.contiguous(), vals.T.contiguous(), lens


def _check(M, x):
    n_slices, T, V = M.n_slices, M.lanes, M.vec
    if T not in LANES or V not in VECS:
        raise ValueError(f"no ELL kernel for T={T} lanes, V={V}")
    for name, t, n in (("slice_off", M.slice_off, n_slices),
                       ("slice_width", M.slice_width, n_slices),
                       ("perm", M.perm, M.n_pad if M.sigma > 1 else 0),
                       ("lens", M.lens, M.n_pad),
                       ("cols", M.cols, M.vals.shape[0])):
        if t.shape != (n,) or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 ({n},) "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    if M.vals.dim() != 1 or M.vals.dtype not in VAL_DTYPES \
            or not M.vals.is_contiguous():
        raise ValueError(f"vals must be a contiguous 1-D fp32/bf16 tensor, "
                         f"got {tuple(M.vals.shape)} {M.vals.dtype}")
    if n_slices != -(-M.n_pad // (32 // T)) \
            or not 0 <= M.n_rows <= M.n_pad:
        raise ValueError(f"{n_slices} slices of {32 // T} rows do not hold "
                         f"{M.n_pad} rows ({M.n_rows} real)")
    if (M.cols.data_ptr() | M.vals.data_ptr()) % (4 * V):
        raise ValueError(f"cols and vals must be aligned to {4 * V} bytes "
                         f"for V={V} slots per load")
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 1-D fp32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    devs = {t.device for t in (M.cols, M.vals, M.slice_off, M.slice_width,
                               M.perm, M.lens, x)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")


def split_shape(M, device) -> tuple:
    """(G, S) of the split-row launch for a packed matrix on a CUDA
    device: ``split_rows.launch_shape`` for T = V = 1, else (1, 1)."""
    if M.lanes == M.vec == 1:
        return launch_shape(M.n_rows, M.k, device)
    return 1, 1


def _tail_plain(tail, az, b=None, dinv=None, x=None, s0=1.0):
    """A tail on the row sums az, as the plain composition computes it."""
    if tail == SPMV:
        return az
    if tail == RESIDUAL:
        return b - az
    if tail == JACOBI:
        return x + s0 * dinv * (b - az)
    return x + az


def fusable(M, v: torch.Tensor, *vecs) -> bool:
    """Whether a fused launch takes v (the product's source) and `vecs`
    (the tail's vectors, one entry a row of y): fp32 throughout, the
    vectors contiguous (n_pad,) tensors on v's device."""
    return v.dtype == torch.float32 and all(
        t.dtype == torch.float32 and t.shape == (M.n_pad,)
        and t.is_contiguous() and t.device == v.device for t in vecs)


def _launch(M, tail, v, b=None, dinv=None, x=None, s0=1.0):
    _check(M, v)
    vecs = [t for t in (b, dinv, x) if t is not None]
    if not fusable(M, v, *vecs):
        raise ValueError(f"the tail's vectors must be contiguous fp32 "
                         f"({M.n_pad},) tensors on {v.device}")
    if v.device.type == "cpu":
        return _tail_plain(tail, ell_plain(M, v), b, dinv, x, s0)
    if v.device.type != "cuda":
        raise ValueError(f"no ELL kernel for device {v.device}")
    from .. import _build
    g, s = split_shape(M, v.device)
    y = torch.empty(M.n_pad, dtype=torch.float32, device=v.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _build.lib().ell_fused_launch(
        int(M.vals.dtype == torch.bfloat16), M.lanes, M.vec,
        M.cols.data_ptr(), M.vals.data_ptr(), M.slice_off.data_ptr(),
        M.slice_width.data_ptr(), M.perm.data_ptr() if M.sigma > 1 else 0,
        M.lens.data_ptr(),
        M.n_slices, M.n_rows, M.n_pad, g, s, v.data_ptr(), y.data_ptr(),
        tail, ptr(b), ptr(dinv), ptr(x), s0,
        torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(rc, WRAPPERS[tail].__name__)
    WRAPPERS[tail].launches += 1
    return y


def ell_spmv(M, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a packed ELL matrix (``EllMatrix``); x must cover every
    column index.  y has n_pad entries, 0 on padding rows."""
    return _launch(M, SPMV, x)


def ell_residual(M, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b - A x in one launch."""
    return _launch(M, RESIDUAL, x, b=b)


def ell_jacobi_sweep(M, x: torch.Tensor, b: torch.Tensor,
                     dinv: torch.Tensor, omega: float) -> torch.Tensor:
    """x + omega dinv (b - A x) in one launch (omega dinv rounded to fp32
    first, as the composition does)."""
    return _launch(M, JACOBI, x, b=b, dinv=dinv, x=x, s0=omega)


def ell_spmv_add(M, e: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x + A e in one launch (the prolongation's correction; e must cover
    every column index)."""
    return _launch(M, ADD, e, x=x)


WRAPPERS = (ell_spmv, ell_residual, ell_jacobi_sweep, ell_spmv_add)
for _w in WRAPPERS:
    _w.launches = 0
