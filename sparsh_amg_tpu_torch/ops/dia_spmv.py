"""DIA SpMV and its fused tails: the Hopper port of the Pallas kernels in
``sparsh_amg_tpu/ops/pallas_spmv.py`` (``dia_spmv_pallas`` and ``_dia_fused``
behind ``dia_residual``, ``dia_dinv_residual``, ``dia_jacobi_sweep`` and
``dia_cheb_step``; ``dia_dinv_residual``'s r is the first output of
``dia_cheb_start`` here).  The kernel is ``csrc/dia_spmv.cu``.

``dia_cheb_start`` and ``dia_cheb_last`` are the port's own: the start
of a Chebyshev smooth (r and d = r / theta in one pass; from a zero x,
with no product) and its last step with the closing x + d' (one output),
so that a smooth on a DIA level runs no elementwise kernel between its
products.  ``dia_cheb_step`` takes x = None after a zero start (x is
not read, x' is d).

``dia_fused_boundary`` is the port's own: on a rank's row block
(``parallel/dist.py::DistDia``) it redoes a tail on the rows whose bands
reach the neighbours' entries, from the received halos, after the tail's
launch on the block alone (the JAX package corrects those rows with
plain slices).

Every wrapper takes the kernel's plain PyTorch version (shifted slices)
for tensors on the CPU, launches the CUDA kernel for tensors on the card,
and raises for anything else.  Each wrapper counts its kernel launches in
its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# A tail's code is its wrapper's index in WRAPPERS (csrc/dia_spmv.cu: a
# profiler's dia_tile<band type, tail, ...> maps back to the wrapper).
SPMV, RESIDUAL, JACOBI, CHEB, CHEB_START, CHEB_LAST = range(6)
# or'ed into a Chebyshev tail's code for the kernel: x is zero and not
# read (the start: no product), as x = None says to the wrappers
ZERO_START = 16
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
    az = A v (see csrc/dia_spmv.cu for the six tails).  A Chebyshev
    tail's zero start: x None (CHEB_START: v None, no product)."""
    az = None if v is None else dia_plain(bands, offsets, v)
    return _tail_plain(tail, az, v, b, dinv, x, s0, s1)


def _tail_plain(tail, az, v, b, dinv, x, s0, s1):
    if tail == SPMV:
        return az
    if tail == RESIDUAL:
        return b - az
    if tail == JACOBI:
        return x + s0 * dinv * (b - az)
    if tail == CHEB_START:              # v = x, s0 = theta
        r = dinv * b if az is None else dinv * (b - az)
        return r, r / s0
    x2 = v if x is None else x + v      # CHEB, CHEB_LAST: v = d, b = r
    r2 = b - dinv * az
    d2 = s0 * v + s1 * r2
    if tail == CHEB_LAST:
        return x2 + d2
    return x2, r2, d2


def boundary_rows(offsets: tuple, n_pad: int, lo: bool, hi: bool):
    """(lo_rows, hi_row): the rows of a rank's block whose bands reach past
    it, [0, lo_rows) into the left neighbour's rows (when `lo`, there is
    one) and [hi_row, n_pad) into the right one's (when `hi`)."""
    lo_rows = min(max(0, -min(offsets)), n_pad) if lo else 0
    hi_row = max(n_pad - max(0, max(offsets)), lo_rows) if hi else n_pad
    return lo_rows, hi_row


def dia_boundary_plain(tail, bands, offsets, v, left, right, outs, lo, hi,
                       b=None, dinv=None, x=None, s0=0.0, s1=0.0):
    """The plain version of dia_fused_boundary: dia_fused_plain's tail on
    the extended vector [left | v | right], on the boundary rows only,
    written into the `outs` the kernel writes (``_written``)."""
    n, h = v.shape[0], left.shape[0]
    ext = torch.cat([left, v, right])
    lo_rows, hi_row = boundary_rows(offsets, n, lo, hi)
    for r0, r1 in ((0, lo_rows), (hi_row, n)):
        if r0 == r1:
            continue
        az = torch.zeros(r1 - r0, dtype=torch.promote_types(bands.dtype,
                                                            v.dtype),
                         device=v.device)
        for d, off in enumerate(offsets):
            az = az + bands[d, r0:r1] * ext[h + off + r0: h + off + r1]
        rows = lambda t: None if t is None else t[r0:r1]
        got = _tail_plain(tail, az, v[r0:r1], rows(b), rows(dinv), rows(x),
                          s0, s1)
        got = got if isinstance(got, tuple) else (got,)
        for i in _written(_code(tail, v, x), len(outs)):
            outs[i][r0:r1] = got[i]


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


def _code(tail, v, x):
    """The kernel's code for `tail`: ZERO_START or'ed into a Chebyshev
    tail whose x is None (CHEB_START multiplies x: its v)."""
    zero = v is None if tail == CHEB_START else \
        tail in (CHEB, CHEB_LAST) and x is None
    return tail | ZERO_START if zero else tail


def _written(code, n_out):
    """The outputs a launch of `code` writes, by index: a zero-start CHEB
    writes no x' (its wrapper returns d)."""
    return range(int(code == CHEB | ZERO_START), n_out)


def _launch(tail, bands, offsets, v, b, dinv, x, s0, s1, n_out):
    from .. import _build
    _check_aligned([t for t in (bands, v, b, dinv, x) if t is not None])
    code, like = _code(tail, v, x), b if v is None else v
    outs = [None] * n_out
    for i in _written(code, n_out):
        outs[i] = torch.empty_like(like)
    ptr = lambda t: None if t is None else t.data_ptr()
    ys = [ptr(o) for o in outs] + [None] * (3 - n_out)
    rc = _build.lib().dia_fused_launch(
        int(bands.dtype == torch.bfloat16), code, bands.data_ptr(),
        bands.shape[0], _c_offsets(offsets), bands.shape[1], ptr(v), ptr(b),
        ptr(dinv), ptr(x), float(s0), float(s1), *ys,
        torch.cuda.current_stream(like.device).cuda_stream)
    _build.check(rc, "dia_fused")
    return outs


def _run(wrapper, tail, bands, offsets, v, b=None, dinv=None, x=None,
         s0=0.0, s1=0.0, n_out=1):
    vecs = [t for t in (v, b, dinv, x) if t is not None]
    _check(bands, offsets, vecs)
    dev = vecs[0].device
    if dev.type == "cpu":
        return dia_fused_plain(tail, bands, offsets, v, b, dinv, x, s0, s1)
    if dev.type != "cuda":
        raise ValueError(f"no DIA kernel for device {dev}")
    outs = _launch(tail, bands, offsets, v, b, dinv, x, s0, s1, n_out)
    wrapper.launches += 1
    return outs[0] if n_out == 1 else tuple(outs)


def dia_spmv(bands, x, offsets: tuple):
    """y = A x.  bands (D, n_pad), x (n_pad,)."""
    return _run(dia_spmv, SPMV, bands, offsets, x)


def dia_residual(bands, x, b, offsets: tuple):
    """r = b - A x."""
    return _run(dia_residual, RESIDUAL, bands, offsets, x, b=b)


def dia_jacobi_sweep(bands, x, b, dinv, omega: float, offsets: tuple):
    """x' = x + omega * dinv * (b - A x): one weighted-Jacobi sweep."""
    return _run(dia_jacobi_sweep, JACOBI, bands, offsets, x, b=b, dinv=dinv,
                x=x, s0=omega)


def dia_cheb_start(bands, x, b, dinv, theta: float, offsets: tuple):
    """The start of a Chebyshev smooth: r = dinv * (b - A x) and d = r /
    theta.  x None: a zero start, r = dinv * b (no product).  Returns
    (r, d)."""
    return _run(dia_cheb_start, CHEB_START, bands, offsets, x, b=b,
                dinv=dinv, s0=theta, n_out=2)


def dia_cheb_step(bands, x, d, r, dinv, a: float, c: float, offsets: tuple):
    """One Chebyshev iteration: x' = x + d; r' = r - dinv * (A d);
    d' = a*d + c*r'.  Returns (x', r', d').  x None: x is zero and not
    read, and x' is d itself."""
    x2, r2, d2 = _run(dia_cheb_step, CHEB, bands, offsets, d, b=r,
                      dinv=dinv, x=x, s0=a, s1=c, n_out=3)
    return d if x is None else x2, r2, d2


def dia_cheb_last(bands, x, d, r, dinv, a: float, c: float, offsets: tuple):
    """The last Chebyshev iteration with the smooth's closing update:
    (x + d) + (a*d + c*r'), r' = r - dinv * (A d).  x None: x is zero
    and not read, d + (a*d + c*r')."""
    return _run(dia_cheb_last, CHEB_LAST, bands, offsets, d, b=r, dinv=dinv,
                x=x, s0=a, s1=c)


def dia_fused_boundary(tail, bands, offsets, v, left, right, outs, lo, hi,
                       b=None, dinv=None, x=None, s0=0.0, s1=0.0):
    """The boundary launch of a rank block (parallel/dist.py::DistDia):
    `outs` hold what a launch of `tail` on the block alone wrote (v = 0
    outside it); this redoes the tail on the rows whose bands reach a
    neighbour's entries (``boundary_rows``), v read from [left | v |
    right] (h entries each side, h >= every |offset|), in place.  `lo`,
    `hi`: the block has a left / right neighbour.  Both ends take one
    launch; none where neither end has rows to redo.  A Chebyshev tail
    takes x None as its wrapper does; CHEB then leaves x' (d itself)
    alone, and CHEB_START, which has no product then, has no boundary."""
    if tail == CHEB_START and v is None:
        raise ValueError("a zero-start CHEB_START has no product to redo")
    _check(bands, offsets, [t for t in (v, b, dinv, x, *outs)
                            if t is not None])
    h = left.shape[0]
    for t in (left, right):
        if t.shape != (h,) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != v.device:
            raise ValueError(f"halos must be contiguous fp32 ({h},) on "
                             f"{v.device}, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    if max(abs(o) for o in offsets) > h:
        raise ValueError(f"offsets {offsets} reach past a halo of {h}")
    if boundary_rows(offsets, v.shape[0], lo, hi) == (0, v.shape[0]):
        return
    if v.device.type == "cpu":
        dia_boundary_plain(tail, bands, offsets, v, left, right, outs, lo,
                           hi, b, dinv, x, s0, s1)
        return
    if v.device.type != "cuda":
        raise ValueError(f"no DIA kernel for device {v.device}")
    from .. import _build
    _check_aligned([t for t in (bands, v, b, dinv, x, *outs)
                    if t is not None])
    ptr = lambda t: None if t is None else t.data_ptr()
    ys = [ptr(o) for o in outs] + [None] * (3 - len(outs))
    rc = _build.lib().dia_fused_boundary_launch(
        int(bands.dtype == torch.bfloat16), _code(tail, v, x),
        bands.data_ptr(), bands.shape[0], _c_offsets(offsets),
        bands.shape[1], ptr(v), ptr(left), ptr(right), h, int(lo), int(hi),
        ptr(b), ptr(dinv), ptr(x), float(s0), float(s1), *ys,
        torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(rc, "dia_fused_boundary")
    dia_fused_boundary.launches += 1


WRAPPERS = (dia_spmv, dia_residual, dia_jacobi_sweep, dia_cheb_step,
            dia_cheb_start, dia_cheb_last, dia_fused_boundary)
for _w in WRAPPERS:
    _w.launches = 0
