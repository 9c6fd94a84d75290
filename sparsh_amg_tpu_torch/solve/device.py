"""Frozen device hierarchy (the port of ``sparsh_amg_tpu/solve/device.py``).

Each level carries its operator in a DIA/ELL-T/dense layout, the
inverse-diagonal vectors for the smoothers, a lambda_max estimate of
D^-1 A for Chebyshev, the prolongator/restrictor, on the coarsest level a
dense fp32 inverse, and for two-stage Gauss-Seidel the strict triangles
of A in their own layouts.  ``lam_max`` is a Python float, read once at
freeze time, so the Chebyshev scalars reach the kernels as plain float
arguments with no device sync per call.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from .._native import csr_arrays, get_lib
from ..ops.block_ell import BlockEllMatrix, csr_to_block_ell
from ..ops.formats import (DenseMatrix, DiaMatrix, EllMatrix, _round_up,
                           _upload, csr_to_dense, csr_to_device, csr_to_ell,
                           pack_ell)
from ..params import AMGParams
from ..setup.hierarchy import Hierarchy
from ..utils import trace


@dataclasses.dataclass(frozen=True)
class DeviceLevel:
    A: object                 # DiaMatrix | BlockEllMatrix | EllMatrix |
                              # DenseMatrix
    dinv: torch.Tensor        # (n_pad,) 1/a_ii, 0 in padding
    l1_dinv: torch.Tensor | None  # (n_pad,) 1/(a_ii + sum|offdiag|)
    lam_max: float            # upper bound on lambda_max(D^-1 A)
    P: object | None          # (n_pad x nc_pad), None on the coarsest level
    R: object | None          # (nc_pad x n_pad), None on the coarsest level
    coarse_inv: torch.Tensor | None  # dense inverse on the coarsest level
    n: int = 0                # logical size
    coarse_sweeps: int = 16   # l1-Jacobi sweeps when coarse_inv is None
    L: object | None = None   # strict lower triangle (two-stage GS)
    U: object | None = None   # strict upper triangle

    @property
    def n_pad(self) -> int:
        return self.dinv.shape[0]

    def coarse_solve(self, b: torch.Tensor) -> torch.Tensor:
        """The dense inverse (stored tight, 256-padded) as one fp32 matvec;
        without one, coarse_sweeps of l1-Jacobi."""
        if self.coarse_inv is None:
            from .smoothers import l1_jacobi
            return l1_jacobi(self, b, torch.zeros_like(b),
                             sweeps=self.coarse_sweeps, zero_start=True)
        r = self.coarse_inv.shape[-1]
        y = torch.mv(self.coarse_inv, b[:r])
        if b.shape[0] > r:
            y = F.pad(y, (0, b.shape[0] - r))
        return y


@dataclasses.dataclass(frozen=True)
class DeviceHierarchy:
    levels: tuple  # tuple[DeviceLevel, ...]

    @property
    def n_levels(self) -> int:
        return len(self.levels)


# ---------------------------------------------------------------------------
# Host helpers, copied from sparsh_amg_tpu/solve/device.py (abs_row_sum,
# lambda_max_estimate, _lambda_max_dinv_a, dense_inverse): they are numpy
# and scipy only, but their module imports jax, which the GPU machine lacks.
# ---------------------------------------------------------------------------

def abs_row_sum(A: sp.csr_matrix) -> np.ndarray:
    """Row sums of |a_ij| without np.abs(A)'s full-CSR copy."""
    lib = get_lib()
    if lib is not None and A.nnz >= (1 << 16):
        indptr, _, data = csr_arrays(A)
        out = np.empty(A.shape[0], dtype=np.float64)
        lib.abs_row_sum(A.shape[0], indptr, data, out)
        return out
    return np.asarray(np.abs(A).sum(axis=1)).ravel()


# above this size the power iteration costs host seconds; the free
# Gershgorin bound (a guaranteed upper bound, tight for stencils) takes over
_POWER_MAX_N = 1 << 17


def lambda_max_estimate(A: sp.csr_matrix, d: np.ndarray,
                        absrow: np.ndarray, method: str = "hybrid") -> float:
    """Upper bound on lambda_max(D^-1 A) for the Chebyshev window:
    Gershgorin, refined by min(power, Gershgorin) on levels up to
    _POWER_MAX_N rows in "hybrid" mode.  Undershoot is the dangerous
    direction (a window missing the top of the spectrum)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = np.where(d != 0, absrow / np.abs(d), 0.0)
    g = float(ratios.max()) if ratios.size else 1.0
    if g <= 0.0 or not np.isfinite(g):
        g = 1.0
    if method == "gershgorin":
        return g
    if method == "power":
        return _lambda_max_dinv_a(A)
    if A.shape[0] <= _POWER_MAX_N:
        return min(_lambda_max_dinv_a(A), g)
    return g


def _lambda_max_dinv_a(A: sp.csr_matrix, iters: int = 20,
                       seed: int = 0) -> float:
    """Host power iteration for lambda_max(D^-1 A).  Do not reduce iters:
    at 10 the estimate undershoots and the Chebyshev window misses the
    top of the spectrum."""
    d = A.diagonal()
    dinv = np.where(d != 0, 1.0 / d, 0.0)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(A.shape[0])
    v /= np.linalg.norm(v) + 1e-30
    lam = 1.0
    for _ in range(iters):
        w = dinv * (A @ v)
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 1.0
        v = w / lam
    return lam * 1.05  # small safety margin


def dense_inverse(A: sp.csr_matrix, method: str = "lu") -> np.ndarray:
    """Explicit coarse inverse via the configured host factorization."""
    import scipy.linalg as sla
    Ad = A.toarray()
    n = Ad.shape[0]
    if method == "cholesky":
        c_and_low = sla.cho_factor(Ad)
        return sla.cho_solve(c_and_low, np.eye(n))
    if method == "lu":
        return sla.lu_solve(sla.lu_factor(Ad), np.eye(n))
    raise ValueError(f"unknown coarse_solver {method!r}")


# ---------------------------------------------------------------------------

def _dia_diag_stats(bands: torch.Tensor, diag_idx: int):
    """Smoother diagonals + Gershgorin bound from fp32 DIA bands, on the
    device (padding rows have all-zero bands -> dinv/l1_dinv 0 there)."""
    d = bands[diag_idx]
    absrow = bands.abs().sum(dim=0)
    nz = d != 0
    dinv = torch.where(nz, 1.0 / d, 0.0)
    l1 = d + (absrow - d.abs())
    l1_dinv = torch.where(l1 != 0, 1.0 / l1, 0.0)
    lam = torch.where(nz, absrow / d.abs(), 0.0).max().clamp_min(1e-30)
    return dinv, l1_dinv, lam


def _torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _f32(v: float) -> float:
    """The value as stored in fp32 (the JAX package keeps lam_max there)."""
    return float(np.float32(v))


def to_device(hier: Hierarchy, params: AMGParams | None = None, dtype=None,
              fine_hi=None, *, device) -> DeviceHierarchy:
    """Freeze a host hierarchy onto `device`.

    fine_hi: optionally the fp32 fine-level DiaMatrix already on the device
    (the Krylov operator).  When its layout matches what csr_to_device
    would build, the fine band_dtype operator is derived by casting its
    bands on the device instead of uploading the matrix again.  Traced as
    one span ``freeze.level`` a level."""
    params = params or hier.params
    dtype = _torch_dtype(dtype or params.dtype)
    bdtype = _torch_dtype(params.band_dtype)
    levels = []
    for li in range(len(hier.levels)):
        with trace.span("freeze.level", level=li):
            levels.append(_freeze_level(hier, li, params, dtype, bdtype,
                                        fine_hi, device))
    return DeviceHierarchy(levels=tuple(levels))


def _freeze_level(hier: Hierarchy, li: int, params: AMGParams, dtype,
                  bdtype, fine_hi, device) -> DeviceLevel:
    lev = hier.levels[li]
    A = lev.A
    n = A.shape[0]
    is_coarsest = li == len(hier.levels) - 1 or lev.P is None
    fine_reuse = (li == 0 and isinstance(fine_hi, DiaMatrix)
                  and fine_hi.n_rows == n and not is_coarsest
                  and n > params.dense_size
                  and fine_hi.n_pad == _round_up(max(n, 1), 2048))
    bs = getattr(lev, "bs", 1)
    dev_A = None
    if fine_reuse:
        dev_A = fine_hi if fine_hi.bands.dtype == bdtype else \
            dataclasses.replace(fine_hi, bands=fine_hi.bands.to(bdtype))
    elif bs > 1 and n > params.dense_size:
        # systems level (bs dofs per node): bs x bs blocks over the
        # node pattern, or None and scalar ELL-T below
        dev_A = csr_to_block_ell(A, bs, bdtype,
                                 n_pad=_round_up(max(n, 1), 2048),
                                 device=device)
    if dev_A is None:
        dev_A = csr_to_device(A, dtype=bdtype,
                              prefer_dia=params.prefer_dia,
                              dia_max_bands=params.dia_max_bands,
                              dense_size=params.dense_size,
                              pad_multiple=2048, device=device)
    n_pad = dev_A.n_pad
    # l1_dinv only feeds the l1-Jacobi smoother and the no-inverse
    # coarse fallback
    need_l1 = params.smoother in ("l1jacobi", "gs2") or is_coarsest
    if (fine_reuse and 0 in fine_hi.offsets and n > _POWER_MAX_N
            and params.lambda_max != "power" and dtype == torch.float32):
        # smoother diagonals + Gershgorin bound from the uploaded fp32
        # bands; above _POWER_MAX_N the hybrid estimate is Gershgorin
        with trace.span("freeze.lambda_max"):
            dinv_t, l1_dinv_t, lam_t = _dia_diag_stats(
                fine_hi.bands, fine_hi.offsets.index(0))
            lam = lam_t.item()
        if not need_l1:
            l1_dinv_t = None
    else:
        d = A.diagonal()
        dinv = np.zeros(n_pad)
        dinv[:n] = np.where(d != 0, 1.0 / d, 0.0)
        absrow = abs_row_sum(A)
        with trace.span("freeze.lambda_max"):
            lam = lambda_max_estimate(A, d, absrow, params.lambda_max) \
                if not is_coarsest or n > 1 else 1.0
        dinv_t = _upload(dinv, device, dtype)
        l1_dinv_t = None
        if need_l1:
            l1d = d + (absrow - np.abs(d))
            l1_dinv = np.zeros(n_pad)
            l1_dinv[:n] = np.where(l1d != 0, 1.0 / l1d, 0.0)
            l1_dinv_t = _upload(l1_dinv, device, dtype)

    P = R = coarse_inv = None
    if not is_coarsest:
        nc = lev.P.shape[1]
        if max(n, nc) <= params.dense_size:
            P = csr_to_dense(lev.P, dtype=bdtype, pad_multiple=2048,
                             device=device)
            R = csr_to_dense(lev.R, dtype=bdtype, pad_multiple=2048,
                             device=device)
        else:
            P = csr_to_ell(lev.P.tocsr(), dtype=bdtype, pad_multiple=2048,
                           device=device)
            R = csr_to_ell(lev.R.tocsr(), dtype=bdtype, pad_multiple=2048,
                           device=device)
    elif n <= params.coarse_inv_max and params.coarse_solver != "smooth":
        with trace.span("freeze.coarse_inverse"):
            r = min(_round_up(max(n, 1), 256), n_pad)
            dense = np.zeros((r, r), dtype=np.float32)
            dense[:n, :n] = dense_inverse(A, params.coarse_solver)
            # fp32 always, not band_dtype: the coarse solve anchors the
            # cycle
            coarse_inv = _upload(dense, device, dtype)

    L = U = None
    if params.smoother == "gs2" and coarse_inv is None:
        # each triangle in the layout csr_to_device picks for it: DIA
        # tables with one-sided offsets on stencil levels
        conv = lambda T: csr_to_device(
            T.tocsr(), dtype=bdtype, prefer_dia=params.prefer_dia,
            dia_max_bands=params.dia_max_bands,
            dense_size=params.dense_size, pad_multiple=2048,
            device=device)
        L = conv(sp.tril(A, -1))
        U = conv(sp.triu(A, 1))

    return DeviceLevel(
        A=dev_A, dinv=dinv_t, l1_dinv=l1_dinv_t, lam_max=_f32(lam),
        P=P, R=R, coarse_inv=coarse_inv, n=n,
        coarse_sweeps=params.coarse_smooth_sweeps, L=L, U=U)


# ---------------------------------------------------------------------------
# Carry-over from a JAX DeviceHierarchy (tests run both cycles on identical
# frozen data).  Duck-typed on the JAX layouts' class names and fields, so
# this module imports no jax.  The TPU layouts (GellMatrix, SplitGell,
# BlockGellMatrix) are decoded in numpy into a host CSR of the same stored
# values and packed with the port's own packers.
# ---------------------------------------------------------------------------

_LANE, _WIN = 128, 1024       # sparsh_amg_tpu/ops/gell.py LANE and WIN


def _tensor(a, device) -> torch.Tensor:
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(arr).to(device)


def _val_dtype(a) -> torch.dtype:
    return torch.bfloat16 if np.asarray(a).dtype.name == "bfloat16" \
        else torch.float32


def _gell_columns(M) -> np.ndarray:
    """Absolute column of every stream position of a GELL-style table
    (wwords, packed, s, wmode), as _decode_windows_jnp and
    _gell_gather_xla decode it."""
    packed = np.asarray(M.packed).astype(np.int64)
    w = np.asarray(M.wwords).astype(np.int64)
    if M.wmode == 32:
        windows = w[:, : M.s]
    else:
        s = np.arange(M.s)
        windows = (w[:, s // 2] >> (16 * (s % 2))) & 0xFFFF
    sel = (packed >> 10).reshape(packed.shape[0], -1)
    base = np.take_along_axis(windows, sel, axis=1).reshape(packed.shape)
    return (base * _WIN + ((packed >> 7) & 7) * _LANE
            + (packed & 127)).reshape(-1)


def _stream_csr(rows, cols, vals, shape) -> sp.csr_matrix:
    """CSR of the stored nonzeros of a stream (padding slots hold 0)."""
    keep = vals != 0
    return sp.csr_matrix((vals[keep].astype(np.float64),
                          (rows[keep], cols[keep])), shape=shape)


def _gell_csr(M) -> sp.csr_matrix:
    """Host CSR of a JAX GellMatrix (row-major stream of k slots per row)
    or SplitGell (comb @ part)."""
    if type(M).__name__ == "SplitGell":
        return (_gell_csr(M.comb) @ _gell_csr(M.part)).tocsr()
    cols = _gell_columns(M)
    vals = np.asarray(M.vals).astype(np.float32).reshape(-1)
    return _stream_csr(np.arange(cols.size) // M.k, cols, vals,
                       (M.n_rows, M.n_cols))


def _block_gell_csr(M) -> sp.csr_matrix:
    """Host dof CSR of a JAX BlockGellMatrix: plane c*bs+d of bvals holds
    A[c, d] of the block at (node row p // k, node col of position p)."""
    bs = M.bs
    node_cols = _gell_columns(M)
    node_rows = np.arange(node_cols.size) // M.k
    bv = np.asarray(M.bvals).astype(np.float32).reshape(bs * bs, -1)
    rows, cols, vals = [], [], []
    for c in range(bs):
        for d in range(bs):
            rows.append(bs * node_rows + c)
            cols.append(bs * node_cols + d)
            vals.append(bv[c * bs + d])
    return _stream_csr(np.concatenate(rows), np.concatenate(cols),
                       np.concatenate(vals), (M.n_rows, M.n_cols))


def _ell_lengths(vals) -> np.ndarray:
    """Row lengths of an ELL-T table (K, n_pad) whose padding slots hold 0:
    the last nonzero slot of each row + 1, 0 for a row with none."""
    nz = np.asarray(vals).astype(np.float32) != 0
    last = nz.shape[0] - np.argmax(nz[::-1], axis=0)
    return np.where(nz.any(axis=0), last, 0).astype(np.int32)


def _layout_from_jax(M, device):
    if M is None:
        return None
    kind = type(M).__name__
    if kind == "DiaMatrix":
        return DiaMatrix(_tensor(M.bands, device), tuple(M.offsets),
                         M.n_rows, M.n_cols)
    if kind == "EllMatrix":
        vals = np.asarray(M.vals)
        return pack_ell(np.asarray(M.cols), vals.astype(np.float32),
                        _ell_lengths(vals), M.n_rows, M.n_cols,
                        _val_dtype(vals), device=device)
    if kind == "DenseMatrix":
        return DenseMatrix(_tensor(M.mat, device), M.n_rows, M.n_cols,
                           M.out_pad)
    if kind in ("GellMatrix", "SplitGell"):
        vals = M.part.vals if kind == "SplitGell" else M.vals
        E = csr_to_ell(_gell_csr(M), _val_dtype(vals), pad_multiple=2048,
                       device=device)
        if E.n_pad != M.n_pad:
            raise ValueError(f"{kind} n_pad {M.n_pad} is not the level "
                             f"padding {E.n_pad}")
        return E
    if kind == "BlockGellMatrix":
        B = csr_to_block_ell(_block_gell_csr(M), M.bs, _val_dtype(M.bvals),
                             n_pad=M.n_pad, device=device)
        if B is None:
            raise ValueError(f"no block-ELL kernel for block size {M.bs}")
        return B
    raise TypeError(f"no port of the {kind} layout")


def hierarchy_from_jax(dev, *, device) -> DeviceHierarchy:
    """Build the port's DeviceHierarchy from a JAX one: the same dinv,
    lam_max, bands, ELL tables, coarse inverse and GS triangles."""
    levels = []
    for lev in dev.levels:
        levels.append(DeviceLevel(
            A=_layout_from_jax(lev.A, device),
            dinv=_tensor(lev.dinv, device),
            l1_dinv=None if lev.l1_dinv is None
            else _tensor(lev.l1_dinv, device),
            lam_max=float(np.asarray(lev.lam_max)),
            P=_layout_from_jax(lev.P, device),
            R=_layout_from_jax(lev.R, device),
            coarse_inv=None if lev.coarse_inv is None
            else _tensor(lev.coarse_inv, device),
            n=lev.n, coarse_sweeps=lev.coarse_sweeps,
            L=_layout_from_jax(getattr(lev, "L", None), device),
            U=_layout_from_jax(getattr(lev, "U", None), device)))
    return DeviceHierarchy(levels=tuple(levels))
