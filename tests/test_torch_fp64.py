"""The port's fp64 refinement operator and BLAS-1 against the JAX
package's df64 operator (``residual_df64``) and df64 dot.

The port's fp64 entries are exactly the JAX pair's hi + lo, so the two
residuals agree to df64 accuracy: 1e-12 of ||b||."""
import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch

from sparsh_amg_tpu.models.poisson import poisson2d, poisson3d
from sparsh_amg_tpu.ops import df64
from sparsh_amg_tpu.ops.df64_ops import csr_to_df64, residual_df64
from sparsh_amg_tpu_torch.ops import blas
from sparsh_amg_tpu_torch.ops.ell_spmv import ell_unpack
from sparsh_amg_tpu_torch.ops.formats import DiaMatrix, EllMatrix
from sparsh_amg_tpu_torch.ops.fp64 import (csr_to_fp64, residual64, spmv64,
                                          to_fp32)


def _inexact(A):
    A = A.tocsr().copy()
    A.data = A.data * np.pi / 3          # entries not exact in fp32
    return A


def _irregular(n=500, seed=5):
    """Square, symmetric, too many diagonals for DIA: the ELL branch."""
    M = sp.random(n, n, density=0.01, random_state=seed, format="csr")
    M = M + M.T
    return (M + sp.diags(np.asarray(abs(M).sum(axis=1)).ravel() + 1.0)
            ).tocsr()


MATRICES = {"poisson2d(24) exact": lambda: poisson2d(24).tocsr(),
            "poisson3d(7) inexact": lambda: _inexact(poisson3d(7)),
            "irregular 500 (ELL)": _irregular}


@pytest.mark.parametrize("mat", MATRICES)
@pytest.mark.parametrize("rhs", ["consistent", "random"])
def test_residual64_matches_residual_df64(mat, rhs):
    A = MATRICES[mat]()
    n = A.shape[0]
    rng = np.random.default_rng(2)
    x64 = rng.standard_normal(n)
    b64 = A @ x64 if rhs == "consistent" else rng.standard_normal(n)
    A64 = csr_to_fp64(A, device="cpu")
    Adf = csr_to_df64(A)
    assert isinstance(A64, DiaMatrix) == (mat != "irregular 500 (ELL)")
    n_pad = A64.n_pad
    assert n_pad == Adf.A_hi.n_pad
    xp, bp = np.pad(x64, (0, n_pad - n)), np.pad(b64, (0, n_pad - n))
    r = residual64(A64, torch.from_numpy(bp), torch.from_numpy(xp)).numpy()
    xh, xl = df64.from_f64_np(xp)
    bh, bl = df64.from_f64_np(bp)
    rh, rl = residual_df64(Adf, jnp.asarray(bh), jnp.asarray(bl),
                           jnp.asarray(xh), jnp.asarray(xl))
    want = df64.to_f64_np(np.asarray(rh), np.asarray(rl))
    assert np.abs(r - want).max() <= 1e-12 * np.linalg.norm(b64)
    # and the port's residual is the fp64 residual of the hi+lo entries
    assert np.abs(r[:n] - (b64 - A @ x64)).max() <= \
        1e-12 * np.linalg.norm(b64)


@pytest.mark.parametrize("mat", MATRICES)
def test_fp64_entries_are_df64_hi_plus_lo(mat):
    A = MATRICES[mat]()
    A64 = csr_to_fp64(A, device="cpu")
    Adf = csr_to_df64(A)
    if isinstance(A64, DiaMatrix):
        assert A64.offsets == Adf.A_hi.offsets
        hi, got = np.asarray(Adf.A_hi.bands, np.float64), A64.bands.numpy()
    else:
        assert isinstance(A64, EllMatrix)
        k = np.asarray(Adf.A_hi.cols).shape[0]
        cols, got, _ = ell_unpack(A64, k=k)
        np.testing.assert_array_equal(cols.numpy(),
                                      np.asarray(Adf.A_hi.cols))
        hi, got = np.asarray(Adf.A_hi.vals, np.float64), got.numpy()
    lo = 0.0 if Adf.lo is None else np.asarray(Adf.lo, np.float64)
    np.testing.assert_array_equal(got, hi + lo)
    # the fp32 Krylov operator is the JAX A_hi, cast on the device
    A32 = to_fp32(A64)
    got32 = A32.bands if isinstance(A32, DiaMatrix) \
        else ell_unpack(A32, k=k)[1]
    np.testing.assert_array_equal(got32.numpy(), hi.astype(np.float32))


def test_dot_compensated_and_plain():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(10_000).astype(np.float32)
    y = rng.standard_normal(10_000).astype(np.float32)
    want = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    hi, lo = df64.dot(jnp.asarray(x), jnp.asarray(y))
    got = blas.dot(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32
    # fp64 accumulation, then one rounding to fp32, like df64 hi + lo
    assert abs(got.item() - want) <= 1e-7 * abs(want)
    assert got.item() == float(np.float32(float(hi) + float(lo)))
    plain = blas.dot(torch.from_numpy(x), torch.from_numpy(y),
                     compensated=False).item()
    np.testing.assert_allclose(plain, float(jnp.dot(x, y)), rtol=1e-5)
    assert blas.norm_sq(torch.from_numpy(x)).item() == pytest.approx(
        float(np.dot(x.astype(np.float64), x)), rel=1e-7)


# DIA offset sets of the finish: 2-D 5- and 9-point stencils, 3-D Poisson
# (its +-m^2 planes beyond the largest halo the kernel stages, 2048) and
# 2-D elasticity's 21 bands (+-1027 inside that halo)
FINISH_OFFSETS = {
    "5 p2d": ((-160, -1, 0, 1, 160), 160 * 160),
    "7 p3d": ((-2304, -48, -1, 0, 1, 48, 2304), 48 ** 3),
    "9 aniso": ((-161, -160, -159, -1, 0, 1, 159, 160, 161), 160 * 160),
    "21 e2d": ((*range(-1027, -1020), *range(-3, 4), *range(1021, 1028)),
               2 * 512 * 40),
    "7 p3d odd tile": ((-2304, -48, -1, 0, 1, 48, 2304), 48 ** 3 - 70),
}


def _finish_case(name, seed=0):
    """A random DIA operator (fp64 bands, zero where a column leaves the
    matrix) and the finish's inputs x64, d (fp32), b64."""
    from sparsh_amg_tpu_torch.ops.formats import DiaMatrix
    offsets, n = FINISH_OFFSETS[name]
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((len(offsets), n)) * np.pi
    for k, off in enumerate(offsets):
        rows = np.arange(n)
        bands[k, (rows + off < 0) | (rows + off >= n)] = 0.0
    A64 = DiaMatrix(bands=torch.from_numpy(bands), offsets=offsets,
                    n_rows=n, n_cols=n)
    x64 = torch.from_numpy(rng.standard_normal(n))
    d = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e-3)
    b64 = torch.from_numpy(rng.standard_normal(n))
    return A64, x64, d, b64


def _parent_finish(A64, x64, d, b64, dot):
    """The finish as the solver's loop composed it before it had a
    kernel (x, r, ||r||^2)."""
    x = x64 + d
    r = residual64(A64, b64, x)
    return x, r, dot(r, r).reshape(1)


def _numpy_finish(A64, x64, d, b64):
    """The same arithmetic in numpy, in the kernel's order: d widened and
    added once, each band's product rounded and added in ascending d from
    0, r = b - az; (x, fp32 r, r)."""
    bands, x = A64.bands.numpy(), x64.numpy() + d.numpy().astype(np.float64)
    n = x.size
    az = np.zeros(n)
    for band, off in zip(bands, A64.offsets):
        v = np.zeros(n)
        lo, hi = max(0, -off), min(n, n - off)
        v[lo:hi] = x[lo + off: hi + off]
        az = az + band * v
    r = b64.numpy() - az
    return x, r.astype(np.float32), r


@pytest.mark.parametrize("name", FINISH_OFFSETS)
def test_finish64_plain_is_the_parent_finish(name):
    """finish64_plain gives the parent composition's x, fp32 right-hand
    side and ||r||^2 bit for bit, and x and the fp32 r are numpy's in the
    same order bit for bit (what the kernel is held to on the card)."""
    from sparsh_amg_tpu_torch.ops.fp64 import finish64_plain
    A64, x64, d, b64 = _finish_case(name)
    x, r, rr = finish64_plain(A64, x64, d, b64, torch.dot)
    px, pr, prr = _parent_finish(A64, x64, d, b64, torch.dot)
    assert torch.equal(x, px) and torch.equal(r, pr)
    assert torch.equal(r.float(), pr.float()) and torch.equal(rr, prr)
    nx, nb, nr = _numpy_finish(A64, x64, d, b64)
    np.testing.assert_array_equal(x.numpy(), nx)
    np.testing.assert_array_equal(r.float().numpy(), nb)
    assert rr.shape == (1,) and rr.dtype == torch.float64
    assert abs(rr.item() - nr @ nr) <= 1e-13 * (nr @ nr)


def test_dia_finish64_on_the_cpu_writes_in_place():
    """The kernel's wrapper on CPU tensors runs finish64_plain into the
    buffers it was given and returns them, launches nothing, and refuses
    what the kernel does not take."""
    from sparsh_amg_tpu_torch.ops import fp64
    A64, x64, d, b64 = _finish_case("7 p3d odd tile", seed=1)
    want = fp64.finish64_plain(A64, x64, d, b64, torch.dot)
    x = x64.clone()
    b = torch.zeros(A64.n_pad, dtype=torch.float32)
    rr = torch.zeros(1, dtype=torch.float64)
    before = fp64.dia_finish64.launches
    out = fp64.dia_finish64(A64, x, d, b64, b, rr)
    assert out[0] is x and out[1] is b and out[2] is rr
    assert fp64.dia_finish64.launches == before
    assert torch.equal(x, want[0]) and torch.equal(b, want[1].float())
    assert torch.equal(rr, want[2])
    A32 = to_fp32(A64)
    with pytest.raises(ValueError, match="fp64 bands"):
        fp64.dia_finish64(A32, x, d, b64, b, rr)
    with pytest.raises(ValueError, match="d must be"):
        fp64.dia_finish64(A64, x, d.double(), b64, b, rr)
    with pytest.raises(ValueError, match="rr must be"):
        fp64.dia_finish64(A64, x, d, b64, b, torch.zeros(2, dtype=torch.float64))


class _RankBlock:
    """A stand-in for a rank block's fp64 layout (parallel.dist): only
    its plain product."""

    def __init__(self, A64):
        self.A64 = A64

    def spmv_plain(self, x):
        return spmv64(self.A64, x)


@pytest.mark.parametrize("kind", ["dia", "ell", "dist"])
def test_finish_dispatch_takes_the_plain_path_off_the_card(kind):
    """finish64 runs the plain composition (new tensors, the solver's
    dot, no launch) for a DIA operator on the CPU, a sliced-ELL operator
    and a distributed one; on the card only the DIA operator takes the
    kernel."""
    from sparsh_amg_tpu_torch.ops import fp64
    from sparsh_amg_tpu_torch.parallel.hierarchy import DistFp64
    A = _inexact(poisson2d(40)) if kind != "ell" else _irregular(1600)
    A64 = csr_to_fp64(A, prefer_dia=kind != "ell", device="cpu")
    if kind == "dist":
        A64 = DistFp64(A=_RankBlock(A64), A_hi=None)
        n_pad = A64.A.A64.n_pad
    else:
        n_pad = A64.n_pad
    assert isinstance(A64, {"dia": DiaMatrix, "ell": EllMatrix,
                            "dist": DistFp64}[kind])
    rng = np.random.default_rng(4)
    x64 = torch.from_numpy(rng.standard_normal(n_pad))
    d = torch.from_numpy(rng.standard_normal(n_pad).astype(np.float32))
    b64 = torch.from_numpy(rng.standard_normal(n_pad))
    b = torch.zeros(n_pad, dtype=torch.float32)
    rr = torch.zeros(1, dtype=torch.float64)
    dots = []

    def dot(u, v):
        dots.append(1)
        return torch.dot(u, v)
    before = fp64.dia_finish64.launches
    x, r, s = fp64.finish64(A64, x64, d, b64, b, rr, dot)
    assert fp64.dia_finish64.launches == before and dots == [1]
    assert x is not x64 and r is not b and s is not rr
    assert r.dtype == torch.float64 and not b.any() and not rr.any()
    px, pr, ps = _parent_finish(A64, x64, d, b64, torch.dot)
    assert torch.equal(x, px) and torch.equal(r, pr) and torch.equal(s, ps)
    assert not fp64.finish_kernel_applies(A64, "cpu")
    assert fp64.finish_kernel_applies(A64, "cuda") == (kind == "dia")
