"""The port's DIA SpMV and fused tails (plain versions on the CPU) against
the JAX package's Pallas DIA kernels in interpret mode and its XLA path.

Inputs are made with numpy from a seed and handed to both.  Tolerance:
rtol 1e-5 with an absolute floor of 1e-5 * max|reference| -- both sides
accumulate in fp32, but the order of the sums differs."""
import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp
import torch

from sparsh_amg_tpu.models.poisson import poisson2d, poisson3d
from sparsh_amg_tpu.ops import formats as jf
from sparsh_amg_tpu.ops import pallas_spmv as jp
from sparsh_amg_tpu_torch.ops import dia_spmv as port
from sparsh_amg_tpu_torch.ops.formats import DiaMatrix, csr_to_dia, residual

RTOL = 1e-5


def _wide_band():
    # offsets neither multiples of 128 nor small (test_pallas.py:25)
    n = 1000
    offs = [-300, -129, -127, -5, 0, 3, 127, 128, 301]
    rng = np.random.default_rng(1)
    return sp.diags([rng.standard_normal(n) for _ in offs], offs,
                    shape=(n, n), format="csr")


MATRICES = {"poisson2d(32)": lambda: poisson2d(32),
            "poisson3d(12)": lambda: poisson3d(12),
            "wide-band": _wide_band}
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _setup(mat, dt, seed=0):
    """The port's DIA matrix, the same bands for JAX, and fp32 vectors."""
    tdt, jdt = DTYPES[dt]
    D = csr_to_dia(MATRICES[mat]().tocsr(), tdt, device="cpu")
    bands_j = jnp.asarray(D.bands.float().numpy()).astype(jdt)
    rng = np.random.default_rng(seed)
    vecs = [rng.standard_normal(D.n_pad).astype(np.float32)
            for _ in range(4)]
    dinv = rng.uniform(0.1, 0.2, D.n_pad).astype(np.float32)
    return D, bands_j, vecs, dinv


@pytest.mark.parametrize("mat", MATRICES)
def test_csr_to_dia_matches_jax(mat):
    A = MATRICES[mat]().tocsr()
    D = csr_to_dia(A, device="cpu")
    J = jf.csr_to_dia(A, pad_multiple=128)
    assert D.offsets == J.offsets and D.n_pad == J.n_pad
    np.testing.assert_array_equal(D.bands.numpy(), np.asarray(J.bands))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mat", MATRICES)
def test_dia_spmv(mat, dt):
    D, bands_j, (x, *_), _ = _setup(mat, dt)
    got = port.dia_spmv(D.bands, torch.from_numpy(x), D.offsets)
    assert got.dtype == torch.float32
    xj = jnp.asarray(x)
    _close(got, jp.dia_spmv_pallas(bands_j, xj, D.offsets, D.n_pad,
                                   interpret=True))
    _close(got, jf.DiaMatrix(bands_j, D.offsets, D.n_rows,
                             D.n_cols).spmv(xj))


@pytest.mark.parametrize("tail", ["residual", "dinv_residual",
                                  "jacobi_sweep", "cheb_step"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mat", MATRICES)
def test_dia_fused_tails(mat, dt, tail):
    D, bands_j, (x, b, d, r), dinv = _setup(mat, dt, seed=2)
    T = lambda a: torch.from_numpy(a)
    J = jnp.asarray
    xla = jf.DiaMatrix(bands_j, D.offsets, D.n_rows, D.n_cols)
    kw = dict(offsets=D.offsets, n_pad=D.n_pad, interpret=True)
    if tail == "residual":
        got = [port.dia_residual(D.bands, T(x), T(b), D.offsets)]
        pallas = [jp.dia_residual(bands_j, J(x), J(b), **kw)]
        plain = [b - np.asarray(xla.spmv(J(x)))]
    elif tail == "dinv_residual":
        # the port's Chebyshev start: the Pallas dinv_residual's r, and d
        got = port.dia_cheb_start(D.bands, T(x), T(b), T(dinv), 1.7,
                                  D.offsets)
        r0 = np.asarray(jp.dia_dinv_residual(bands_j, J(x), J(b), J(dinv),
                                             **kw))
        pallas = [r0, r0 / np.float32(1.7)]
        plain = [dinv * (b - np.asarray(xla.spmv(J(x))))]
        plain.append(plain[0] / np.float32(1.7))
    elif tail == "jacobi_sweep":
        got = [port.dia_jacobi_sweep(D.bands, T(x), T(b), T(dinv), 0.7,
                                     D.offsets)]
        pallas = [jp.dia_jacobi_sweep(bands_j, J(x), J(b), J(dinv), 0.7,
                                      **kw)]
        plain = [x + 0.7 * dinv * (b - np.asarray(xla.spmv(J(x))))]
    else:
        got = port.dia_cheb_step(D.bands, T(x), T(d), T(r), T(dinv), 0.3,
                                 0.9, D.offsets)
        pallas = jp.dia_cheb_step(bands_j, J(x), J(d), J(r), J(dinv), 0.3,
                                  0.9, **kw)
        r2 = r - dinv * np.asarray(xla.spmv(J(d)))
        plain = [x + d, r2, 0.3 * d + 0.9 * r2]
    assert len(got) == len(pallas) == len(plain)
    for g, p, q in zip(got, pallas, plain):
        _close(g, p)
        _close(g, q)


def test_residual_dispatch_and_cpu_counts():
    """formats.residual takes the fused DIA tail; on the CPU the wrappers
    run the plain versions and count no kernel launch."""
    D, _, (x, b, *_), _ = _setup("poisson3d(12)", "fp32", seed=3)
    before = {w.__name__: w.launches for w in port.WRAPPERS}
    got = residual(D, torch.from_numpy(x), torch.from_numpy(b))
    want = torch.from_numpy(b) - D.spmv(torch.from_numpy(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert {w.__name__: w.launches for w in port.WRAPPERS} == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "bands", "offsets",
                                 "n_pad"])
def test_dia_wrapper_rejects(bad):
    D, _, (x, *_), _ = _setup("poisson2d(32)", "fp32")
    bands, offsets, v = D.bands, D.offsets, torch.from_numpy(x)
    if bad == "dtype":
        v = v.double()
    elif bad == "shape":
        v = v[:-1]
    elif bad == "bands":
        bands = bands.half()
    elif bad == "n_pad":
        # the kernel's 16-byte band loads need n_pad % ROW_ALIGN == 0
        n = D.n_pad - port.ROW_ALIGN // 2
        bands, v = bands[:, :n].contiguous(), v[:n].contiguous()
    else:
        offsets = offsets[:-1]
    with pytest.raises(ValueError):
        port.dia_spmv(bands, v, offsets)


def test_dia_bf16_bands_accumulate_in_fp32():
    """bf16 bands times an fp32 vector: the product is taken in fp32 on
    the exactly widened band values."""
    D, _, (x, *_), _ = _setup("poisson3d(12)", "bf16", seed=4)
    D32 = DiaMatrix(D.bands.float(), D.offsets, D.n_rows, D.n_cols)
    xt = torch.from_numpy(x)
    torch.testing.assert_close(D.spmv(xt), D32.spmv(xt), rtol=0, atol=0)
