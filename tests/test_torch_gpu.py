"""CUDA kernels of the port against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one; on the GPU machine
(no jax there, and tests/conftest.py imports it) run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

This file imports no jax.  chip_smoke.py runs the same comparisons at the
flagship's shapes."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _vec(rng, n, dev):
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dia_kernel_tails_match_plain(cuda, dtype):
    from sparsh_amg_tpu_torch._host import poisson3d
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    from sparsh_amg_tpu_torch.ops.formats import csr_to_dia
    D = csr_to_dia(poisson3d(20), dtype, 2048, device=cuda)
    rng = np.random.default_rng(0)
    x, b, d, r = (_vec(rng, D.n_pad, cuda) for _ in range(4))
    dinv = torch.full((D.n_pad,), 1 / 6, device=cuda)
    bands, offs = D.bands, D.offsets
    before = K.dia_cheb_step.launches
    pairs = [
        (K.dia_spmv(bands, x, offs), K.dia_fused_plain(K.SPMV, bands, offs, x)),
        (K.dia_residual(bands, x, b, offs),
         K.dia_fused_plain(K.RESIDUAL, bands, offs, x, b=b)),
        (K.dia_dinv_residual(bands, x, b, dinv, offs),
         K.dia_fused_plain(K.DINV_RESIDUAL, bands, offs, x, b=b, dinv=dinv)),
        (K.dia_jacobi_sweep(bands, x, b, dinv, 0.7, offs),
         K.dia_fused_plain(K.JACOBI, bands, offs, x, b=b, dinv=dinv, x=x,
                           s0=0.7)),
    ]
    got3 = K.dia_cheb_step(bands, x, d, r, dinv, 0.3, 0.9, offs)
    want3 = K.dia_fused_plain(K.CHEB, bands, offs, d, b=r, dinv=dinv, x=x,
                              s0=0.3, s1=0.9)
    pairs += list(zip(got3, want3))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert _rel(got, want) <= 1e-5
    assert K.dia_cheb_step.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_kernel_matches_plain(cuda, dtype):
    import scipy.sparse as sp
    from sparsh_amg_tpu_torch.ops.ell_spmv import ell_plain, ell_spmv
    from sparsh_amg_tpu_torch.ops.formats import csr_to_ell
    A = sp.random(3000, 4500, density=0.01, random_state=4, format="csr")
    E = csr_to_ell(A, dtype, 2048, device=cuda)
    x = _vec(np.random.default_rng(1), A.shape[1], cuda)
    before = ell_spmv.launches
    got = ell_spmv(E.cols, E.vals, x)
    torch.cuda.synchronize()
    assert _rel(got, ell_plain(E.cols, E.vals, x)) <= 1e-5
    assert ell_spmv.launches == before + 1


def test_wrappers_raise_on_mixed_devices(cuda):
    from sparsh_amg_tpu_torch.ops import dia_spmv as K
    bands = torch.ones(1, 2048, device=cuda)
    with pytest.raises(ValueError):
        K.dia_spmv(bands, torch.ones(2048), (0,))
    with pytest.raises(ValueError):
        K.dia_spmv(bands, torch.ones(2048, device=cuda).double(), (0,))
