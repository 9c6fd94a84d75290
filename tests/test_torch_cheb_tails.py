"""The Chebyshev smooth on a DIA level as kernel launches alone: the start
tail (r and d = r / theta; no product after a zero start), the step with
no x after a zero start, and the last step that writes x + d'
(``ops/dia_spmv.py``: ``dia_cheb_start``, ``dia_cheb_step`` with x None,
``dia_cheb_last``).

Their plain twins are held bit for bit to the composition they replace
(the older tails and plain adds), and ``smoothers.chebyshev`` on a
``DiaMatrix`` to the composition the smoother ran before, at degrees 1-4
from a zero and a nonzero start.  tests/test_torch_gpu.py holds the
kernels to the same on the card."""
import numpy as np
import pytest
import torch

from sparsh_amg_tpu_torch.models import poisson3d
from sparsh_amg_tpu_torch.models.elasticity import elasticity2d
from sparsh_amg_tpu_torch.ops import dia_spmv as K
from sparsh_amg_tpu_torch.ops import formats
from sparsh_amg_tpu_torch.ops.formats import csr_to_dia
from sparsh_amg_tpu_torch.params import AMGParams
from sparsh_amg_tpu_torch.solve import smoothers
from sparsh_amg_tpu_torch.solve.device import DeviceLevel

# the 7-band 3-D Poisson table in both band types, and 2-D elasticity's
# 21 bands (the kernel's compiled counts)
TABLES = {"p3d-bf16": (lambda: poisson3d(12), torch.bfloat16),
          "p3d-fp32": (lambda: poisson3d(12), torch.float32),
          "e2d21-fp32": (lambda: elasticity2d(16), torch.float32)}
THETA, A_, C_ = 1.0333333, 0.4127, 0.8061
TAILS = ("start", "start0", "step0", "last", "last0")
WRAPPER_NAMES = ("dia_spmv", "dia_residual", "dia_cheb_start",
                 "dia_cheb_step", "dia_cheb_last")


def _table(name, seed=0):
    make, dtype = TABLES[name]
    D = csr_to_dia(make().tocsr(), dtype, device="cpu")
    rng = np.random.default_rng(seed)
    vec = lambda: torch.from_numpy(
        rng.standard_normal(D.n_pad).astype(np.float32))
    dinv = torch.from_numpy(rng.uniform(0.1, 0.2, D.n_pad).astype(
        np.float32))
    return D, dinv, [vec() for _ in range(3)]


def _new_and_composed(D, tail, dinv, x, b, d):
    """(the new tail's twin, the composition it replaces); for the steps
    b is r."""
    P = lambda t, v, **k: K.dia_fused_plain(t, D.bands, D.offsets, v, **k)
    zeros = torch.zeros_like(b)
    if tail in ("start", "start0"):
        v = x if tail == "start" else None
        new = P(K.CHEB_START, v, b=b, dinv=dinv, s0=THETA)
        r = dinv * (b - P(K.SPMV, x)) if v is not None else dinv * b
        return new, (r, r / THETA)
    xs = x if tail == "last" else None
    old = P(K.CHEB, d, b=b, dinv=dinv, x=zeros if xs is None else xs,
            s0=A_, s1=C_)
    if tail == "step0":
        return P(K.CHEB, d, b=b, dinv=dinv, s0=A_, s1=C_), old
    new = P(K.CHEB_LAST, d, b=b, dinv=dinv, x=xs, s0=A_, s1=C_)
    return new, old[0] + old[2]


def _tuple(t):
    return t if isinstance(t, tuple) else (t,)


@pytest.mark.parametrize("tail", TAILS)
@pytest.mark.parametrize("table", TABLES)
def test_tail_twins_equal_the_composition(table, tail):
    """Each new tail's plain twin gives the bits of the older tails and
    plain adds it replaces, and its wrapper on the CPU runs the twin."""
    D, dinv, (x, b, d) = _table(table)
    new, old = _new_and_composed(D, tail, dinv, x, b, d)
    assert len(_tuple(new)) == len(_tuple(old))
    for n, o in zip(_tuple(new), _tuple(old)):
        assert n.dtype == torch.float32 and torch.isfinite(n).all()
        assert torch.equal(n, o), tail
    wrapped = {
        "start": lambda: D.cheb_start(x, b, dinv, THETA),
        "start0": lambda: D.cheb_start(None, b, dinv, THETA),
        "step0": lambda: D.cheb_step(None, d, b, dinv, A_, C_),
        "last": lambda: D.cheb_last(x, d, b, dinv, A_, C_),
        "last0": lambda: D.cheb_last(None, d, b, dinv, A_, C_),
    }[tail]()
    for w, n in zip(_tuple(wrapped), _tuple(new), strict=True):
        assert torch.equal(w, n), tail
    if tail == "step0":
        assert wrapped[0] is d          # x' = 0 + d is d itself


def _level(D, dinv, lam_max=1.93):
    return DeviceLevel(A=D, dinv=dinv, l1_dinv=dinv, lam_max=lam_max,
                       P=None, R=None, coarse_inv=None)


def _parent_chebyshev(level, b, x, degree, lower_frac, zero_start):
    """The Chebyshev smooth a DIA level ran before the start and last
    tails: a zero x made, dinv * b or dinv * (b - A x) (here the fused
    residual and a plain product, which the parent's DINV_RESIDUAL tail
    did in one launch with the same fp32 operations), r / theta, degree
    - 1 CHEB steps, then x + d."""
    f32 = np.float32
    lmax = f32(level.lam_max)
    lmin = f32(lower_frac) * lmax
    theta = f32(0.5) * (lmax + lmin)
    delta = f32(0.5) * (lmax - lmin)
    sigma = theta / delta
    rho = f32(1.0) / sigma
    A = level.A
    if zero_start:
        x = torch.zeros_like(b)
        r = level.dinv * b
    else:
        r = level.dinv * A.residual(x, b)
    d = r / float(theta)
    for _ in range(degree - 1):
        rho_new = f32(1.0) / (f32(2.0) * sigma - rho)
        a, c = float(rho_new * rho), float(f32(2.0) * rho_new / delta)
        x, r, d = A.cheb_step(x, d, r, level.dinv, a, c)
        rho = rho_new
    return x + d


@pytest.mark.parametrize("zero_start", [False, True], ids=["x", "zero"])
@pytest.mark.parametrize("degree", [1, 2, 3, 4])
@pytest.mark.parametrize("table", TABLES)
def test_chebyshev_on_dia_equals_the_parent_composition(
        monkeypatch, table, degree, zero_start):
    """smoothers.chebyshev on a DiaMatrix gives the bits of the older
    composition, through one start tail, degree - 2 steps and one last
    tail (degree 1: the start and x + d, or d after a zero start)."""
    D, dinv, (x, b, _) = _table(table, seed=degree)
    lev = _level(D, dinv)
    want = _parent_chebyshev(lev, b, x, degree, 1 / 30, zero_start)
    calls = []
    for name in WRAPPER_NAMES:
        fn = getattr(formats, name)
        monkeypatch.setattr(formats, name, lambda *a, _n=name, _f=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    got = smoothers.chebyshev(lev, b, None if zero_start else x, degree,
                              1 / 30, zero_start=zero_start)
    assert torch.equal(got, want)
    steps = ["dia_cheb_step"] * max(degree - 2, 0)
    assert calls == ["dia_cheb_start"] + steps + \
        (["dia_cheb_last"] if degree > 1 else [])


def test_zero_start_smoothers_make_the_zero_they_read(monkeypatch):
    """A zero start passes x = None to smooth(), which makes the zero
    where the smoother reads it: a smoother of no sweeps gives the zero
    vector, every smoother on an ELL level the bits it gives from zeros,
    and a Chebyshev smooth on a DIA level takes no zero at all."""
    D, dinv, (_, b, _) = _table("p3d-fp32")
    ell = formats.csr_to_ell(poisson3d(12).tocsr(), device="cpu")
    lev, plain = _level(D, dinv), _level(ell, dinv)
    base = AMGParams()
    for p in (base.replace(smoother="jacobi", nu1=0),
              base.replace(smoother="chebyshev", cheby_degree=0)):
        got = smoothers.smooth(lev, b, None, p, zero_start=True)
        assert torch.equal(got, torch.zeros_like(b))
    for name in ("jacobi", "l1jacobi", "chebyshev", "gs2"):
        p = base.replace(smoother=name, nu1=2)
        got = smoothers.smooth(plain, b, None, p, zero_start=True)
        want = smoothers.smooth(plain, b, torch.zeros_like(b), p,
                                zero_start=True)
        assert torch.equal(got, want), name
    made, zeros_like = [], torch.zeros_like
    monkeypatch.setattr(torch, "zeros_like",
                        lambda t: made.append(t) or zeros_like(t))
    p = base.replace(smoother="chebyshev")
    got = smoothers.smooth(lev, b, None, p, zero_start=True)
    assert made == []
    assert torch.equal(got, _parent_chebyshev(lev, b, None, p.cheby_degree,
                                              p.cheby_lower_frac, True))

