"""The fused DIA products on rank blocks (``parallel/dist.py::DistDia``):
the local launch of a tail with v = 0 outside the block, then the
boundary entry (``ops/dia_spmv.dia_fused_boundary``, its plain twin on
the CPU) redoing the tail on the rows whose bands reach a neighbour.

Held here to the plain compositions over the same halos, and to the
serial products of the whole matrix on the rank's rows.  The smoothers'
and residual's dispatch is held to the calls each layout made before
rank blocks took the fused products, and a two-rank gloo solve to the
one-rank solve's counts.  tests/test_torch_gpu.py holds the kernels on
the card to the serial kernel bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from sparsh_amg_tpu_torch.models import poisson3d
from sparsh_amg_tpu_torch.models.elasticity import elasticity3d
from sparsh_amg_tpu_torch.ops import block_ell
from sparsh_amg_tpu_torch.ops import dia_spmv as K
from sparsh_amg_tpu_torch.ops import formats
from sparsh_amg_tpu_torch.ops.block_ell import csr_to_block_ell
from sparsh_amg_tpu_torch.ops.formats import csr_to_dia, csr_to_ell
from sparsh_amg_tpu_torch.parallel import dist
from sparsh_amg_tpu_torch.parallel.dist import (DistDia, RankGroup,
                                                csr_to_dist)
from sparsh_amg_tpu_torch.params import AMGParams
from sparsh_amg_tpu_torch.parallel.partition import Partition
from sparsh_amg_tpu_torch.solve import smoothers
from sparsh_amg_tpu_torch.solve.device import DeviceLevel

RANKS = 4
M = 12                      # poisson3d(12): blocks of 512 rows, h 256
TAILS = {"spmv": K.SPMV, "residual": K.RESIDUAL, "jacobi": K.JACOBI,
         "cheb": K.CHEB, "cheb_start": K.CHEB_START,
         "cheb_start0": K.CHEB_START, "cheb0": K.CHEB,
         "cheb_last": K.CHEB_LAST, "cheb_last0": K.CHEB_LAST}
THETA = 1.0333333
# a degree-3 Chebyshev smooth, as smooth() dispatches a cycle's
CHEB3 = AMGParams().replace(smoother="chebyshev", cheby_degree=3,
                            cheby_lower_frac=1 / 30)


@dataclasses.dataclass(frozen=True)
class CutHalos(RankGroup):
    """A rank with no process group whose halos are cut from `glob`, the
    whole vector the product multiplies; `end` at an end of the domain
    (NaN: a product that read the missing neighbour's entries shows it)."""
    glob: torch.Tensor = None
    end: float = float("nan")

    def halo_start(self, x, h):
        n = x.shape[0]
        r0 = self.rank * n
        fill = torch.full((h,), self.end, device=x.device)
        left = self.glob[r0 - h:r0] if self.rank > 0 else fill
        right = self.glob[r0 + n:r0 + n + h] \
            if self.rank < self.size - 1 else fill
        return lambda: (left.clone(), right.clone())


def _setup(dtype):
    A = poisson3d(M)
    part = Partition.make(A.shape[0], RANKS)
    whole = csr_to_dia(A, dtype, part.n_pad, device="cpu")
    rng = np.random.default_rng(5)
    vec = lambda: torch.from_numpy(
        rng.standard_normal(part.n_pad).astype(np.float32))
    return A, part, whole, [vec() for _ in range(4)]


def _block(A, part, rank, dtype, v):
    M_ = csr_to_dist(A, part, part, RankGroup(rank, RANKS), dtype=dtype,
                     device="cpu")
    assert isinstance(M_, DistDia) and M_.h and M_.h < M_.n_loc
    return dataclasses.replace(M_, ranks=CutHalos(rank, RANKS, glob=v))


def _product(op, tail, v, b, dinv, x):
    """op's fused product of `tail` (the steps: v is d, b is r; the
    start: v is x; a trailing 0: the zero start, x None)."""
    if tail == "spmv":
        return op.spmv(v)
    if tail == "residual":
        return op.residual(v, b)
    if tail == "jacobi":
        return op.jacobi_sweep(v, b, dinv, 0.7)
    if tail.startswith("cheb_start"):
        return op.cheb_start(None if tail.endswith("0") else v, b, dinv,
                             THETA)
    xs = None if tail.endswith("0") else x
    if tail.startswith("cheb_last"):
        return op.cheb_last(xs, v, b, dinv, 0.3, 0.9)
    return op.cheb_step(xs, v, b, dinv, 0.3, 0.9)


def _serial(whole, tail, v, b, dinv, x):
    """The same product of the whole matrix, plain."""
    xs = None if tail.endswith("0") else x
    kw = {"spmv": {}, "residual": {"b": b},
          "jacobi": {"b": b, "dinv": dinv, "x": v, "s0": 0.7},
          "cheb_start": {"b": b, "dinv": dinv, "s0": THETA}}.get(
              tail.rstrip("0"),
              {"b": b, "dinv": dinv, "x": xs, "s0": 0.3, "s1": 0.9})
    return K.dia_fused_plain(TAILS[tail], whole.bands, whole.offsets,
                             None if tail == "cheb_start0" else v, **kw)


def _composed(op, tail, v, b, dinv, x):
    """The tail composed in plain torch over DistDia.spmv_plain (the same
    halos, zeros at the domain's ends as a RankGroup gives them)."""
    az = dataclasses.replace(
        op, ranks=dataclasses.replace(op.ranks, end=0.0)).spmv_plain(v)
    if tail == "spmv":
        return az
    if tail == "residual":
        return b - az
    if tail == "jacobi":
        return v + 0.7 * dinv * (b - az)
    if tail.startswith("cheb_start"):
        r = dinv * b if tail.endswith("0") else dinv * (b - az)
        return r, r / THETA
    x2 = v if tail.endswith("0") else x + v
    r2 = b - dinv * az
    d2 = 0.3 * v + 0.9 * r2
    return x2 + d2 if tail.startswith("cheb_last") else (x2, r2, d2)


def _tuple(t):
    return t if isinstance(t, tuple) else (t,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rank", [0, 1, 3])
@pytest.mark.parametrize("tail", list(TAILS))
def test_rank_block_products_match_plain(tail, rank, dtype):
    """Every fused product on a rank's block: within fp32 rounding of the
    plain composition over DistDia.spmv_plain, and equal to the serial
    plain product of the whole matrix on the rank's rows; the ends of
    the domain read no halo (NaN there)."""
    A, part, whole, (v, b, dinv, x) = _setup(dtype)
    op = _block(A, part, rank, dtype, v)
    rows = slice(rank * op.n_loc, (rank + 1) * op.n_loc)
    got = _product(op, tail, v[rows], b[rows], dinv[rows], x[rows])
    want = _composed(op, tail, v[rows], b[rows], dinv[rows], x[rows])
    serial = _serial(whole, tail, v, b, dinv, x)
    for g, w, s in zip(_tuple(got), _tuple(want), _tuple(serial)):
        assert torch.isfinite(g).all()
        scale = w.double().abs().max().item()
        assert (g.double() - w.double()).abs().max().item() \
            <= 4e-7 * scale, tail
        assert torch.equal(g, s[rows]), tail


@pytest.mark.parametrize("rank,lo,hi", [(0, False, True), (1, True, True),
                                        (3, True, False)])
def test_boundary_twin_writes_its_rows_only(rank, lo, hi):
    """The boundary entry's plain twin writes the rows boundary_rows names
    (the first max(-off) with a left neighbour, the last max(off) with a
    right one) and no other, in each output of the residual and of the
    Chebyshev start, zero-start step and last step; the zero-start step
    leaves its x' (d itself) alone, and a zero start, which has no
    product, has no boundary."""
    A, part, whole, (v, b, dinv, x) = _setup(torch.float32)
    op = _block(A, part, rank, torch.float32, v)
    n, h = op.n_loc, op.h
    lo_rows, hi_row = K.boundary_rows(op.offsets, n, lo, hi)
    assert (lo_rows, hi_row) == (144 if lo else 0, n - 144 if hi else n)
    rows = slice(rank * n, (rank + 1) * n)
    vl, bl, dl, xl = v[rows], b[rows], dinv[rows], x[rows]
    left, right = op.ranks.halo_start(vl, h)()
    want = torch.zeros(n, dtype=torch.bool)
    want[:lo_rows] = True
    want[hi_row:] = True
    steps = {"b": bl, "dinv": dl, "s0": 0.3, "s1": 0.9}
    for tail, n_out, kw in (
            (K.RESIDUAL, 1, {"b": bl}),
            (K.CHEB_START, 2, {"b": bl, "dinv": dl, "s0": THETA}),
            (K.CHEB, 3, steps),
            (K.CHEB_LAST, 1, dict(steps, x=xl)),
            (K.CHEB_LAST, 1, steps)):
        outs = tuple(torch.full((n,), -7.0) for _ in range(n_out))
        K.dia_fused_boundary(tail, op.bands, op.offsets, vl, left, right,
                             outs, lo, hi, **kw)
        zero_step = tail == K.CHEB
        for i, out in enumerate(outs):
            touched = out != -7.0
            if zero_step and i == 0:
                assert not touched.any()
            else:
                assert torch.equal(touched, want), (tail, i)
    with pytest.raises(ValueError, match="no product"):
        K.dia_fused_boundary(K.CHEB_START, op.bands, op.offsets, None, left,
                             right, (bl, bl), lo, hi, b=bl, dinv=dl, s0=THETA)


class _Spy:
    """Records the kernel wrappers a call reaches, by name."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod, name in ((formats, "dia_spmv"), (formats, "dia_residual"),
                          (formats, "dia_jacobi_sweep"),
                          (formats, "dia_cheb_step"),
                          (formats, "dia_cheb_start"),
                          (formats, "dia_cheb_last"), (formats, "ell_spmv"),
                          (formats, "ell_residual"),
                          (formats, "ell_jacobi_sweep"),
                          (formats, "ell_spmv_add"),
                          (block_ell, "block_ell_spmv"),
                          (dist, "dia_fused_boundary")):
            monkeypatch.setattr(mod, name, self._wrap(name,
                                                      getattr(mod, name)))

    def _wrap(self, name, fn):
        def spy(*a, **k):
            self.calls.append(name)
            return fn(*a, **k)
        return spy

    def take(self, fn):
        self.calls = []
        out = fn()
        return out, self.calls


def _level(A_dev, n_pad, seed=3):
    rng = np.random.default_rng(seed)
    dinv = torch.from_numpy(rng.uniform(0.1, 0.2, n_pad).astype(np.float32))
    return DeviceLevel(A=A_dev, dinv=dinv, l1_dinv=dinv, lam_max=1.9, P=None,
                       R=None, coarse_inv=None)


def _layouts():
    A = poisson3d(8)
    E = elasticity3d(3)
    yield "dia", csr_to_dia(A, torch.bfloat16, 128, device="cpu"), \
        "dia", A.shape[0]
    yield "ell", csr_to_ell(A, device="cpu"), "ell_spmv", A.shape[0]
    Eb = csr_to_block_ell(E, 3, device="cpu")
    assert Eb is not None
    yield "block_ell", Eb, "block_ell_spmv", E.shape[0]
    part = Partition.make(A.shape[0], 1)
    one = csr_to_dist(A, part, part, RankGroup(0, 1), dtype=torch.bfloat16,
                      device="cpu")
    yield "one_rank_dist_dia", one, "dia", A.shape[0]


@pytest.mark.parametrize("case", ["dia", "ell", "block_ell",
                                  "one_rank_dist_dia"])
def test_serial_layouts_dispatch_as_before(monkeypatch, case):
    """A DiaMatrix (and a one-rank DistDia) runs one fused kernel a
    Jacobi sweep and a residual, and a degree-3 Chebyshev smooth as a
    start, a step and a last step (the zero start's without a product);
    an ELL level one fused ELL launch a Jacobi sweep and a residual and
    an SpMV a Chebyshev product, a block-ELL level an SpMV each, with
    plain elementwise torch; no boundary launch.  The residual equals the
    plain b - A x."""
    name, A_dev, kern, n = next(c for c in _layouts() if c[0] == case)
    spy = _Spy(monkeypatch)
    n_pad = A_dev.n_pad if hasattr(A_dev, "n_pad") else A_dev.n_loc
    lev = _level(A_dev, n_pad)
    rng = np.random.default_rng(4)
    b, x = (torch.from_numpy(np.pad(rng.standard_normal(n), (0, n_pad - n))
                             .astype(np.float32)) for _ in range(2))
    _, calls_c = spy.take(
        lambda: smoothers.chebyshev(lev, b, x, 3, 1 / 30))
    _, calls_0 = spy.take(
        lambda: smoothers.smooth(lev, b, None, CHEB3, zero_start=True))
    res, calls_r = spy.take(lambda: formats.residual(A_dev, x, b))
    _, calls_j = spy.take(lambda: smoothers.jacobi(lev, b, x, 2, 0.7))
    if kern == "dia":
        assert calls_c == calls_0 == ["dia_cheb_start", "dia_cheb_step",
                                      "dia_cheb_last"]
        assert calls_r == ["dia_residual"]
        assert calls_j == ["dia_jacobi_sweep"] * 2
    elif kern == "ell_spmv":
        assert (calls_c, calls_0, calls_r, calls_j) == \
            ([kern] * 3, [kern] * 2, ["ell_residual"],
             ["ell_jacobi_sweep"] * 2)
    else:
        assert (calls_c, calls_0, calls_r, calls_j) == \
            ([kern] * 3, [kern] * 2, [kern], [kern] * 2)
    assert torch.equal(res, b - A_dev.spmv(x))


def test_rank_block_smoother_takes_the_fused_products(monkeypatch):
    """On a rank's block the Chebyshev smoother and the residual run the
    fused products: each one local launch, then one boundary launch; a
    zero start's start tail has no product, so no boundary."""
    A, part, whole, (v, b, dinv, x) = _setup(torch.bfloat16)
    op = _block(A, part, 1, torch.bfloat16, v)
    rows = slice(op.n_loc, 2 * op.n_loc)
    spy = _Spy(monkeypatch)
    lev = _level(op, op.n_loc)
    _, calls = spy.take(
        lambda: smoothers.chebyshev(lev, b[rows], v[rows], 2, 1 / 30))
    assert calls == ["dia_cheb_start", "dia_fused_boundary",
                     "dia_cheb_last", "dia_fused_boundary"]
    _, calls = spy.take(
        lambda: smoothers.smooth(lev, b[rows], None, CHEB3,
                                 zero_start=True))
    assert calls == ["dia_cheb_start", "dia_cheb_step",
                     "dia_fused_boundary", "dia_cheb_last",
                     "dia_fused_boundary"]
    _, calls = spy.take(lambda: formats.residual(op, v[rows], b[rows]))
    assert calls == ["dia_residual", "dia_fused_boundary"]


def test_two_gloo_ranks_solve_with_the_one_rank_counts():
    """Two gloo ranks on the CPU (fine level a DistDia smoothed through
    the fused products) reach 1e-8 with the one-rank solver's counts
    (+-1 iteration, the same passes)."""
    from sparsh_amg_tpu_torch.params import KrylovParams
    from sparsh_amg_tpu_torch.parallel import DistAMGSolver
    from sparsh_amg_tpu_torch.parallel.multihost import (_flagship_params,
                                                         launch_processes)
    m = 16
    res = launch_processes(2, "poisson3d", m, setup="global", device="cpu",
                           backend="gloo", timeout=300,
                           threads=1)
    A = poisson3d(m)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    one = DistAMGSolver(A, params=_flagship_params(),
                        krylov=KrylovParams(tol=1e-8, maxiter=60),
                        device="cpu").solve(b)
    assert np.linalg.norm(b - A @ one.x) / np.linalg.norm(b) <= 1e-8
    for r in res:
        assert r["converged"] and r["true_relres"] <= 1e-8, r
        assert abs(r["iterations"] - one.iterations) <= 1, (r, one)
        assert r["passes"] == one.refine_passes, (r, one)
