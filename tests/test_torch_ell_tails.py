"""The ELL kernel's tails (``ops/ell_spmv.py``: ``ell_residual``,
``ell_jacobi_sweep``, ``ell_spmv_add``) on the CPU, and the cycle that
runs them.

Each tail's plain twin is held bit for bit to the composition it
replaces (the SpMV, then plain elementwise PyTorch), and a multigrid
cycle on an l1-Jacobi or Jacobi hierarchy, and a W-cycle BiCGStab solve,
to the cycle the port ran before the tails: the same bits, with one
launch a sweep, a residual and a correction on every ELL level, no zero
made for a zero start's sweeps and no pad after the coarse solve that
an ELL prolongation reads.  tests/test_torch_gpu.py holds the kernels
to the same composition on the card."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from sparsh_amg_tpu_torch import configs
from sparsh_amg_tpu_torch.models.anisotropic import anisotropic2d
from sparsh_amg_tpu_torch.models.poisson import poisson2d
from sparsh_amg_tpu_torch.ops import ell_spmv as K
from sparsh_amg_tpu_torch.ops import formats
from sparsh_amg_tpu_torch.ops.formats import (EllMatrix, FusedDia,
                                              csr_to_ell, spmv)
from sparsh_amg_tpu_torch.solve import cycles, device

NAME = "aniso2d_2048_eps1e-3_rot45_aggW_bicgstab"
OMEGA = 0.7

# square operators (a sorted and an unsorted packing, rows of 4 lanes and
# 4-slot loads) and a prolongation-shaped one with empty rows
LAYOUTS = {
    "poisson2d-sorted": (lambda: poisson2d(40).tocsr(), {}),
    "poisson2d-T1V1": (lambda: poisson2d(40).tocsr(),
                       dict(lanes=1, vec=1, sigma=1)),
    "random-T4V4": (lambda: (sp.random(700, 700, density=0.08,
                                       random_state=3) + sp.eye(700)
                             ).tocsr(), dict(lanes=4, vec=4, sigma=64)),
    "P-shaped 900x300": (lambda: sp.random(900, 300, density=0.01,
                                           random_state=5, format="csr"),
                         {}),
}
TAILS = ("residual", "jacobi", "jacobi1", "add")
# a Jacobi sweep needs a square operator
CASES = [(t, lay) for t in TAILS for lay in LAYOUTS
         if not (t.startswith("jacobi") and lay.startswith("P-"))]


def _vecs(M, seed=0):
    rng = np.random.default_rng(seed)
    vec = lambda n: torch.from_numpy(rng.standard_normal(n).astype(
        np.float32))
    dinv = torch.from_numpy(rng.uniform(0.1, 0.2, M.n_pad).astype(
        np.float32))
    return vec(M.n_pad), vec(M.n_pad), vec(max(M.n_cols, 1)), dinv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("tail,layout", CASES)
def test_tail_twins_are_the_composition(tail, layout, dtype):
    """Each tail's twin equals the SpMV followed by the elementwise
    PyTorch it replaces, bit for bit, padding rows included."""
    make, pack = LAYOUTS[layout]
    M = csr_to_ell(make(), dtype, 128, device="cpu", **pack)
    x, b, e, dinv = _vecs(M)
    src = x if M.n_rows == M.n_cols else e
    if tail == "residual":
        got, want = K.ell_residual(M, src, b), b - K.ell_plain(M, src)
    elif tail == "add":
        got, want = K.ell_spmv_add(M, e, x), x + K.ell_plain(M, e)
    else:
        omega = OMEGA if tail == "jacobi" else 1.0
        got = K.ell_jacobi_sweep(M, x, b, dinv, omega)
        want = x + omega * dinv * (b - K.ell_plain(M, x))
    assert got.shape == (M.n_pad,)
    assert torch.equal(got, want)


def test_tails_take_only_the_vectors_a_launch_can():
    """A tail's vectors are contiguous fp32 (n_pad,) tensors: anything
    else is refused by the wrappers, and the dispatch of ``formats``
    takes the plain composition for it."""
    M = csr_to_ell(poisson2d(12).tocsr(), device="cpu")
    x, b, _, dinv = _vecs(M)
    assert K.fusable(M, x, b, dinv)
    for bad in (b[:-1], b.double(), torch.stack([b, b])[:, 0]):
        assert not K.fusable(M, x, bad)
        with pytest.raises(ValueError):
            K.ell_residual(M, x, bad)
    assert not K.fusable(M, x.double(), b)
    r = formats.residual(M, x, b[:M.n_pad])
    assert torch.equal(r, b - spmv(M, x))


def _parent_sweeps(lev, b, x, sweeps, omega, dinv, zero_start):
    """The Jacobi sweeps as the port ran them before the ELL tails."""
    if sweeps <= 0:
        return x
    if zero_start:
        x = omega * dinv * b if omega != 1.0 else dinv * b
        sweeps -= 1
    for _ in range(sweeps):
        if isinstance(lev.A, FusedDia):
            x = lev.A.jacobi_sweep(x, b, dinv, omega)
        else:
            x = x + omega * dinv * (b - spmv(lev.A, x))
    return x


def _parent_cycle(levels, l, b, x, params, shape):
    """cycles._cycle before the ELL tails: a zero made for every zero
    start, the residual and the correction as an SpMV and a plain
    subtraction or addition off DIA levels, the coarse solve padded."""
    lev = levels[l]
    if lev.P is None or l == len(levels) - 1:
        r = lev.coarse_inv.shape[-1]
        y = torch.mv(lev.coarse_inv, b[:r])
        return F.pad(y, (0, b.shape[0] - r)) if b.shape[0] > r else y
    l1 = params.smoother == "l1jacobi"
    omega, dinv = (1.0, lev.l1_dinv) if l1 else (params.jacobi_omega,
                                                  lev.dinv)
    zero = x is None
    x = torch.zeros_like(b) if zero else x
    x = _parent_sweeps(lev, b, x, params.nu1, omega, dinv, zero)
    r = lev.A.residual(x, b) if isinstance(lev.A, FusedDia) \
        else b - spmv(lev.A, x)
    rc = spmv(lev.R, r)
    second = {"W": "W", "F": "V", "V": None}[shape]
    ec = _parent_cycle(levels, l + 1, rc, None, params, shape)
    if second:
        ec = _parent_cycle(levels, l + 1, rc, ec, params, second)
    x = x + spmv(lev.P, ec)
    return _parent_sweeps(lev, b, x, params.nu2, omega, dinv, False)


@pytest.fixture(scope="module")
def aniso():
    """The cell's recipe at aniso2d(64), coarsened to 64 rows with dense
    levels below 64 rows: three DIA levels, an ELL level and a coarsest
    level with its inverse, reached by an ELL prolongation."""
    from sparsh_amg_tpu_torch import AMGSolver
    amg = configs.params(NAME, dense_size=64, coarse_size=64)
    A = anisotropic2d(64, epsilon=1e-3, angle_deg=45)
    solver = AMGSolver(A, amg, configs.krylov(NAME), device="cpu")
    levels = solver.device.levels
    assert isinstance(levels[-2].P, EllMatrix)
    assert any(isinstance(lv.A, EllMatrix) for lv in levels[:-1])
    return A, amg, solver


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("ell_spmv", "ell_residual", "ell_jacobi_sweep",
                     "ell_spmv_add"):
            fn = getattr(formats, name)
            monkeypatch.setattr(formats, name, lambda *a, _n=name, _f=fn,
                                **k: self.calls.append(_n) or _f(*a, **k))
        zeros_like = torch.zeros_like
        monkeypatch.setattr(torch, "zeros_like", lambda *a, **k:
                            self.calls.append("zeros_like")
                            or zeros_like(*a, **k))
        solve = device.DeviceLevel.coarse_solve
        monkeypatch.setattr(
            device.DeviceLevel, "coarse_solve",
            lambda lev, b, tight=False: self.calls.append(
                "coarse_tight" if tight else "coarse_padded")
            or solve(lev, b, tight))


def _visits(n_levels, shape):
    """Visits of each level in one cycle."""
    visits = [0] * n_levels

    def go(l, s):
        visits[l] += 1
        if l == n_levels - 1:
            return
        go(l + 1, s)
        if s != "V":
            go(l + 1, "W" if s == "W" else "V")
    go(0, shape)
    return visits


@pytest.mark.parametrize("shape", ["W", "V", "F"])
@pytest.mark.parametrize("smoother", ["l1jacobi", "jacobi"])
def test_cycle_is_the_parents_on_fewer_launches(aniso, monkeypatch, shape,
                                                smoother):
    """One cycle gives the bits of the cycle before the ELL tails; every
    visit to an ELL level runs one residual, each sweep one fused launch
    (a zero start's first none), every visit one correction launch per ELL
    prolongation, no zero is made, and the coarse solve, read by an ELL
    prolongation, is not padded."""
    A, amg, solver = aniso
    params = dataclasses.replace(amg, smoother=smoother, cycle=shape)
    levels = solver.device.levels
    n = A.shape[0]
    b = torch.zeros(solver.n_pad, dtype=torch.float32)
    b[:n] = torch.from_numpy(np.random.default_rng(3).standard_normal(n))
    want = _parent_cycle(levels, 0, b, None, params, shape)
    spy = _Spy(monkeypatch)
    got = cycles.make_cycle(params)(levels, b)
    assert torch.equal(got, want)
    visits = _visits(len(levels), shape)
    inner = range(len(levels) - 1)
    ell_a = sum(visits[l] for l in inner if isinstance(levels[l].A,
                                                       EllMatrix))
    ell_p = sum(visits[l] for l in inner if isinstance(levels[l].P,
                                                       EllMatrix))
    # sweeps a visit: nu1 + nu2 - 1 from a zero start, nu1 + nu2 else;
    # the zero starts are the first visit to each level of each parent
    zero = sum(visits[l - 1] if l else 1 for l in inner
               if isinstance(levels[l].A, EllMatrix))
    sweeps = ell_a * (params.nu1 + params.nu2) - zero
    assert spy.calls.count("ell_residual") == ell_a
    assert spy.calls.count("ell_jacobi_sweep") == sweeps
    assert spy.calls.count("ell_spmv_add") == ell_p
    assert "zeros_like" not in spy.calls
    assert spy.calls.count("coarse_tight") == visits[-1]
    assert "coarse_padded" not in spy.calls


def test_coarse_solve_pads_only_where_asked(aniso):
    """The coarse solve's own rows cover the level's real rows; padded,
    it is b's length with zeros past them."""
    _, _, solver = aniso
    lev = solver.device.levels[-1]
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(
        lev.n_pad).astype(np.float32))
    padded, tight = lev.coarse_solve(b), lev.coarse_solve(b, tight=True)
    r = lev.coarse_inv.shape[-1]
    assert padded.shape == b.shape and tight.shape == (r,) and r >= lev.n
    assert torch.equal(padded[:r], tight) and not padded[r:].any()


def test_w_bicgstab_solve_keeps_the_parents_bits(aniso, monkeypatch):
    """A primed W-cycle BiCGStab solve to 1e-8 gives the bits, the
    iterations and the passes of the same solve on the cycle before the
    ELL tails."""
    A, _, solver = aniso
    b = np.random.default_rng(11).standard_normal(A.shape[0])

    def solve():
        solver.solve(b, tol=1e-2)
        return solver.solve(b)

    got = solve()
    monkeypatch.setattr(cycles, "_cycle", _parent_cycle)
    want = solve()
    assert got.converged and want.converged
    assert (got.iterations, got.refine_passes) == \
        (want.iterations, want.refine_passes)
    assert np.array_equal(got.x, want.x)
