"""Multigrid cycles (the port of ``sparsh_amg_tpu/solve/cycles.py``):
V, W and F, recursing over the hierarchy exactly as the reference does.
Each visit to a level is bracketed by the tracer's ``enter[l]`` and
``leave[l]`` stamps (``utils/trace.py``; nothing outside its stamped
step or while tracing is off)."""
from __future__ import annotations

from ..ops.formats import residual, spmv
from ..utils import trace
from .smoothers import smooth


def _cycle(levels, l, b, x, params, shape):
    trace.stamp("enter", l)
    lev = levels[l]
    if lev.P is None or l == len(levels) - 1:
        x = lev.coarse_solve(b)
        trace.stamp("leave", l)
        return x
    # pre-smooth (x None: a known-zero start, which the smoother makes
    # where it reads it)
    coarse = l >= params.cheby_coarse_from
    x = smooth(lev, b, x, params, zero_start=x is None, sweeps=params.nu1,
               coarse=coarse)
    # coarse-grid correction
    r = residual(lev.A, x, b)
    rc = spmv(lev.R, r)
    if shape == "V":
        ec = _cycle(levels, l + 1, rc, None, params, "V")
    elif shape == "W":
        ec = _cycle(levels, l + 1, rc, None, params, "W")
        ec = _cycle(levels, l + 1, rc, ec, params, "W")
    elif shape == "F":
        ec = _cycle(levels, l + 1, rc, None, params, "F")
        ec = _cycle(levels, l + 1, rc, ec, params, "V")
    else:
        raise ValueError(f"unknown cycle {shape!r}")
    x = x + spmv(lev.P, ec)
    x = smooth(lev, b, x, params, zero_start=False, sweeps=params.nu2,
               backward=True, coarse=coarse)
    trace.stamp("leave", l)
    return x


def make_cycle(params):
    """Return cycle(levels, b [, x0]) applying one AMG cycle as M^-1 b."""
    shape = params.cycle

    def cycle(levels, b, x0=None):
        return _cycle(levels, 0, b, x0, params, shape)

    return cycle
