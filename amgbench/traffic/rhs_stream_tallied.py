"""Traffic kind ``rhs_stream_tallied``: ``rhs_stream`` with the port's
tallies recorded per request.

Set-up, the check, the release and the breakdown are ``rhs_stream``'s.
The window is ``rhs_stream.window`` unchanged, with each request's record
extended by ``tallies``: {name: increment} of every ``trace.Tally`` of the
port (``sparsh_amg_tpu_torch.utils.trace.tallies()``) from the request's
``solve`` call to its return; a tally the port lacks (``graph.kernels``
before it counted graph kernels) is not in the record.
"""
from __future__ import annotations

import os

from amgbench.harness import load_module

_rhs = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "rhs_stream.py"),
                   "amgbench_traffic_rhs_stream")
prepare, check = _rhs.prepare, _rhs.check
release, breakdown = _rhs.release, _rhs.breakdown


def _tallies() -> dict:
    from sparsh_amg_tpu_torch.utils import trace
    return {t.__name__: t.launches for t in trace.tallies()}


def window(run, seconds: float) -> None:
    solver = run.solver
    solve, record = solver.solve, run.solve_record
    before = {}

    def counted_solve(*args, **kwargs):
        before.clear()
        before.update(_tallies())
        return solve(*args, **kwargs)

    def tallied_record(res, wall_s, **extra):
        now = _tallies()
        return record(res, wall_s, tallies={
            k: v - before.get(k, 0) for k, v in now.items()}, **extra)

    solver.solve, run.solve_record = counted_solve, tallied_record
    try:
        _rhs.window(run, seconds)
    finally:
        del solver.solve, run.solve_record
