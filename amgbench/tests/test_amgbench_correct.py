"""``correct`` on runs of the cells at a test size, the look for a card
skipped: sound runs pass; the control (the program's fp32-only path,
``control.lower_precision``) fails; and each fault a cell can have, put
into the timed path, fails: a Krylov step that leaves the state
unchanged (it counts the iteration, so the pass ends at its budget), and
a solution altered where the solver hands it out.  The other faults of
the contract have no place here: no batch (each request is one
right-hand side), no exchange between cards (one card)."""
from __future__ import annotations

import pytest
from conftest import small_spec

from amgbench import control, harness

CELLS = ["p3d192.rhs", "e3d40.rhs", "e3d40.resetup"]
SECONDS = {"p3d192.rhs": 0.6, "e3d40.rhs": 0.6, "e3d40.resetup": 1.0}


def run(workload, spec=None, seed=2 ** 31 + 11, device="cpu"):
    spec = spec or small_spec(workload)
    return harness.run_cell(spec, seed, SECONDS[workload], False, device)[0]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = run(workload)
    assert result["correct"], result
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["compared"]["relres_max"]["value"] < 1e-8
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    result = run(workload, control.lower_precision(small_spec(workload)))
    assert not result["correct"]
    assert result["compared"]["relres_max"]["value"] > 3e-8


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["p3d192.rhs", "e3d40.rhs"])
def test_control_on_the_card(workload):
    """The same on the card, at the test size (the cell's own size is
    run by ``amgbench/control.py``)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert run(workload, device="cuda")["correct"]
    bad = run(workload, control.lower_precision(small_spec(workload)),
              device="cuda")
    assert not bad["correct"]


def _step_leaves_state(monkeypatch):
    from sparsh_amg_tpu_torch.solve import solver

    def step_inplace(matvec, precond, method, _dot, rhat=None):
        def step(state):
            state[-1].add_(1)               # k: the pass ends at budget
        return step
    monkeypatch.setattr(solver, "step_inplace", step_inplace)


def _answer_altered(monkeypatch):
    from sparsh_amg_tpu_torch.solve.solver import AMGSolver
    fetch = AMGSolver._fetch

    def altered(self, x):
        get = fetch(self, x)

        def out():
            y = get()
            y[0] += 1.0
            return y
        return out
    monkeypatch.setattr(AMGSolver, "_fetch", altered)


@pytest.mark.parametrize("fault", [_step_leaves_state, _answer_altered],
                         ids=["step_leaves_state", "answer_altered"])
@pytest.mark.parametrize("workload", ["p3d192.rhs", "e3d40.resetup"])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    result = run(workload)
    assert not result["correct"]
    assert result["failed"] > 0
