"""The benchmark's rotated-anisotropy cell ``aniso2048.rhs`` on the CPU at
test sizes: its frozen generator against the port's, its configuration
file against ``configs.py``, the port's W-cycle and BiCGStab against the
plain float64 reference ``amgbench/reference/wcycle.py``, and the traffic
kind ``rhs_stream_tallied`` with the metric ``kernels_per_iteration``."""
from __future__ import annotations

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from amgbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "amgbench")
CELL = "aniso2048.rhs"
NAME = "aniso2d_2048_eps1e-3_rot45_aggW_bicgstab"

# The port's cycle runs on fp32 levels (an fp32 explicit coarse inverse
# among them), the reference in float64, so the two differ by fp32
# rounding amplified by the operator's conditioning.  Most of it lies in
# the smooth modes the coarse solve carries, which grow with the grid
# (the plain 2-norm difference: 1.8e-5 at 64^2, 4.4e-4 at 256^2, 2.1e-2 at
# 2048^2) and which A damps.  So the comparison is in the residual space
# the Krylov method sees, ||A (y - y_ref)|| / ||A y_ref||: 2.5e-6 at
# 64^2, 3.6e-5 at 256^2, 1.8e-4 at 512^2.  A V-cycle in the W-cycle's
# place differs there by 0.1 and more at every size from 64^2 to 512^2,
# the plain weighted-Jacobi smoother by 0.22 and more.
CYCLE_RTOL = 1e-2


def residual_difference(wc, A, got: torch.Tensor, want: torch.Tensor):
    """||A (got - want)|| / ||A want|| in float64, A as the reference
    module `wc` takes it (got, want: float64 on one device)."""
    Ar = wc.csr(A, want.device)
    return float(torch.linalg.vector_norm(wc.mv(Ar, got - want))
                 / torch.linalg.vector_norm(wc.mv(Ar, want)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: at these sizes it is faster than the default
    pool, and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module(path: str, name: str):
    return harness.load_module(os.path.join(BENCH_DIR, path), name)


def _bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def small_spec(m: int = 32) -> dict:
    """The cell at aniso2d(m): no cache, coarsening down to 64 rows and
    dense levels below 64 rows (a W-cycle over several levels), a short
    iteration budget."""
    spec = copy.deepcopy(harness.load_cell(_bench(), CELL))
    cfg = spec["config"]
    cfg["size"] = dict(cfg["size"], m=m)
    cfg["cache"] = False
    cfg["amg"].update(dense_size=64, coarse_size=64)
    cfg["krylov"]["maxiter"] = 60
    return spec


@pytest.mark.parametrize("nx,ny,angle", [(5, 5, 45.0), (16, 16, 45.0),
                                         (7, 12, 45.0), (9, 6, 30.0),
                                         (6, 9, 0.0)])
def test_generator_is_the_ports(nx, ny, angle):
    from sparsh_amg_tpu_torch.models.anisotropic import anisotropic2d
    gen = _module("gen/anisotropic2d.py", "amgbench_gen_anisotropic2d")
    A, ns = gen.build({"m": nx, "ny": ny, "epsilon": 1e-3,
                       "angle_deg": angle})
    B = anisotropic2d(nx, ny, epsilon=1e-3, angle_deg=angle)
    B.sort_indices()
    assert ns is None and A.shape == B.shape
    np.testing.assert_array_equal(A.indptr, B.indptr)
    np.testing.assert_array_equal(A.indices, B.indices)
    np.testing.assert_array_equal(A.data, B.data)
    assert A.data.dtype == np.float64 and A.indices.dtype == np.int32


def test_configuration_is_the_ports():
    """The file holds configs.py's recipe for the configuration, every
    field, at the reference's size."""
    from sparsh_amg_tpu_torch import configs
    cfg = harness.load_cell(_bench(), CELL)["config"]
    assert cfg["amg"] == dataclasses.asdict(configs.params(NAME))
    assert cfg["krylov"] == dataclasses.asdict(configs.krylov(NAME))
    assert cfg["tol"] == 1e-8 and cfg["reduced"] == [] and cfg["cache"]
    assert cfg["size"] == {"m": configs.SIZES[NAME], "epsilon": 1e-3,
                           "angle_deg": 45.0}
    ref = configs.REFERENCE[NAME]
    assert (cfg["unknowns"], cfg["nnz"]) == (ref["n"], ref["nnz"])


@pytest.fixture(scope="module")
def aniso64():
    """The port's solver of the cell's configuration at aniso2d(64) on the
    CPU (five levels: three DIA, one sliced ELL, the last dense with its
    inverse), and the reference's W-cycle over the same host
    hierarchy."""
    from sparsh_amg_tpu_torch import AMGSolver
    from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
    cfg = small_spec(64)["config"]
    gen = _module("gen/anisotropic2d.py", "amgbench_gen_anisotropic2d")
    A, _ = gen.build(cfg["size"])
    amg = AMGParams(**cfg["amg"])
    solver = AMGSolver(A, amg, KrylovParams(**cfg["krylov"]), device="cpu")
    assert solver.perm is None
    wc = _module("reference/wcycle.py", "amgbench_reference_wcycle")
    levels = [(lev.A, lev.P, lev.R) for lev in solver.hierarchy.levels]
    assert len(levels) == 5
    return A, amg, solver, wc, wc.WCycle(levels, amg.nu1, amg.nu2)


@pytest.mark.parametrize("variant", ["W", "V", "jacobi"])
def test_port_cycle_matches_the_reference(aniso64, variant):
    """One application of the port's preconditioner (its W-cycle on the
    frozen levels) is the reference's to CYCLE_RTOL in the residual space;
    a V-cycle or plain Jacobi in its place is not."""
    from sparsh_amg_tpu_torch.solve.cycles import make_cycle
    A, amg, solver, wc, ref = aniso64
    n = A.shape[0]
    b = np.random.default_rng(7).standard_normal(n)
    bp = torch.zeros(solver.n_pad, dtype=torch.float32)
    bp[:n] = torch.from_numpy(b).float()
    params = {"W": amg, "V": dataclasses.replace(amg, cycle="V"),
              "jacobi": dataclasses.replace(amg, smoother="jacobi")}[variant]
    got = make_cycle(params)(solver.device.levels, bp)
    want = ref(torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert torch.count_nonzero(got[n:]) == 0
    err = residual_difference(wc, A, got[:n].double(), want)
    if variant == "W":
        assert err <= CYCLE_RTOL, err
    else:
        assert err > CYCLE_RTOL, err


def test_solve_agrees_with_reference_bicgstab(aniso64):
    """A primed solve to 1e-8 (the cell's) takes the reference's
    iterations within configs.iteration_slack, and both answers meet 1e-8
    in float64."""
    from sparsh_amg_tpu_torch import configs
    A, _, solver, wc, ref = aniso64
    b = np.random.default_rng(11).standard_normal(A.shape[0])
    x_ref, k_ref, breakdown = wc.bicgstab(A, torch.from_numpy(b), ref,
                                          tol=1e-8, maxiter=400)
    solver.solve(b, tol=1e-2)
    res = solver.solve(b)
    assert res.converged and not breakdown
    assert abs(res.iterations - k_ref) <= configs.iteration_slack(NAME), \
        (res.iterations, k_ref)
    for x in (res.x, x_ref.numpy()):
        assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8


def test_eager_solve_counts_no_graph_kernels(aniso64):
    """graph.kernels counts captured graphs' kernels: an eager solve (the
    CPU's) adds nothing."""
    from sparsh_amg_tpu_torch.solve.graphs import GRAPH_KERNELS
    from sparsh_amg_tpu_torch.utils import trace
    A, _, solver, _, _ = aniso64
    assert GRAPH_KERNELS in trace.tallies()
    assert GRAPH_KERNELS.__name__ == "graph.kernels"
    before = GRAPH_KERNELS.launches
    res = solver.solve(np.ones(A.shape[0]))
    assert res.iterations > 0 and GRAPH_KERNELS.launches == before


@pytest.mark.parametrize("control", [False, True])
def test_correct_holds_the_cell_to_fp64(aniso64, control):
    """The residual ``correct`` compares (``reference/residual.py``, fp64,
    limit 1e-8) passes the cell's solve at aniso2d(64) and refuses its
    control, the port's fp32-only path (``amgbench/control.py``: one fp32
    BiCGStab pass to tol, whose true residual stalls near 1e-6).  Judged
    on one solve, not on a wall-clock window's kept requests."""
    from amgbench import control as ctl
    from sparsh_amg_tpu_torch import AMGSolver
    from sparsh_amg_tpu_torch.params import KrylovParams
    A, amg, solver, _, _ = aniso64
    residual = _module("reference/residual.py", "amgbench_reference_residual")
    if control:
        cfg = ctl.lower_precision(small_spec(64))["config"]
        solver = AMGSolver(A, amg, KrylovParams(**cfg["krylov"]),
                           device="cpu")
    b = np.random.default_rng(13).standard_normal(A.shape[0])
    solver.solve(b, tol=1e-2)
    relres = residual.relres(A, solver.solve(b).x, b)
    if control:
        assert relres > 1e-7, relres
    else:
        assert relres < 1e-8, relres


KERNELS_A_STEP = 7


@pytest.fixture(scope="module")
def tallied_cell():
    """The cell at aniso2d(32) on the CPU with --trace 1, each solve adding
    KERNELS_A_STEP kernels an iteration to graph.kernels (the CPU
    captures nothing, so the test stands in for the card's replays)."""
    from sparsh_amg_tpu_torch import AMGSolver
    from sparsh_amg_tpu_torch.solve.graphs import GRAPH_KERNELS
    real = AMGSolver.solve

    def solve(self, *args, **kwargs):
        res = real(self, *args, **kwargs)
        GRAPH_KERNELS.add(KERNELS_A_STEP * res.iterations)
        return res
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(AMGSolver, "solve", solve)
        result, record = harness.run_cell(small_spec(32), 2 ** 33 + 26, 0.5,
                                          True, "cpu")
    return result, record


def test_tallied_window_records_each_request(tallied_cell):
    _, record = tallied_cell
    done = [r for r in record["requests"] if r["ok"]]
    assert done
    for r in done:
        assert r["tallies"]["graph.kernels"] \
            == KERNELS_A_STEP * r["iterations"]
        assert r["iterations"] > 0 and r["passes"] >= 1


def test_kernels_per_iteration_reads_the_tally(tallied_cell):
    result, record = tallied_cell
    assert result["metrics"]["kernels_per_iteration"] == {
        "value": float(KERNELS_A_STEP), "unit": "kernel/iter"}
    for name in ("iterations_per_solve", "host_reads_per_solve"):
        assert name in result["metrics"]


@pytest.mark.parametrize("requests", [
    [], [{"ok": True, "iterations": 24}],
    [{"ok": True, "iterations": 24, "tallies": {"dist.collectives": 3}}],
    [{"ok": False, "tallies": {"graph.kernels": 10}}]])
def test_kernels_per_iteration_without_the_tally(requests):
    reader = _module("metrics/kernels_per_iteration.py",
                     "amgbench_metric_kernels_per_iteration")
    assert reader.read({"requests": requests}) is None


def test_kernels_per_iteration_sums_over_requests():
    reader = _module("metrics/kernels_per_iteration.py",
                     "amgbench_metric_kernels_per_iteration")
    reqs = [{"ok": True, "iterations": 24, "tallies": {"graph.kernels": 2400}},
            {"ok": True, "iterations": 26, "tallies": {"graph.kernels": 2700}},
            {"ok": False, "wall_s": 1.0}]
    assert reader.read({"requests": reqs}) == 5100 / 50


def test_tallied_mix_is_rhs_streams():
    """The mix's parameters are rhs-stream's; only its kind differs."""
    def mix(name):
        with open(os.path.join(BENCH_DIR, "traffic", name + ".json")) as f:
            return json.load(f)
    a, b = mix("rhs-stream"), mix("rhs-stream-tallied")
    assert b["kind"] == "rhs_stream_tallied"
    drop = ("kind", "about")
    assert {k: v for k, v in a.items() if k not in drop} \
        == {k: v for k, v in b.items() if k not in drop}


def test_trace_cell_splits_the_w_cycle():
    """``scripts/torch_trace_cell.py`` runs the cell (its kind wraps
    rhs_stream's window, and the tracer wraps the cell's kind once): the
    stamps split the steps by level, two preconditioner applications an
    iteration, each level of the W-cycle visited twice as often as the
    one above it."""
    from sparsh_amg_tpu_torch.utils import trace
    path = os.path.join(ROOT, "scripts", "torch_trace_cell.py")
    tool = harness.load_module(path, "torch_trace_cell")
    try:
        out = tool.run(small_spec(32), 2 ** 33 + 27, 1.0, "cpu")
    finally:
        trace.disable()
        trace.reset()
    tr = out["trace"]
    assert tr["split"]["cycles"] == 2 * tr["iterations"] > 0
    levels = len(tr["level_bytes"])
    assert levels >= 3 and len(tr["level_ms_per_iter"]) == levels
    assert all(v > 0 for v in tr["level_ms_per_iter"])
    assert tr["metrics"]["krylov_ms_per_iter"] > 0
    assert "kernels_per_iteration" in out["metrics"]
