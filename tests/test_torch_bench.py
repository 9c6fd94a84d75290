"""The port's bench entry points on the CPU (``--device cpu``, the plain
versions): ``bench_torch.py`` prints one line with ``bench.py``'s keys
(but for its loop-placement A/B's) and the port's own, passes its
checks, and runs every acceptance configuration (``--config``) at a
small size; its checks fail a line that
misses its reference; ``kernel_bench_torch.py`` gives a row for the fine
operator, both fine transfers and the V-cycle; ``--dist N`` prints rank
0's line of N gloo ranks; NCCL without a card per rank and a missing GPU
raise.  This file
imports no jax: ``bench.py`` is read, not run."""
import ast
import json
import pathlib

import pytest
import torch

import bench_torch
import kernel_bench_torch
from sparsh_amg_tpu_torch import flagship

ROOT = pathlib.Path(__file__).resolve().parents[1]
# bench.py's keys of its loop-placement A/B: the port has one placement
LOOP_KEYS = {"loop_mode", "loop_mode_ab_s", "dispatch_rtt_ms"}
ADDED_KEYS = {"relres_host_fp64", "device_name", "power_limit_w",
              "setup_peak_bytes", "solve_peak_bytes",
              "solve_peak_reserved_bytes", "history", "launches",
              "bytes_per_nnz", "host_reads", "capture_s", "instantiate_s",
              "pass_graph_s", "reference", "checks", "ok"}
DEVICE_KEYS = {"vs_baseline", "hbm_bw_GBs", "hbm_bw_spec_GBs",
               "speed_of_light_nnz_per_s", "vs_spec", "hbm_fraction",
               "hbm_fraction_spec", "device_name", "power_limit_w",
               "setup_peak_bytes", "solve_peak_bytes",
               "solve_peak_reserved_bytes", "bytes_in_use",
               "peak_bytes_in_use", "bytes_limit"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these sizes it is faster than the default
    pool, and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bench_py_keys():
    """The keys bench.py's line can hold: the literal keys of its `out`
    dict, the keys it adds to `out` later, and those it splices in
    (setup_parts, the allocator stats)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = {"amg_setup_s", "to_device_s", "loop_mode_ab_s", "bytes_in_use",
            "peak_bytes_in_use", "bytes_limit"}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "out"):
            keys |= {k.value for k in node.value.keys if k is not None}
        if (isinstance(node, ast.Subscript)
                and getattr(node.value, "id", None) == "out"
                and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def _run(capsys, *argv):
    out = bench_torch.main([*argv, "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    return out


def test_bench_flagship_line(capsys):
    """The line holds bench.py's keys but for its loop-placement A/B's,
    and the port's own."""
    out = _run(capsys, "--n", "16")
    want = (bench_py_keys() - LOOP_KEYS) | ADDED_KEYS
    assert LOOP_KEYS <= bench_py_keys() and not LOOP_KEYS & set(out)
    assert len(want) > 35 and want <= set(out), want - set(out)
    assert out["ok"] and out["checks"] == {
        "converged": True, "relres_host_fp64": True}
    assert out["capture_s"] == out["instantiate_s"] == 0.0   # CPU: eager
    assert out["pass_graph_s"] == 0.0
    # on the CPU the passes run eagerly: the guard is read after every
    # step, prog once a pass
    assert out["host_reads"] == out["iterations"] + 2 * out["refine_passes"]
    assert out["metric"] == "amg_pcg_poisson3d_spmv_throughput"
    assert out["unit"] == "nnz/s" and out["value"] > 0
    assert out["reference"] is None          # no count reference at 16^3
    assert out["backend"] == "cpu" and out["n"] == 16 ** 3
    assert out["relres_host_fp64"] <= 1e-8
    assert out["solve_s"] == min(out["solve_s_runs"])
    assert sum(it for it, _ in out["history"]) == out["iterations"]
    assert len(out["history"]) == out["refine_passes"]
    assert all(out[k] is None for k in DEVICE_KEYS)
    assert set(out["launches"]) >= {"dia_spmv", "dia_cheb_step", "ell_spmv"}
    assert not any(out["launches"].values())  # plain versions on the CPU
    assert sum(r["total"] for r in out["device_bytes_by_level"]) == \
        out["device_bytes"]
    assert 5.0 < out["bytes_per_nnz"] < 5.5
    assert out["bytes_per_iter"] > 0 and out["spmv_equiv_per_iter"] > 1


def test_bench_flagship_parameters_are_bench_pys():
    """The flagship's parameters are bench.py:137-170's, its loop the
    device loop, and only the flagship at 192 is held to BENCH_r05.json's
    12 iterations / 2 passes (a device-mode count)."""
    args = bench_torch.build_argparser().parse_args([])
    _, _, params, krylov, ref, _ = bench_torch._case(args, None)
    want = dict(smoother="chebyshev", cycle="V", band_dtype="bfloat16",
                coarsening="pmis", interpolation="extpi", dense_size=2048,
                cheby_degree_coarse=1, cheby_coarse_from=1, interp_max=4,
                rap_drop_tol=0.01, agg_levels=1, interp_max_composed=5,
                intermediate_drop_tol=0.02, aggressive="pmis2")
    assert params == flagship.params().replace(**want)
    assert (krylov.method, krylov.tol, krylov.loop_mode) == \
        ("cg", 1e-8, "device")
    assert (ref["iterations"], ref["refine_passes"],
            ref["iteration_slack"]) == (12, 2, 1)
    args = bench_torch.build_argparser().parse_args(["--n", "96"])
    assert bench_torch._case(args, None)[4] is None


# every configuration bench_torch.py takes, at a small side with at least
# two levels
CONFIG_SIDES = [("poisson2d_1024_wjacobi_V_cg", "48"), ("elasticity3d", "4"),
                ("aniso2d_1024_eps1e-3_rot45_aggW_bicgstab", "48"),
                ("aniso2d_2048_eps1e-3_rot45_aggW_bicgstab", "48"),
                ("aniso2d_1024_pmis_extpi_W_gs2_bicgstab", "48"),
                ("convection3d_96_pmis_extpi_V_bicgstab", "12"),
                ("jump2d_1024_random_1e4_V_cg", "48"),
                ("delaunay_1024sq_rcm_l1jac_V_cg", "64"),
                ("elasticity2d", "16")]


def test_bench_config_sides_cover_every_configuration():
    from sparsh_amg_tpu_torch import configs
    assert {c for c, _ in CONFIG_SIDES} == {*configs.NAMES,
                                            *bench_torch.SYSTEMS}


@pytest.mark.parametrize("config,n", CONFIG_SIDES)
def test_bench_config_line(capsys, config, n):
    """Each configuration's line at a small side: ok, its method's metric,
    at least two levels, no count reference (not the configuration's own
    size), the passes run eagerly on the CPU."""
    from sparsh_amg_tpu_torch import configs
    out = _run(capsys, "--config", config, "--n", n, "--dense-size", "64")
    assert out["ok"] and out["config"] == config
    method = "cg" if config in bench_torch.SYSTEMS \
        else configs.krylov(config).method
    assert out["metric"] == \
        f"amg_{'pcg' if method == 'cg' else method}_{config}_spmv_throughput"
    assert len(out["device_ops"]) == out["levels"] >= 2
    assert out["reference"] is None
    assert out["host_reads"] == out["iterations"] + 2 * out["refine_passes"]
    if config.startswith("elasticity"):
        assert "BlockEllMatrix" in out["device_ops"]


def test_bench_config_reference_at_full_size():
    """A configuration at its own size is held to configs.held_counts
    with configs.iteration_slack (aniso-gs2 to the port's plain count)."""
    name = "aniso2d_1024_pmis_extpi_W_gs2_bicgstab"
    args = bench_torch.build_argparser().parse_args(["--config", name])
    _, _, _, krylov, ref, metric = bench_torch._case(args, None)
    assert krylov.method == "bicgstab"
    assert metric == f"amg_bicgstab_{name}_spmv_throughput"
    assert (ref["iterations"], ref["refine_passes"],
            ref["iteration_slack"]) == (38, 2, 2)
    assert "port_cpu" in ref["source"]


@pytest.mark.parametrize("change,ok", [
    ({}, True), ({"iterations": 14}, False), ({"iterations": 13}, True),
    ({"refine_passes": 3}, False), ({"relres_host_fp64": 2e-8}, False),
    ({"converged": False}, False), ({"hbm_bw_GBs": 3400.0}, False)])
def test_bench_checks_fail_a_line_off_its_reference(change, ok):
    """The counts are held to the reference's passes and its iterations
    within the slack."""
    line = {"converged": True, "relres_host_fp64": 9e-10, "iterations": 12,
            "refine_passes": 2, "hbm_bw_GBs": 3000.0,
            "hbm_bw_spec_GBs": 3350.0,
            "reference": {"iterations": 12, "refine_passes": 2,
                          "iteration_slack": 1}}
    assert all(bench_torch.checks({**line, **change}, 1e-8).values()) == ok


def test_kernel_bench_rows(capsys):
    out = kernel_bench_torch.main(["--n", "16", "--device", "cpu"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[0] == json.loads(json.dumps(out["copy_bw"]))
    assert out["ok"] and out["copy_bw"]["GBs"] is None
    rows = {r["kernel"]: r for r in out["rows"]}
    assert {"spmv_l0", "P_l0", "R_l0", "vcycle"} <= set(rows)
    assert rows["spmv_l0"]["layout"] == "dia"
    assert rows["P_l0"]["layout"] == rows["R_l0"]["layout"] == "ell"
    for r in out["rows"]:
        assert r["per_op_ms"] > 0 and r["nnz"] > 0
        assert 0 < r["bytes_per_op"] <= r["bytes_per_op_padded"]
        assert r["hbm_frac"] is None and r["hbm_frac_spec"] is None
    assert rows["vcycle"]["nnz"] > rows["spmv_l0"]["nnz"]


@pytest.mark.parametrize("flag", [("--loop-mode", "host"), ("--chunk", "12")])
def test_bench_refuses_the_placement_flags(flag, capsys):
    """bench_torch.py has no loop placement to choose: --loop-mode and
    --chunk are refused as unknown arguments."""
    with pytest.raises(SystemExit):
        bench_torch.build_argparser().parse_args(list(flag))
    assert "unrecognized arguments" in capsys.readouterr().err


def test_dist_and_missing_gpu_raise():
    """--dist on NCCL needs a card per rank: on the CPU it raises, naming
    gloo; without a GPU the default device raises."""
    with pytest.raises(ValueError, match='backend="gloo"'):
        bench_torch.main(["--dist", "2", "--dist-backend", "nccl",
                          "--device", "cpu"])
    if torch.cuda.is_available():
        return
    for main in (bench_torch.main, kernel_bench_torch.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["--n", "8"])


@pytest.mark.parametrize("ranks", [1, 2])
def test_bench_dist_line(capsys, ranks):
    """--dist N on the CPU: rank 0 prints the serial line's keys plus the
    ranks and the backend, passes the serial line's checks with its
    counts; bytes are priced on one rank's layouts only."""
    serial = _run(capsys, "--n", "16")
    out = _run(capsys, "--n", "16", "--dist", str(ranks))
    assert set(serial) | {"dist_ranks", "dist_backend", "dist_capture",
                          "rank_solve_s", "device_ops"} == set(out)
    assert (out["dist_ranks"], out["dist_backend"]) == (ranks, "gloo")
    assert out["dist_capture"] == (ranks == 1)
    assert len(out["rank_solve_s"]) == ranks
    assert out["rank_solve_s"][0] == out["solve_s"]
    assert out["ok"] and out["checks"] == serial["checks"]
    assert abs(out["iterations"] - serial["iterations"]) <= 1
    assert out["refine_passes"] == serial["refine_passes"]
    assert out["device_ops"][0] == "DistDia"
    assert (out["bytes_per_nnz"] is None) == (ranks > 1)
    assert out["value"] > 0 and not any(out["launches"].values())


def test_timed_solves_start_from_the_primed_solver():
    """bench_torch.py times each solve on a shallow copy of the primed
    solver: a copy's solve learns the fp32 floor estimate (here inner
    passes asked for 1e-8 undershoot it) and the primed solver does not,
    so every timed solve is the first after priming."""
    import copy
    import dataclasses
    import numpy as np
    from sparsh_amg_tpu_torch import AMGSolver
    from sparsh_amg_tpu_torch.models import poisson3d
    A = poisson3d(12)
    solver = AMGSolver(A, flagship.params(dense_size=256),
                       dataclasses.replace(flagship.krylov(), inner_tol=1e-8),
                       device="cpu")
    rhs = solver.prepare_rhs(np.random.default_rng(0).standard_normal(
        A.shape[0]))
    solver.solve(rhs, tol=1e-2)
    primed = solver._floor_est
    timed = copy.copy(solver)
    timed.solve(rhs, tol=1e-13)
    assert timed._floor_est is not None and timed._floor_est != primed
    assert solver._floor_est == primed
