"""The port's CLI (``python -m sparsh_amg_tpu_torch.cli``) on the CPU: every
``--krylov`` and ``--smoother`` solves and prints the JAX CLI's JSON keys,
a MatrixMarket matrix and right-hand side round-trip through
``utils/io``, a saved hierarchy reloads to the same solve, ``--profile``
writes a trace, and ``--dist`` and a missing GPU raise."""
import json
import os

import numpy as np
import pytest
import torch

from sparsh_amg_tpu import cli as jcli
from sparsh_amg_tpu_torch import cli
from sparsh_amg_tpu_torch.models import get_problem
from sparsh_amg_tpu_torch.utils import io


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: at these sizes it is faster than the default
    pool, and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = ["--problem", "poisson2d", "--n", "4096", "--coarse-size", "64",
         "--dense-size", "256", "--coarsening", "pmis",
         "--interpolation", "extpi", "--json"]


def _port(capsys, *extra):
    out = cli.run([*SMALL, "--device", "cpu", *extra])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed.keys() == out.keys() and printed["n"] == out["n"]
    return printed


@pytest.fixture(scope="module")
def jax_keys():
    return set(jcli.run([*SMALL, "--loop-mode", "device"]))


@pytest.mark.parametrize("flags", [
    ("--krylov", "cg"), ("--krylov", "bicgstab"), ("--krylov", "amg"),
    ("--smoother", "l1jacobi"), ("--smoother", "chebyshev"),
    ("--smoother", "gs2", "--krylov", "bicgstab", "--cycle", "W")])
def test_cli_solves_with_the_jax_keys(capsys, jax_keys, flags):
    got = _port(capsys, *flags)
    assert set(got) == jax_keys
    assert got["converged"] and got["relres"] <= 1e-8, got
    assert got["n"] == 4096 and got["levels"] >= 3


def test_cli_matrix_market_round_trip(capsys, tmp_path):
    prob = get_problem("poisson2d", n=4096)
    io.write_matrix(str(tmp_path / "A.mtx"), prob.A)
    io.write_rhs(str(tmp_path / "b.mtx"), prob.b)
    io.write_rhs(str(tmp_path / "b.txt"), prob.b)
    A = io.read_matrix(str(tmp_path / "A.mtx"))
    assert (A != prob.A).nnz == 0
    np.testing.assert_array_equal(io.read_rhs(str(tmp_path / "b.mtx"),
                                              n=4096), prob.b)
    np.testing.assert_allclose(io.read_rhs(str(tmp_path / "b.txt")), prob.b,
                               rtol=1e-15)
    with pytest.raises(ValueError):
        io.read_rhs(str(tmp_path / "b.mtx"), n=17)
    base = _port(capsys)
    got = _port(capsys, "--problem", str(tmp_path / "A.mtx"),
                "--rhs", str(tmp_path / "b.mtx"))
    assert got["problem"].endswith("A.mtx")
    assert (got["iterations"], got["refine_passes"], got["levels"]) == \
        (base["iterations"], base["refine_passes"], base["levels"])
    assert got["relres"] == pytest.approx(base["relres"], rel=1e-6)


def test_cli_hierarchy_save_and_load(capsys, tmp_path):
    path = str(tmp_path / "h.npz")
    saved = _port(capsys, "--save-hierarchy", path)
    assert os.path.getsize(path) > 0
    loaded = _port(capsys, "--load-hierarchy", path)
    for k in ("levels", "operator_complexity", "iterations",
              "refine_passes", "relres"):
        assert loaded[k] == saved[k], k


def test_cli_profile_writes_a_trace(capsys, tmp_path):
    got = _port(capsys, "--profile", str(tmp_path / "prof"))
    assert got["converged"]
    assert os.path.getsize(tmp_path / "prof" / "solve_trace.json") > 0


def test_cli_refuses_dist_and_a_missing_gpu():
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        cli.run([*SMALL, "--device", "cpu", "--dist", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.run(SMALL)                   # --device defaults to cuda
    args = cli.build_argparser().parse_args([])
    assert args.device == "cuda"
    assert not hasattr(args, "loop_mode") and not hasattr(args, "chunk")


def test_timing_utilities():
    """utils/timing.py: the phase timer accumulates, benchmark_op gives the
    median of wall-clock runs for CPU tensors, and the speed-of-light
    bound is bandwidth over bytes per nonzero."""
    from sparsh_amg_tpu_torch.utils.timing import (
        Timer, benchmark_op, speed_of_light_spmv_nnz_per_s)
    t = Timer()
    for _ in range(3):
        with t.phase("solve"):
            pass
    assert t.counts == {"solve": 3} and t.times["solve"] >= 0.0
    assert "solve" in t.report() and "(x3)" in t.report()
    calls = []
    x = torch.ones(1000)
    s = benchmark_op(lambda v: calls.append(1) or v * 2, x, warmup=2,
                     iters=5)
    assert len(calls) == 7 and 0.0 <= s < 1.0
    assert speed_of_light_spmv_nnz_per_s(3.35e12) == 3.35e12 / 12.0
