"""The pieces of the benchmark's four-rank cell that need no rank
process: each rank's rows of the matrix and of the right-hand sides are
the whole's, bit for bit; the ranks' requests merge into the harness's;
and the cards four rank processes report merge into the result line's
``device`` (``harness.merge_cards``, ``device_of``, with the CUDA queries
faked)."""
from __future__ import annotations

import os
import types

import numpy as np
import pytest
import torch
from ranks_cell import BENCH_DIR, N, small_spec, traffic_kind

from amgbench import harness
from amgbench.work import peak_bytes_per_s
from sparsh_amg_tpu_torch.setup.blocked import partition_bounds

H100 = "NVIDIA H100 80GB HBM3"
GIB = 2 ** 30


def _bounds(n: int, ranks: int = 4) -> list:
    return [int(b) for b in partition_bounds(n, ranks, ranks)]


@pytest.mark.parametrize("rank", range(4))
def test_rank_rows_are_the_generators_slice(rank):
    gen = harness.load_module(os.path.join(BENCH_DIR, "gen", "poisson3d.py"),
                              "g_p3d")
    rows = harness.load_module(
        os.path.join(BENCH_DIR, "gen", "poisson3d_rows.py"), "g_p3d_rows")
    A, _ = gen.build({"n": N})
    b = _bounds(N ** 3)
    r0, r1 = b[rank], b[rank + 1]
    assert r1 - r0 == N ** 3 // 4           # 6 planes a rank
    got, want = rows.rows({"n": N}, r0, r1), A[r0:r1]
    assert got.shape == want.shape == (r1 - r0, N ** 3)
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.indices.dtype == want.indices.dtype == np.int32
    assert got.data.dtype == want.data.dtype == np.float64


def test_the_cells_ranks_own_76_planes():
    n = 304
    b = _bounds(n ** 3)
    assert b == [r * 7_023_616 for r in range(5)]
    assert 7_023_616 == 76 * n * n


def test_rank_rhs_rows_are_the_checks_draw():
    """A rank's draw, cut to its rows, is Run.normal_vectors' cut."""
    spec = small_spec()
    run = harness.Run(spec, 2 ** 40 + 5, 1.0, "cpu")
    n = N ** 3
    whole = run.normal_vectors(1, 6, n)
    b = _bounds(n)
    for r in range(4):
        got = traffic_kind().draw_rows(run.seed, 1, 6, n, b[r], b[r + 1],
                                 torch.device("cpu"))
        assert got.flags.c_contiguous
        assert np.array_equal(got, whole[:, b[r]:b[r + 1]])


def _req(iters, passes, ms, converged=True):
    return {"ok": True, "wall_s": 0.1, "converged": converged,
            "iterations": iters, "passes": passes, "host_reads": passes,
            "pass_ms": ms, "collectives": 7, "rhs": 0}


def test_merge_takes_rank_0_and_the_ranks_mean():
    outs = [{"requests": [_req(12, 2, [3.0, 1.0]), _req(12, 2, [2.0, 2.0])]},
            {"requests": [_req(12, 2, [5.0, 3.0]), _req(13, 2, [2.0, 2.0])]}]
    got = traffic_kind()._merge(outs)
    assert got[0]["pass_ms"] == [4.0, 2.0] and got[0]["ok"]
    assert got[0]["wall_s"] == 0.1 and got[0]["collectives"] == 7
    assert not got[1]["ok"] and "disagree" in got[1]["error"]
    outs[1]["requests"].pop()
    with pytest.raises(RuntimeError, match="lockstep"):
        traffic_kind()._merge(outs)


def test_four_rank_reports_merge_into_four_cards(monkeypatch):
    """Each rank's ``card_report`` (CUDA queries faked) and the harness's
    own card, which is rank 0's: four cards, the fullest one's peaks, the
    rate of four."""
    uuids = iter([f"GPU-{r}" for r in range(4)] + ["GPU-0"])
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(uuid=next(uuids)))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: H100)
    reports = [harness.card_report(torch.device("cuda", r), (r + 1) * GIB,
                                   (4 - r) * GIB) for r in range(4)]
    own = harness.card_report(torch.device("cuda", 0), 6 * GIB, 0)
    device, window_peak, rate = harness.device_of([own] + reports)
    assert device["count"] == 4 and device["kind"] == H100
    assert device["memory_peak_bytes"] == 6 * GIB   # card 0's set-up
    assert window_peak == 4 * GIB                   # rank 0's window
    assert rate == pytest.approx(4 * peak_bytes_per_s(H100), rel=1e-15)
    assert sorted(c["uuid"] for c in device["cards"]) == [
        f"GPU-{r}" for r in range(4)]
