"""The benchmark's four-rank cell end to end on the CPU: the traffic kind
``rhs_stream_ranks`` through ``harness.run_cell`` on four gloo rank
processes at poisson3d(24).  Its answers pass the reference, every rank
took the same counts, the new per-layer metrics read, and the bytes of a
solve are ``work.solve_bytes`` over the ranks' block levels summed."""
from __future__ import annotations

import pytest
from ranks_cell import N, small_spec, traffic_kind

from amgbench import harness
from amgbench.work import levels_of, solve_bytes
from sparsh_amg_tpu_torch.params import AMGParams
from sparsh_amg_tpu_torch.setup.blocked import (blocked_amg_setup,
                                                partition_bounds)
from sparsh_amg_tpu_torch.setup.comm import run_blocked


@pytest.fixture(scope="module")
def cell():
    spec = small_spec()
    result, record = harness.run_cell(spec, 2 ** 33 + 11, 1.5, True, "cpu")
    return spec, result, record


def test_correct_and_in_lockstep(cell):
    spec, result, record = cell
    assert result["correct"], result
    assert result["failed"] == 0 and result["attempted"] >= 2, result
    assert result["compared"]["relres_max"]["value"] <= 1e-8
    # a request on which the ranks disagree is not ok (rhs_stream_ranks._merge)
    assert all(r["ok"] and "error" not in r for r in record["requests"])
    assert len({(r["iterations"], r["passes"])
                for r in record["requests"]}) == 1
    assert result["device"]["platform"] == "cpu"


def test_new_metrics_read(cell):
    spec, result, record = cell
    m = result["metrics"]
    assert m["blocked_setup_s"]["value"] > 0
    assert m["blocked_setup_s"]["value"] \
        == record["setup_spans"]["rank.blocked"]
    # every solve issues the same collectives: halos, all-reduces,
    # all-gathers, several an iteration
    per = {r["collectives"] for r in record["requests"]}
    assert len(per) == 1
    assert m["collectives_per_solve"]["value"] == per.pop()
    assert m["collectives_per_solve"]["value"] \
        > 3 * m["iterations_per_solve"]["value"]


def test_work_is_the_summed_block_levels(cell):
    """The blocked setup again, on four thread ranks in this process:
    the same block levels, summed, priced by work.solve_bytes."""
    spec, result, record = cell
    cfg = spec["config"]
    A = record_matrix(cfg)
    params = AMGParams(**cfg["amg"])
    n = A.shape[0]

    def rank(r, comm):
        bounds = partition_bounds(n, 4, 4, align=params.row_align)
        a, z = int(bounds[r]), int(bounds[r + 1])
        return blocked_amg_setup(
            A[a:z].tocsr(), bounds, comm, params,
            bounds_fn=lambda nc: partition_bounds(nc, 4, 4,
                                                  align=params.row_align))
    hs = run_blocked(rank, 4)
    levels = []
    for per in zip(*(h.levels for h in hs)):
        levels.append({"n": sum(l.r1 - l.r0 for l in per),
                       "nnz": sum(int(l.A.nnz) for l in per),
                       "P": (n_rows(per, "P"), per[0].P.shape[1],
                             sum(int(l.P.nnz) for l in per)),
                       "R": (n_rows(per, "R"), per[0].R.shape[1],
                             sum(int(l.R.nnz) for l in per))})
        assert levels[-1]["P"][0] == levels[-1]["n"]
    levels += levels_of(hs[0].tail)
    assert levels[0]["n"] == n and levels[0]["nnz"] == A.nnz
    want = solve_bytes(levels, cfg["amg"], cfg["krylov"])
    assert record["work"] == pytest.approx(want, rel=1e-15)
    assert traffic_kind().summed_levels([
        {"levels": [{"n": l.r1 - l.r0, "nnz": int(l.A.nnz),
                     "P": l.P.shape + (int(l.P.nnz),),
                     "R": l.R.shape + (int(l.R.nnz),)} for l in h.levels],
         "tail": levels_of(h.tail)} for h in hs]) == levels


def n_rows(per, name):
    return sum(getattr(l, name).shape[0] for l in per)


def record_matrix(cfg):
    A, _ = harness.build_problem(cfg)
    assert A.shape == (N ** 3, N ** 3)
    return A.tocsr()
