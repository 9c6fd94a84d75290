"""The cards a run used: ``harness.card_report`` of the harness's own card
and of each rank process (``Run.cards``), merged by UUID
(``merge_cards``) into the result line's ``device`` and the record's
peak and rate (``device_of``); ``run.py`` refuses a run that used fewer
cards than its cell asks for.  On the CPU the CUDA queries are faked;
the ``gpu`` tests start real rank processes on the card."""
from __future__ import annotations

import json
import os
import shutil
import types

import pytest
import torch
from conftest import ROOT, small_spec
from test_amgbench_files import BENCH_DIR, _digest

from amgbench import harness
from amgbench.work import peak_bytes_per_s

H100 = "NVIDIA H100 80GB HBM3"
GIB = 2 ** 30


def report(uuid, setup, window, kind=H100):
    return {"uuid": uuid, "kind": kind, "setup_peak_bytes": setup,
            "window_peak_bytes": window}


FOUR = [report(f"GPU-{r}", (r + 1) * GIB, (2 * r + 1) * GIB)
        for r in range(4)]
CASES = {
    # (rank reports, count, memory peak, window peak, cards priced)
    "four cards": (FOUR, 4, 7 * GIB, 7 * GIB, 4),
    "two ranks on one card": (
        [report("GPU-0", 5 * GIB, GIB), report("GPU-0", GIB, 3 * GIB),
         report("GPU-1", GIB, 2 * GIB)], 2, 5 * GIB, 3 * GIB, 2),
    "a card unused in the window": (
        [report("GPU-0", GIB, 2 * GIB), report("GPU-1", 9 * GIB, 0)],
        1, 2 * GIB, 2 * GIB, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_counts_each_card_used_once(case):
    reports, count, memory, window, priced = CASES[case]
    device, window_peak, rate = harness.device_of(reports)
    assert device["platform"] == "gpu" and device["kind"] == H100
    assert device["count"] == count
    assert device["memory_peak_bytes"] == memory
    assert window_peak == window
    assert rate == pytest.approx(priced * peak_bytes_per_s(H100), rel=1e-15)
    assert ("cards" in device) == (count > 1)
    if count > 1:
        assert len({c["uuid"] for c in device["cards"]}) == count


def test_merge_refuses_two_kinds():
    with pytest.raises(harness.CardError, match="2 kinds"):
        harness.device_of([report("GPU-0", GIB, GIB),
                           report("GPU-1", GIB, GIB, "NVIDIA A100")])


def test_no_card_reported_is_the_cpu():
    assert harness.device_of([]) == (
        {"platform": "cpu", "kind": "cpu", "count": 0,
         "memory_peak_bytes": 0}, 0, None)


def test_card_report_reads_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(uuid="GPU-abc"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: H100)
    r = harness.card_report(torch.device("cuda", 0), 3.0, 7)
    assert r == report("GPU-abc", 3, 7)
    assert json.loads(json.dumps(r)) == r


# --- run_cell with its own card faked: a driver that only reports cards

FAKE_DRIVER = '''"""Traffic kind fake_cards: no work; the rank reports of the mix."""


def prepare(run):
    run.work = {"iteration": 1e9, "pass": 1e8}


def window(run, seconds):
    run.requests = [{"ok": True, "converged": True, "wall_s": 0.5,
                     "iterations": 10, "passes": 2, "host_reads": 2,
                     "pass_ms": [400.0, 100.0]}]
    run.window_s = 0.5
    run.cards = list(run.traffic["cards"])


def check(run):
    return [{"name": "relres_max", "value": 0.0, "limit": 1e-8}], set()
'''


def fake_cell(tmp_path, cards):
    copy = tmp_path / "amgbench"
    shutil.copytree(BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (copy / "traffic" / "fake_cards.py").write_text(FAKE_DRIVER)
    spec = small_spec("p3d192.rhs")
    spec["traffic"] = {"kind": "fake_cards", "cards": cards}
    return spec, str(copy)


def fake_own_card(monkeypatch, setup_peak, window_peak, uuid="GPU-own"):
    peaks = iter([setup_peak, window_peak])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda d=None: None)
    monkeypatch.setattr(torch.cuda, "max_memory_reserved",
                        lambda d=None: next(peaks))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(uuid=uuid))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: H100)
    monkeypatch.setattr(harness.card_info, "name_and_power_limit",
                        lambda: (H100, 700.0))


def test_run_cell_without_rank_reports_is_the_own_card(tmp_path,
                                                        monkeypatch):
    """No ``run.cards``: the parent's device, peak and rate, as the parent
    computed them."""
    spec, copy = fake_cell(tmp_path, [])
    setup_peak, window_peak = 5 * GIB + 12345, 4 * GIB + 678
    fake_own_card(monkeypatch, setup_peak, window_peak)
    result, record = harness.run_cell(spec, 3, 0.5, False, "cuda",
                                      bench_dir=copy)
    assert result["device"] == {"platform": "gpu", "kind": H100,
                                "count": 1,
                                "memory_peak_bytes": int(max(setup_peak,
                                                             window_peak))}
    assert record["device_peak_bytes"] == window_peak
    assert record["peak_bytes_per_s"] == peak_bytes_per_s(H100)
    assert result["metrics"]["device_peak_gib"]["value"] \
        == window_peak / GIB
    assert result["card"] == {"nvidia_smi_name": H100,
                              "power_limit_w": 700.0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_cell_merges_rank_reports(tmp_path, monkeypatch, case):
    """The harness's own card held nothing in the window (not a rank):
    the ranks' cards alone."""
    reports, count, memory, window, priced = CASES[case]
    spec, copy = fake_cell(tmp_path, reports)
    fake_own_card(monkeypatch, 0, 0)
    result, record = harness.run_cell(spec, 3, 0.5, True, "cuda",
                                      bench_dir=copy)
    assert result["device"]["count"] == count
    assert result["device"]["memory_peak_bytes"] == memory
    assert record["device_peak_bytes"] == window
    one = dict(record, peak_bytes_per_s=peak_bytes_per_s(H100))
    one_card = harness.read_metrics(spec["per_layer"], one, copy)
    assert result["metrics"]["solve_roofline_pct"]["value"] == pytest.approx(
        one_card["solve_roofline_pct"]["value"] / priced, rel=1e-12)


def test_run_cell_own_card_shared_with_a_rank(tmp_path, monkeypatch):
    """The harness's own card is also rank 0's: one card, its largest
    peaks."""
    spec, copy = fake_cell(tmp_path, FOUR)
    fake_own_card(monkeypatch, 6 * GIB, 8 * GIB, uuid="GPU-0")
    result, record = harness.run_cell(spec, 3, 0.5, False, "cuda",
                                      bench_dir=copy)
    assert result["device"]["count"] == 4
    assert result["device"]["memory_peak_bytes"] == 8 * GIB
    assert result["metrics"]["device_peak_gib"]["value"] == 8.0
    assert record["peak_bytes_per_s"] == pytest.approx(
        4 * peak_bytes_per_s(H100), rel=1e-15)


def test_run_cell_fails_on_two_kinds(tmp_path, monkeypatch):
    spec, copy = fake_cell(tmp_path, [report("GPU-1", GIB, GIB, "X")])
    fake_own_card(monkeypatch, GIB, GIB)
    with pytest.raises(harness.CardError):
        harness.run_cell(spec, 3, 0.5, False, "cuda", bench_dir=copy)


# --- a traffic kind added as files only reports four cards

FOUR_RANKS = '''"""Traffic kind rhs_four: the requests of rhs_stream, with the card
reports of four rank processes; on the CPU no pass graph is timed, so
each request's wall time stands in for its passes' device time."""
import os

from amgbench.harness import load_module

_rhs = load_module(os.path.join(os.path.dirname(__file__), "rhs_stream.py"),
                   "amgbench_traffic_rhs_stream")
prepare, check, breakdown = _rhs.prepare, _rhs.check, _rhs.breakdown
GIB = 2 ** 30


def window(run, seconds):
    _rhs.window(run, seconds)
    for r in run.requests:
        r["pass_ms"] = r.get("pass_ms") or [1e3 * r["wall_s"]]
    run.cards = [{"uuid": f"GPU-{r}", "kind": "NVIDIA H100 80GB HBM3",
                  "setup_peak_bytes": (r + 1) * GIB,
                  "window_peak_bytes": (2 * r + 1) * GIB}
                 for r in range(4)]
'''


def test_four_card_kind_needs_no_edit(tmp_path, bench):
    """A copy of amgbench/ gains a traffic kind whose driver reports four
    cards, and its mix, files only; a cell of it runs through run_cell
    and reports four cards, the fullest one's peak and the roofline at
    four cards' rate; no file that was there changed."""
    copy = tmp_path / "amgbench"
    shutil.copytree(BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digest(str(copy))
    (copy / "traffic" / "rhs_four.py").write_text(FOUR_RANKS)
    with open(copy / "traffic" / "rhs-stream.json") as f:
        mix = json.load(f)
    mix.update(kind="rhs_four", pool=4, kept=2)
    (copy / "traffic" / "rhs-four.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "p3d.four", "config":
                               "poisson3d-192", "traffic": "rhs-four",
                               "chips": 4, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "p3d192.rhs" in m.get("workloads", ()):
            m["workloads"].append("p3d.four")
    spec = harness.load_cell(bench, "p3d.four", ROOT, str(copy))
    spec["config"] = small_spec("p3d192.rhs")["config"]
    result, record = harness.run_cell(spec, 2 ** 33 + 5, 0.5, True, "cpu",
                                      bench_dir=str(copy))
    assert result["correct"], result
    assert result["device"]["count"] == 4
    assert result["device"]["kind"] == H100
    assert result["device"]["memory_peak_bytes"] == 7 * GIB
    e2e = harness.read_metrics(spec["end_to_end"], record, str(copy))
    assert e2e["device_peak_gib"]["value"] == 7.0
    one = harness.read_metrics(
        spec["per_layer"], dict(record, peak_bytes_per_s=3.35e12),
        str(copy))["solve_roofline_pct"]["value"]
    assert one > 0
    assert result["metrics"]["solve_roofline_pct"]["value"] \
        == pytest.approx(one / 4, rel=1e-12)
    after = _digest(str(copy))
    assert {k: after[k] for k in before} == before


# --- run.py refuses a run short of its cell's cards


def _run_py():
    return harness.load_module(os.path.join(ROOT, "amgbench", "run.py"),
                               "amgbench_run")


@pytest.mark.parametrize("used, rc", [(1, 2), (3, 2), (4, 0), ("kinds", 2)])
def test_run_py_fails_a_run_short_of_its_cards(monkeypatch, capsys, bench,
                                               used, rc):
    spec = harness.load_cell(bench, "p3d192.rhs")
    spec["cell"] = dict(spec["cell"], chips=4)
    monkeypatch.setattr(harness, "load_cell", lambda b, w: spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(harness, "jax_modules", lambda: [])

    def run_cell(*a, **k):
        if used == "kinds":
            raise harness.CardError("the run reports cards of 2 kinds")
        result = {"correct": True, "attempted": 1, "failed": 0,
                  "metrics": {}, "device": {"platform": "gpu",
                                            "kind": H100, "count": used,
                                            "memory_peak_bytes": GIB},
                  "compared": {}}
        return result, {"setup_spans": {}, "requests": [], "window_s": 1.0,
                        "peak_bytes_per_s": 4 * 3.35e12}
    monkeypatch.setattr(harness, "run_cell", run_cell)
    got = _run_py().main(["--workload", "p3d192.rhs", "--seed", "7",
                          "--seconds", "1"])
    out, err = capsys.readouterr()
    assert got == rc
    if rc:
        assert not [line for line in out.splitlines()
                    if line.startswith("{")]
        if used == "kinds":
            assert "2 kinds" in err
        else:
            assert f"used {used} card(s)" in err and "asks for 4" in err
    else:
        assert json.loads(out.splitlines()[-1])["device"]["count"] == 4


# --- on the card: rank processes report their own cards

RANK = r'''
import json, os, sys
import torch
from amgbench import harness
rank, cards, mib = int(os.environ["RANK"]), int(sys.argv[1]), int(sys.argv[2])
dev = torch.device("cuda", rank % cards)
torch.cuda.set_device(dev)
g = torch.Generator(device=dev)
g.manual_seed(harness.derive_seed(int(sys.argv[3]), rank))
x = torch.randn((rank + 1) * mib * 2 ** 17, generator=g,
                dtype=torch.float64, device=dev)
torch.cuda.synchronize(dev)
setup_peak = torch.cuda.max_memory_reserved(dev)
torch.cuda.reset_peak_memory_stats(dev)
y = x * 2.0
assert torch.isfinite(y.sum()).item()
torch.cuda.synchronize(dev)
print(json.dumps(harness.card_report(dev, setup_peak,
                                     torch.cuda.max_memory_reserved(dev))))
'''

RANK_DRIVER = '''"""Traffic kind ranks_probe: four rank processes, each on card
rank % cards, hold (rank + 1) * mib MiB in set-up and twice that in the
window, and report their cards."""
import time

from sparsh_amg_tpu_torch.parallel.multihost import last_json, spawn_ranks


def prepare(run):
    run.work = None


def window(run, seconds):
    t = run.traffic
    t0 = time.perf_counter()
    outs = spawn_ranks(4, ["-c", t["code"], str(t["cards"]), str(t["mib"]),
                           str(run.seed)], backend="gloo", device="cuda",
                       timeout=300.0, threads=1)
    run.cards = [last_json(o) for o in outs]
    run.window_s = time.perf_counter() - t0
    run.requests = [{"ok": True, "converged": True,
                     "wall_s": run.window_s, "pass_ms": []}]


def check(run):
    return [{"name": "ranks", "value": 0.0, "limit": 0.0}], set()
'''


@pytest.mark.gpu
@pytest.mark.parametrize("cards", [4, 1])
def test_rank_processes_report_their_cards(tmp_path, cards):
    """Four rank processes through run_cell: on four cards, count 4 and
    the largest rank's peak; on one card shared by all four, count 1 at
    the largest rank's peak."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA card(s), "
                    f"torch sees {torch.cuda.device_count()}")
    torch.cuda.empty_cache()
    copy = tmp_path / "amgbench"
    shutil.copytree(BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (copy / "traffic" / "ranks_probe.py").write_text(RANK_DRIVER)
    mib = 256
    spec = small_spec("p3d192.rhs")
    spec["traffic"] = {"kind": "ranks_probe", "code": RANK, "cards": cards,
                       "mib": mib}
    result, record = harness.run_cell(spec, 2 ** 32 + 9, 1.0, False,
                                      "cuda", bench_dir=str(copy))
    device = result["device"]
    assert result["correct"], result
    assert device["count"] == cards
    assert "H100" in device["kind"]
    largest = 2 * 4 * mib * 2 ** 20           # rank 3 in the window
    assert largest <= record["device_peak_bytes"] < largest + 64 * 2 ** 20
    assert device["memory_peak_bytes"] == record["device_peak_bytes"]
    assert result["metrics"]["device_peak_gib"]["value"] \
        == record["device_peak_bytes"] / GIB
    if cards > 1:
        peaks = sorted(c["window_peak_bytes"] for c in device["cards"])
        assert len({c["uuid"] for c in device["cards"]}) == 4
        assert peaks[-1] == record["device_peak_bytes"]
        assert all(p >= 2 * (r + 1) * mib * 2 ** 20
                   for r, p in enumerate(peaks))
