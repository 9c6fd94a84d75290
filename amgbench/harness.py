"""One run of one benchmark cell, driven by data.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``: the
generator, the sizes and every solver parameter) and a traffic mix
(``traffic/<mix>.json``, whose ``kind`` names the driver
``traffic/<kind>.py``); each metric is a reader ``metrics/<name>.py``.
All are found by name, so a new cell, mix of an existing kind or metric
is a new file and an entry in ``BENCHMARK.json``.

A run: the problem from the configuration's generator (kept in
``.cache/`` where the configuration asks, since it does not depend on the
seed), the driver's set-up (``prepare``), the measured window
(``window``), then, once the window has closed and the memory peak is
read, the driver's ``check`` against the plain reference
(``reference/``), and the metric readers over the run's record.

The cards a run used are counted from reports (``card_report``): the
harness's own card, and one from each rank process of a driver whose
ranks live in other processes (``Run.cards``).  ``merge_cards`` keeps
each card once; ``device.count`` is the number of cards used, the memory
peaks are the fullest card's, and the data-sheet rate that prices the
roofline is the sum over the cards used.  A driver that reports nothing
leaves the harness's own card alone.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from amgbench import card as card_info
from amgbench.work import peak_bytes_per_s

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
JAX_NAMES = frozenset({"jax", "jaxlib", "flax", "sparsh_amg_tpu"})


def load_module(path: str, name: str):
    """The Python file at `path` as a module named `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(bench: dict, workload: str, root: str = ROOT,
              bench_dir: str = BENCH_DIR) -> dict:
    """Everything one cell needs, by the names in `bench`: the cell, its
    configuration and traffic mix, and the metrics it reports with
    ``--trace 0`` (``end_to_end``) and ``--trace 1`` (``per_layer``)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(one of {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     cell["traffic"] + ".json"))

    def metrics(group):
        return [m for m in bench[group]
                if workload in m.get("workloads", (workload,))]
    return {"cell": cell, "config": cfg, "traffic": traffic,
            "end_to_end": metrics("end_to_end"),
            "per_layer": metrics("per_layer")}


def derive_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of a run's inputs, from the run's
    `seed` (any whole number)."""
    ss = np.random.SeedSequence([seed % 2 ** 64, *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _cache_key(gen_path: str, cfg: dict) -> str:
    h = hashlib.sha256()
    with open(gen_path, "rb") as f:
        h.update(f.read())
    h.update(json.dumps(cfg["size"], sort_keys=True).encode())
    return h.hexdigest()[:16]


def build_problem(cfg: dict, bench_dir: str = BENCH_DIR):
    """(A as float64 CSR, near-nullspace or None) from the configuration's
    generator; with ``"cache": true`` kept in ``<bench_dir>/.cache/`` keyed
    by the generator's source and the sizes."""
    gen_path = os.path.join(bench_dir, "gen", cfg["generator"] + ".py")
    gen = load_module(gen_path, "amgbench_gen_" + cfg["generator"])
    if not cfg.get("cache"):
        return gen.build(cfg["size"])
    cache_dir = os.path.join(bench_dir, ".cache")
    path = os.path.join(cache_dir,
                        f"{cfg['name']}-{_cache_key(gen_path, cfg)}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            A = sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                              shape=tuple(z["shape"]))
            ns = z["nullspace"] if "nullspace" in z.files else None
        A.has_sorted_indices = True
        return A, ns
    A, ns = gen.build(cfg["size"])
    A = A.tocsr()
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    arrays = {"data": A.data, "indices": A.indices, "indptr": A.indptr,
              "shape": np.array(A.shape)}
    if ns is not None:
        arrays["nullspace"] = ns
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return A, ns


class Run:
    """The state of one run that the traffic driver and the readers
    share: the configuration, the seed, the device, the problem, the
    requests of the window and the record the metric readers read."""

    def __init__(self, spec: dict, seed: int, seconds: float, device: str,
                 bench_dir: str = BENCH_DIR):
        from sparsh_amg_tpu_torch.params import AMGParams, KrylovParams
        self.cfg = spec["config"]
        self.traffic = spec["traffic"]
        self.seed = seed
        self.seconds = seconds
        self.bench_dir = bench_dir
        self.device = torch.device(device)
        self.amg = AMGParams(**self.cfg["amg"])
        self.krylov = KrylovParams(**self.cfg["krylov"])
        self.tol = float(self.cfg["tol"])
        self.requests = []          # one dict per request of the window
        self.window_s = None
        self.setup_spans = {}
        self.work = None            # solve_bytes() of the solved hierarchy
        self.A = self.nullspace = None
        # card_report() of each rank process, where the traffic driver's ranks
        # run in other processes; each rank resets its peak just before
        # the window, as run_cell does its own, and a request's pass_ms
        # are its ranks' mean, so that busy_s is a card's
        self.cards = []

    # -- helpers the drivers share ------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def normal_vectors(self, stream: int, count: int, n: int) -> np.ndarray:
        """(count, n) float64 standard normals from the seed, drawn on the
        device in one call and kept on the host: the benchmark's inputs,
        handed the same to the program and to the reference."""
        g = torch.Generator(device=self.device)
        g.manual_seed(derive_seed(self.seed, stream))
        v = torch.randn((count, n), generator=g, dtype=torch.float64,
                        device=self.device)
        return v.cpu().numpy()

    def build_solver(self, A, nullspace=None, spans: dict | None = None):
        """The port's set-up of one matrix through its public entry
        points: maybe_reorder and amg_setup (span ``host_setup``), then
        AMGSolver(...) (span ``freeze``: the freeze and upload), then
        warm() (span ``warm``).  Returns (solver, perm or None)."""
        from sparsh_amg_tpu_torch import AMGSolver
        from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
        from sparsh_amg_tpu_torch.setup.reorder import maybe_reorder
        spans = {} if spans is None else spans
        t0 = time.perf_counter()
        Ar, perm = maybe_reorder(A, self.amg.reorder)
        ns = nullspace
        if perm is not None and ns is not None:
            ns = np.asarray(ns)[perm]
        hier = amg_setup(Ar, self.amg, nullspace=ns)
        t1 = time.perf_counter()
        solver = AMGSolver(Ar, self.amg, self.krylov, hierarchy=hier,
                           device=self.device)
        t2 = time.perf_counter()
        solver.warm()
        self.sync()
        t3 = time.perf_counter()
        spans.update(host_setup=t1 - t0, freeze=t2 - t1, warm=t3 - t2)
        return solver, perm

    @staticmethod
    def permuted(b: np.ndarray, perm) -> np.ndarray:
        return b if perm is None else b[perm]

    @staticmethod
    def unpermuted(x: np.ndarray, perm) -> np.ndarray:
        if perm is None:
            return x
        out = np.empty_like(x)
        out[perm] = x
        return out

    def solve_record(self, res, wall_s: float, **extra) -> dict:
        """A request's entry from the port's SolveResult."""
        return {"ok": True, "wall_s": wall_s,
                "converged": bool(res.converged),
                "iterations": int(res.iterations),
                "passes": int(res.refine_passes),
                "host_reads": int(res.host_reads),
                "pass_ms": [float(t) for t in res.pass_ms], **extra}


class CardError(ValueError):
    """The cards a run reports cannot be one device: kinds differ."""


def card_report(device, setup_peak_bytes: int,
                window_peak_bytes: int) -> dict:
    """What one process held on its card: the card's UUID and name, and
    ``max_memory_reserved`` over set-up and over the window (after a
    reset just before it).  JSON-able, so a rank process can print it."""
    return {"uuid": str(torch.cuda.get_device_properties(device).uuid),
            "kind": torch.cuda.get_device_name(device),
            "setup_peak_bytes": int(setup_peak_bytes),
            "window_peak_bytes": int(window_peak_bytes)}


def merge_cards(reports: list) -> list:
    """The cards a run used, one entry a UUID at the largest peaks of the
    reports on it; a card whose window peak is 0 was not used.  Raises
    CardError where the reports name more than one kind of card."""
    kinds = sorted({r["kind"] for r in reports})
    if len(kinds) > 1:
        raise CardError(f"the run reports cards of {len(kinds)} kinds: "
                        f"{', '.join(kinds)}")
    cards = {}
    for r in reports:
        c = cards.setdefault(r["uuid"], dict(r))
        for k in ("setup_peak_bytes", "window_peak_bytes"):
            c[k] = max(c[k], r[k])
    return [c for c in cards.values() if c["window_peak_bytes"] > 0]


def device_of(reports: list) -> tuple:
    """(the result line's ``device``, the fullest card's window peak, the
    data-sheet rate summed over the cards used or None) from the card
    reports of a run; a run that reports no card ran on the CPU."""
    if not reports:
        return ({"platform": "cpu", "kind": "cpu", "count": 0,
                 "memory_peak_bytes": 0}, 0, None)
    cards = merge_cards(reports)
    device = {"platform": "gpu", "kind": reports[0]["kind"],
              "count": len(cards),
              "memory_peak_bytes": max(
                  (max(c["setup_peak_bytes"], c["window_peak_bytes"])
                   for c in cards), default=0)}
    if len(cards) > 1:
        device["cards"] = cards
    rates = [peak_bytes_per_s(c["kind"]) for c in cards]
    rate = sum(rates) if rates and None not in rates else None
    window_peak = max((c["window_peak_bytes"] for c in cards), default=0)
    return device, window_peak, rate


def compared_ok(compared: list) -> bool:
    return bool(compared) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared)


def read_metrics(metrics: list, record: dict,
                 bench_dir: str = BENCH_DIR) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        reader = load_module(os.path.join(bench_dir, "metrics",
                                          m["name"] + ".py"),
                             "amgbench_metric_" + m["name"].replace(".", "_")
                             .replace("-", "_"))
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             bench_dir: str = BENCH_DIR) -> tuple:
    """One run of the cell `spec` (``load_cell``); returns (result line as
    a dict, the record).  The caller has checked for the card."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(spec, seed, seconds, device, bench_dir)
    driver = load_module(
        os.path.join(bench_dir, "traffic", run.traffic["kind"] + ".py"),
        "amgbench_traffic_" + run.traffic["kind"])
    t0 = time.perf_counter()
    run.A, run.nullspace = build_problem(run.cfg, bench_dir)
    run.setup_spans["problem"] = time.perf_counter() - t0
    driver.prepare(run)
    run.sync()
    cuda = run.device.type == "cuda"
    setup_peak = torch.cuda.max_memory_reserved(run.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    setup_s = time.perf_counter() - t_start

    driver.window(run, seconds)
    run.sync()
    window_peak = torch.cuda.max_memory_reserved(run.device) if cuda else 0

    compared, failed_checks = driver.check(run)
    failed = len(set(failed_checks) | {
        i for i, r in enumerate(run.requests)
        if not r["ok"] or not r.get("converged")})
    attempted = len(run.requests)
    correct = failed == 0 and attempted > 0 and compared_ok(compared)

    reports = list(run.cards)
    card = None
    if cuda:
        reports.insert(0, card_report(run.device, setup_peak, window_peak))
        name, watts = card_info.name_and_power_limit()
        card = {"nvidia_smi_name": name, "power_limit_w": watts}
    device_info, window_peak, peak_bw = device_of(reports)
    busy_s = sum(sum(r.get("pass_ms", ())) for r in run.requests) / 1e3
    record = {"setup_s": setup_s, "window_s": run.window_s,
              "requests": run.requests, "device_peak_bytes": window_peak,
              "work": run.work, "peak_bytes_per_s": peak_bw,
              "setup_spans": run.setup_spans}
    metrics = read_metrics(spec["per_layer" if trace else "end_to_end"],
                           record, bench_dir)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if trace:
        device_info["busy_s"] = busy_s
        device_info["window_s"] = run.window_s
        breakdown = getattr(driver, "breakdown", None)
        if breakdown is not None:
            result["breakdown"] = breakdown(record)
    if card is not None:
        result["card"] = card
    result["compared"] = {c["name"]: {"value": c["value"],
                                      "limit": c["limit"]}
                          for c in compared}
    return result, record


def summary(record: dict) -> dict:
    """What a reader of the run's standard error needs beside the metrics:
    the set-up's spans, the requests' wall times (each request's spans
    where it has them) and counts, and the rate that priced the
    roofline."""
    reqs = record["requests"]
    walls = sorted(r["wall_s"] for r in reqs)
    out = {"setup_spans": record["setup_spans"], "requests": len(reqs),
           "window_s": record["window_s"],
           "peak_bytes_per_s": record["peak_bytes_per_s"]}
    if walls:
        out["wall_s"] = {"min": walls[0], "median": walls[len(walls) // 2],
                         "max": walls[-1]}
        out["iterations"] = sorted({r.get("iterations") for r in reqs
                                    if r["ok"]})
    if len(reqs) <= 40:
        out["each"] = [{"wall_s": r["wall_s"], **r.get("spans", {})}
                       for r in reqs]
    return out


def jax_modules(modules=None) -> list:
    """The top-level names of loaded modules that are JAX or the JAX
    package, compared whole (``sparsh_amg_tpu_torch`` is not
    ``sparsh_amg_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & JAX_NAMES)
