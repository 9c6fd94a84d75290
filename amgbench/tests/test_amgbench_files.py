"""BENCHMARK.json and the files it names: every configuration, traffic mix
and metric loads by name, the names keep to the contract's characters,
a new mix of an existing kind and a new metric need no edit to a file
already there, and nothing under amgbench/ imports JAX or the JAX
package."""
from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import shutil

import pytest
from conftest import ROOT, small_spec

from amgbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
BENCH_DIR = os.path.join(ROOT, "amgbench")


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32
    assert all(line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"])
        assert line(c["why"]) and c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert line(m["layer"]) and m["moves"] in e2e
        # reported only where the metric it moves is reported
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", cells)) <= moved
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        spec = harness.load_cell(bench, cell)
        assert any(m["name"] != "setup_s" for m in spec["end_to_end"])
        assert spec["per_layer"]


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics"])
def test_every_named_file_loads(bench, kind):
    if kind == "configs":
        for c in bench["configs"]:
            cfg = harness.load_json(os.path.join(ROOT, c["file"]))
            assert cfg["name"] == c["name"]
            assert os.path.exists(os.path.join(
                BENCH_DIR, "gen", cfg["generator"] + ".py"))
    elif kind == "traffic":
        for w in bench["workloads"]:
            t = harness.load_json(os.path.join(BENCH_DIR, "traffic",
                                               w["traffic"] + ".json"))
            mod = harness.load_module(
                os.path.join(BENCH_DIR, "traffic", t["kind"] + ".py"),
                "t_" + t["kind"])
            assert callable(mod.prepare) and callable(mod.window)
            assert callable(mod.check)
    else:
        for m in bench["end_to_end"] + bench["per_layer"]:
            mod = harness.load_module(
                os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"),
                "m_" + m["name"])
            assert callable(mod.read)


def _digest(path: str) -> dict:
    out = {}
    for d, _, files in os.walk(path):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_mix_and_metric_need_no_edit(tmp_path, bench):
    """A copy of amgbench/ gains a mix of the kind rhs_stream and a metric
    reader, files only; a cell using both runs and reports the metric,
    and no file that was there changed."""
    copy = tmp_path / "amgbench"
    shutil.copytree(BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digest(str(copy))
    with open(copy / "traffic" / "rhs-stream.json") as f:
        mix = json.load(f)
    mix.update(pool=4, kept=2)
    (copy / "traffic" / "rhs-small.json").write_text(json.dumps(mix))
    (copy / "metrics" / "solves_completed.py").write_text(
        "def read(record):\n"
        "    return sum(1 for r in record['requests'] if r['ok'])\n")
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "p3d.small", "config":
                               "poisson3d-192", "traffic": "rhs-small",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "solves_completed", "unit": "n",
                               "better": "higher",
                               "source": "program_counter", "layer": "t",
                               "moves": "solve_ms",
                               "workloads": ["p3d.small"]})
    spec = harness.load_cell(bench, "p3d.small", ROOT, str(copy))
    spec.update({k: v for k, v in small_spec("p3d192.rhs").items()
                 if k == "config"})
    result, _ = harness.run_cell(spec, 11, 0.5, True, "cpu",
                                 bench_dir=str(copy))
    assert result["correct"]
    assert result["metrics"]["solves_completed"]["value"] \
        == result["attempted"] > 0
    after = _digest(str(copy))
    assert {k: after[k] for k in before} == before


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    seen = 0
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                found = _imports(os.path.join(d, f)) & harness.JAX_NAMES
                assert not found, (f, found)
                seen += 1
    assert seen > 20
    # top-level names compared whole: the port's name begins with the
    # JAX package's and is no match
    assert harness.jax_modules({"sparsh_amg_tpu_torch.ops": 1,
                                "jaxtyping": 1, "numpy": 1}) == []
    assert harness.jax_modules({"sparsh_amg_tpu.ops.gell": 1,
                                "jax.numpy": 1}) == ["jax", "sparsh_amg_tpu"]
