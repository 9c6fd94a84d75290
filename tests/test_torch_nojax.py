"""The port stands alone where jax is not installed (the GPU machine): a
fresh interpreter with jax blocked imports the port and solves on the CPU
without loading any module of the JAX package, and no module of the port
imports jax or the JAX package."""
import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "sparsh_amg_tpu_torch"

_CHILD = r"""
import json, sys
sys.modules["jax"] = None              # import jax now raises ImportError
import numpy as np
from sparsh_amg_tpu_torch import AMGSolver, cli, configs, flagship, systems
from sparsh_amg_tpu_torch.models import poisson3d
from sparsh_amg_tpu_torch.utils import io, serialize, timing
if sys.argv[1] == "flagship":
    A, ns = poisson3d(16), None
    p, kr = flagship.params(dense_size=256), flagship.krylov()
elif sys.argv[1] in configs.NAMES:     # gs2 triangles, BiCGStab
    A, ns = configs.problem(sys.argv[1], 10)
    p, kr = configs.params(sys.argv[1], dense_size=256), \
        configs.krylov(sys.argv[1])
else:                                  # smoothed aggregation, 3 dofs/node
    A, ns = systems.problem(3, 6)
    p, kr = systems.params(3, dense_size=256), systems.krylov()
b = np.random.default_rng(0).standard_normal(A.shape[0])
solver = AMGSolver(A, p, kr, nullspace=ns, device="cpu")
res = solver.solve(b)
print(json.dumps({
    "converged": res.converged, "iterations": res.iterations,
    "passes": res.refine_passes,
    "relres": float(np.linalg.norm(b - A @ res.x) / np.linalg.norm(b)),
    "L0": type(solver.device.levels[0].A).__name__,
    "jax_modules": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "jaxlib")
                          and sys.modules[m] is not None),
    "jax_package_modules": sorted(m for m in sys.modules
                                  if m.split(".")[0] == "sparsh_amg_tpu"),
}))
"""


def _solve_without_jax(which):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _CHILD, which], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["converged"] and got["relres"] <= 1e-8, got
    assert got["jax_modules"] == [], got
    assert got["jax_package_modules"] == [], got
    return got


def test_port_solves_without_jax():
    got = _solve_without_jax("flagship")
    assert 8 <= got["iterations"] <= 16 and got["passes"] == 2, got


def test_systems_solve_without_jax():
    """The smoothed-aggregation setup modules load without jax, and the
    fine elasticity level freezes in the block layout."""
    got = _solve_without_jax("elasticity3d(6)")
    assert got["L0"] == "BlockEllMatrix", got
    assert got["iterations"] <= 20 and got["passes"] == 2, got


def test_gs2_bicgstab_solve_without_jax():
    """The copied model families, BiCGStab, the gs2 triangles, the CLI and
    the copied utilities load and solve without jax."""
    got = _solve_without_jax("convection3d_96_pmis_extpi_V_bicgstab")
    assert got["L0"] == "DiaMatrix" and got["passes"] == 2, got


def _imports(path):
    """Absolute module names a file imports (relative imports stay inside
    their own package)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_port_module_imports_jax():
    """Neither jax nor the JAX package (any import rooted at
    sparsh_amg_tpu), in every module of the port and in chip_smoke.py."""
    files = sorted(f for f in PORT.rglob("*.py")
                   if "_build" not in f.relative_to(PORT).parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 30
    assert not (PORT / "_host.py").exists()
    for f in files:
        bad = [m for m in _imports(f)
               if m.split(".")[0] in ("jax", "jaxlib", "sparsh_amg_tpu")]
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("name", ["AMGParams", "KrylovParams"])
def test_port_params_match_jax_params(name):
    """The port's copy of params.py has the JAX package's fields, defaults
    and types, so one set of keywords configures both."""
    from sparsh_amg_tpu import params as jparams
    from sparsh_amg_tpu_torch import params as tparams
    mine, ref = getattr(tparams, name), getattr(jparams, name)
    assert mine is not ref

    def fields(cls):
        return [(f.name, f.type, f.default, f.default_factory)
                for f in dataclasses.fields(cls)]
    assert fields(mine) == fields(ref)
    assert dataclasses.asdict(mine()) == dataclasses.asdict(ref())
