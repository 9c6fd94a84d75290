"""The port works where jax is not installed (the GPU machine): a fresh
interpreter with jax blocked imports the port and solves on the CPU, and
no module of the port imports jax."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import sparsh_amg_tpu

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "sparsh_amg_tpu_torch"

_CHILD = r"""
import json, sys
sys.modules["jax"] = None              # import jax now raises ImportError
import numpy as np
from sparsh_amg_tpu_torch import AMGSolver, flagship, systems
from sparsh_amg_tpu_torch._host import poisson3d
if sys.argv[1] == "flagship":
    A, ns = poisson3d(16), None
    p, kr = flagship.params(dense_size=256), flagship.krylov()
else:                                  # smoothed aggregation, 3 dofs/node
    A, ns = systems.problem(3, 6)
    p, kr = systems.params(3, dense_size=256), systems.krylov()
b = np.random.default_rng(0).standard_normal(A.shape[0])
solver = AMGSolver(A, p, kr, nullspace=ns, device="cpu")
res = solver.solve(b)
import sparsh_amg_tpu
print(json.dumps({
    "converged": res.converged, "iterations": res.iterations,
    "passes": res.refine_passes,
    "relres": float(np.linalg.norm(b - A @ res.x) / np.linalg.norm(b)),
    "L0": type(solver.device.levels[0].A).__name__,
    "jax_modules": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "jaxlib")
                          and sys.modules[m] is not None),
    "real_package_init_ran": hasattr(sparsh_amg_tpu, "AMGSolver"),
}))
"""


def _solve_without_jax(which):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _CHILD, which], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["converged"] and got["relres"] <= 1e-8, got
    assert got["jax_modules"] == [] and not got["real_package_init_ran"]
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


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_port_module_imports_jax():
    files = sorted(f for f in PORT.rglob("*.py")
                   if "_build" not in f.relative_to(PORT).parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 15
    for f in files:
        bad = [m for m in _imports(f)
               if m.split(".")[0] in ("jax", "jaxlib")]
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_real_package_kept_when_jax_present():
    """With jax installed the port imports the real JAX package, so a later
    JAX test in the same worker still finds its full namespace."""
    import sparsh_amg_tpu_torch._host  # noqa: F401
    assert hasattr(sparsh_amg_tpu, "AMGSolver")
    from sparsh_amg_tpu import AMGParams
    from sparsh_amg_tpu_torch._host import AMGParams as Shared
    assert Shared is AMGParams
