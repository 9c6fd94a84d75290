"""The host-side modules this package shares with ``sparsh_amg_tpu``.

Setup is framework-neutral numpy, scipy and C++: ``params``, ``models``,
``setup``, ``_native`` and ``utils/serialize`` import no jax.  But the JAX
package's ``__init__`` imports its jax-backed modules eagerly, so a plain
``from sparsh_amg_tpu.setup.hierarchy import amg_setup`` fails where jax is
not installed.

* jax installed (the CPU tests): import ``sparsh_amg_tpu`` as usual, pinned
  to the CPU backend so it claims no accelerator memory.
* jax absent (the GPU machine): register a bare ``sparsh_amg_tpu`` package
  module whose ``__path__`` is the package directory, so the submodules
  import without running ``__init__``.  The bare package is never installed
  when jax is present: a process that later imports the real package (one
  pytest worker runs JAX and port test files in turn) would otherwise find
  the empty stand-in in ``sys.modules``.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import types


def _bare_package(name: str, path: list) -> None:
    mod = types.ModuleType(name)
    mod.__path__ = list(path)
    mod.__package__ = name
    sys.modules[name] = mod


def _install() -> None:
    if importlib.util.find_spec("jax") is not None:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        importlib.import_module("sparsh_amg_tpu")
        return
    if "sparsh_amg_tpu" in sys.modules:
        return
    spec = importlib.util.find_spec("sparsh_amg_tpu")
    if spec is None or not spec.submodule_search_locations:
        raise ImportError("sparsh_amg_tpu (the shared host setup) is not "
                          "importable: run from the repository root or "
                          "install the repository")
    root = list(spec.submodule_search_locations)
    _bare_package("sparsh_amg_tpu", root)
    # utils/__init__ imports the jax-backed timers; serialize does not
    _bare_package("sparsh_amg_tpu.utils",
                  [os.path.join(p, "utils") for p in root])
    from sparsh_amg_tpu._native import tune_malloc
    tune_malloc()       # what the real package __init__ does first


_install()

from sparsh_amg_tpu import _native  # noqa: E402
from sparsh_amg_tpu._native import csr_arrays, get_lib  # noqa: E402
from sparsh_amg_tpu.models.poisson import poisson2d, poisson3d  # noqa: E402
from sparsh_amg_tpu.params import AMGParams, KrylovParams  # noqa: E402
from sparsh_amg_tpu.setup.hierarchy import Hierarchy, amg_setup  # noqa: E402
from sparsh_amg_tpu.setup.reorder import maybe_reorder  # noqa: E402
from sparsh_amg_tpu.utils import serialize  # noqa: E402

__all__ = ["AMGParams", "KrylovParams", "Hierarchy", "amg_setup",
           "maybe_reorder", "poisson2d", "poisson3d", "get_lib",
           "csr_arrays", "serialize", "_native"]
