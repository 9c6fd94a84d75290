"""sparsh_amg_tpu_torch: the AMG solver of ``sparsh_amg_tpu`` on PyTorch and
CUDA, for an NVIDIA H100.

Host setup (``params``, ``models``, ``setup``, the native C++ kernels in
``_native``) is the port's own copy of the JAX package's framework-neutral
numpy, scipy and C++ modules, file for file; everything on the device is
PyTorch, with hand-written CUDA kernels (``csrc/``) for the DIA, ELL and
block-ELL sparse matrix-vector products that were Pallas kernels on the
TPU.  The port imports neither jax nor the JAX package.

>>> from sparsh_amg_tpu_torch import AMGSolver
>>> res = AMGSolver(A, params, krylov, device="cuda").solve(b)

The exports load on first access, so importing the package builds nothing
and imports neither the kernels nor the setup.
"""
from __future__ import annotations

import importlib

from ._native import tune_malloc as _tune_malloc

# one-time heap tuning (see _native.tune_malloc).  It is process-global:
# a process that imports the JAX package as well runs it twice, which sets
# the same two mallopt values again and is harmless.
_tune_malloc()

__version__ = "0.1.0"

_EXPORTS = {"AMGSolver": ".solve.solver", "to_device": ".solve.device"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
