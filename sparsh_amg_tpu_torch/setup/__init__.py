"""AMG setup phase (host-side).

The reference runs setup on the CPU in C/C++ (SURVEY.md §2 C9-C13, §3.2);
this package does the same, combining native kernels (``_native``) with
scipy SpGEMM, and produces a static hierarchy the device solve consumes.
"""
from .strength import classical_strength, symmetric_strength
from .splitting import rs_splitting, pmis_splitting
from .aggregate import greedy_aggregation, tentative_prolongator, smooth_prolongator
from .interp import direct_interpolation
from .galerkin import galerkin_product
from .hierarchy import Hierarchy, Level, amg_setup

__all__ = [
    "classical_strength", "symmetric_strength",
    "rs_splitting", "pmis_splitting",
    "greedy_aggregation", "tentative_prolongator", "smooth_prolongator",
    "direct_interpolation", "galerkin_product",
    "Hierarchy", "Level", "amg_setup",
]
