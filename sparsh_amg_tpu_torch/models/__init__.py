"""Test-problem generators: copies of ``sparsh_amg_tpu/models/poisson.py``
and ``models/elasticity.py``, the two families the port's configurations
use (the flagship's Poisson and the systems path's elasticity).  The other
families of the JAX package wait for the configurations that need them.
"""
from .poisson import poisson2d, poisson3d
from .elasticity import (elasticity2d, elasticity2d_nullspace,
                         elasticity3d, elasticity3d_nullspace)

__all__ = [
    "poisson2d",
    "poisson3d",
    "elasticity2d",
    "elasticity2d_nullspace",
    "elasticity3d",
    "elasticity3d_nullspace",
]
