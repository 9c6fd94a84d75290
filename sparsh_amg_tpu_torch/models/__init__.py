"""Test-problem generators: copies of ``sparsh_amg_tpu/models/`` (numpy and
scipy only), file for file with the import lines as they were, so the port
builds the same CSR matrices as the JAX package.  The exports are the JAX
package's; ``unstructured.delaunay_laplacian`` is imported from its module,
as there.
"""
from .poisson import poisson2d, poisson3d
from .anisotropic import anisotropic2d, anisotropic3d
from .convection import convection2d, convection3d
from .jump import jump2d
from .elasticity import (elasticity2d, elasticity2d_nullspace,
                         elasticity3d, elasticity3d_nullspace)
from .problem import Problem, get_problem

__all__ = [
    "poisson2d",
    "poisson3d",
    "anisotropic2d",
    "anisotropic3d",
    "convection2d",
    "convection3d",
    "jump2d",
    "elasticity2d",
    "elasticity2d_nullspace",
    "elasticity3d",
    "elasticity3d_nullspace",
    "Problem",
    "get_problem",
]
