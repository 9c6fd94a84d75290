"""Named benchmark problems (the reference's example-driver matrices,
BASELINE.json configs 0-4)."""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from .poisson import poisson2d, poisson3d
from .anisotropic import anisotropic2d
from .elasticity import (elasticity2d, elasticity2d_nullspace,
                         elasticity3d, elasticity3d_nullspace)


@dataclasses.dataclass
class Problem:
    name: str
    A: sp.csr_matrix
    b: np.ndarray
    meta: dict
    nullspace: np.ndarray | None = None   # near-nullspace basis (n, k) for
                                          # aggregation coarsening (rigid-
                                          # body modes for elasticity)

    @property
    def n(self) -> int:
        return self.A.shape[0]


def _rhs(A: sp.csr_matrix, kind: str = "random", seed: int = 0) -> np.ndarray:
    n = A.shape[0]
    if kind == "ones":
        return A @ np.ones(n)
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n)
    return b / np.linalg.norm(b)


def get_problem(name: str, n: int | None = None, rhs: str = "random",
                **kw) -> Problem:
    """Build a named problem sized to ~n unknowns.

    Names: poisson2d, poisson3d, anisotropic, elasticity.
    """
    if name == "poisson2d":
        nx = int(round((n or 1_000_000) ** 0.5))
        A = poisson2d(nx, **kw)
        meta = {"nx": nx, "grid": (nx, nx)}
    elif name == "poisson3d":
        nx = int(round((n or 8_000_000) ** (1.0 / 3.0)))
        A = poisson3d(nx, **kw)
        meta = {"nx": nx, "grid": (nx, nx, nx)}
    elif name == "anisotropic":
        nx = int(round((n or 1_000_000) ** 0.5))
        A = anisotropic2d(nx, **kw)
        meta = {"nx": nx, "epsilon": kw.get("epsilon", 1e-3),
                "angle_deg": kw.get("angle_deg", 45.0)}
    elif name == "elasticity":
        nx = int(round(((n or 500_000) / 2) ** 0.5))
        A = elasticity2d(nx, **kw)
        meta = {"nx": nx}
        return Problem(name=name, A=A, b=_rhs(A, rhs), meta=meta,
                       nullspace=elasticity2d_nullspace(nx))
    elif name == "elasticity3d":
        nx = int(round(((n or 500_000) / 3) ** (1.0 / 3.0)))
        A = elasticity3d(nx, **kw)
        meta = {"nx": nx, "grid": (nx, nx, nx)}
        return Problem(name=name, A=A, b=_rhs(A, rhs), meta=meta,
                       nullspace=elasticity3d_nullspace(nx))
    elif name == "jump":
        from .jump import jump2d
        nx = int(round((n or 1_000_000) ** 0.5))
        A = jump2d(nx, **kw)
        meta = {"nx": nx, "contrast": kw.get("contrast", 1e4),
                "pattern": kw.get("pattern", "checkerboard")}
    elif name == "convection":
        from .convection import convection2d
        nx = int(round((n or 1_000_000) ** 0.5))
        A = convection2d(nx, **kw)
        meta = {"nx": nx, "epsilon": kw.get("epsilon", 1e-2)}
    elif name == "anisotropic3d":
        from .anisotropic import anisotropic3d
        nx = int(round((n or 1_000_000) ** (1.0 / 3.0)))
        A = anisotropic3d(nx, **kw)
        meta = {"nx": nx, "grid": (nx, nx, nx),
                "eps_y": kw.get("eps_y", 1e-3),
                "eps_z": kw.get("eps_z", 1e-3),
                "angle_deg": kw.get("angle_deg", 45.0)}
    elif name == "convection3d":
        from .convection import convection3d
        nx = int(round((n or 1_000_000) ** (1.0 / 3.0)))
        A = convection3d(nx, **kw)
        meta = {"nx": nx, "grid": (nx, nx, nx),
                "epsilon": kw.get("epsilon", 1e-2)}
    else:
        raise ValueError(f"unknown problem {name!r}")
    return Problem(name=name, A=A, b=_rhs(A, rhs), meta=meta)
