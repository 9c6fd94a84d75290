"""Hierarchy serialization (SURVEY.md §5.4: the reference rebuilds its
hierarchy per system; here the slow host setup phase is reusable across
solve runs / processes via a single .npz archive)."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..params import AMGParams
from ..setup.hierarchy import Hierarchy, Level


def _put_csr(d: dict, key: str, A: sp.csr_matrix | None):
    if A is None:
        return
    d[f"{key}_indptr"] = A.indptr
    d[f"{key}_indices"] = A.indices
    d[f"{key}_data"] = A.data
    d[f"{key}_shape"] = np.asarray(A.shape)


def _get_csr(z, key: str) -> sp.csr_matrix | None:
    if f"{key}_indptr" not in z:
        return None
    return sp.csr_matrix(
        (z[f"{key}_data"], z[f"{key}_indices"], z[f"{key}_indptr"]),
        shape=tuple(z[f"{key}_shape"]))


def save_hierarchy(path: str, hier: Hierarchy) -> None:
    d: dict = {"n_levels": np.asarray(hier.n_levels)}
    for k, v in vars(hier.params).items():
        d[f"param_{k}"] = np.asarray(v)
    for i, lev in enumerate(hier.levels):
        _put_csr(d, f"L{i}_A", lev.A)
        _put_csr(d, f"L{i}_P", lev.P)
        _put_csr(d, f"L{i}_R", lev.R)
        if lev.cf is not None:
            d[f"L{i}_cf"] = lev.cf
        if lev.agg is not None:
            d[f"L{i}_agg"] = lev.agg
    np.savez_compressed(path, **d)


def load_hierarchy(path: str) -> Hierarchy:
    z = np.load(path)
    kw = {}
    for f_ in AMGParams.__dataclass_fields__:
        key = f"param_{f_}"
        if key in z:
            v = z[key][()]
            typ = type(getattr(AMGParams(), f_))
            kw[f_] = typ(v)
    params = AMGParams(**kw)
    levels = []
    for i in range(int(z["n_levels"])):
        levels.append(Level(
            A=_get_csr(z, f"L{i}_A"),
            P=_get_csr(z, f"L{i}_P"),
            R=_get_csr(z, f"L{i}_R"),
            cf=z[f"L{i}_cf"] if f"L{i}_cf" in z else None,
            agg=z[f"L{i}_agg"] if f"L{i}_agg" in z else None,
        ))
    return Hierarchy(levels=levels, params=params)
