"""The frozen generators build the port's matrices."""
from __future__ import annotations

import os

import numpy as np
import pytest
from conftest import ROOT

from amgbench import harness

GEN = os.path.join(ROOT, "amgbench", "gen")


def _same(A, B):
    A, B = A.tocsr(), B.tocsr()
    assert A.shape == B.shape
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices, B.indices)
    assert np.array_equal(A.data, B.data)


@pytest.mark.parametrize("n", [2, 5, 9])
def test_poisson3d_is_the_ports(n):
    from sparsh_amg_tpu_torch.models import poisson3d
    gen = harness.load_module(os.path.join(GEN, "poisson3d.py"), "g_p3d")
    A, ns = gen.build({"n": n})
    assert ns is None
    _same(A, poisson3d(n))


@pytest.mark.parametrize("m", [2, 3])
def test_elasticity3d_is_the_ports(m):
    from sparsh_amg_tpu_torch.models import (elasticity3d,
                                             elasticity3d_nullspace)
    gen = harness.load_module(os.path.join(GEN, "elasticity3d.py"),
                              "g_e3d")
    A, ns = gen.build({"m": m})
    _same(A, elasticity3d(m))
    assert np.array_equal(ns, elasticity3d_nullspace(m))


def test_cache_round_trip(tmp_path):
    """A cached configuration reads back the matrix it wrote."""
    import shutil
    bench = tmp_path / "amgbench"
    shutil.copytree(GEN, bench / "gen")
    cfg = {"name": "e3d-small", "generator": "elasticity3d",
           "size": {"m": 3}, "cache": True}
    A, ns = harness.build_problem(cfg, str(bench))
    assert len(list((bench / ".cache").iterdir())) == 1
    B, ns2 = harness.build_problem(cfg, str(bench))
    _same(A, B)
    assert np.array_equal(ns, ns2)
