"""The port's own host setup (its copies of params, models, setup and the
native C++ kernels) against the JAX package's: the same inputs give the
same hierarchies, value for value (indptr, indices and data of every
level's A, P and R equal, not close), the same C/F splits, aggregates and
block sizes, and the same reordering permutation."""
import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse as sp

from sparsh_amg_tpu import models as jmodels
from sparsh_amg_tpu import params as jparams
from sparsh_amg_tpu.setup.hierarchy import amg_setup as jax_amg_setup
from sparsh_amg_tpu.setup.reorder import maybe_reorder as jax_reorder
from sparsh_amg_tpu_torch import flagship, models, systems
from sparsh_amg_tpu_torch.setup.hierarchy import amg_setup
from sparsh_amg_tpu_torch.setup.reorder import maybe_reorder


def _jax(p):
    """The JAX package's AMGParams from the port's params' keywords."""
    return jparams.AMGParams(**dataclasses.asdict(p))


# (problem, the port's params, near-nullspace); nullspace None: constants.
# A small coarse_size keeps three or more levels at these sizes.
CASES = {
    "flagship poisson3d(16)": lambda: (
        models.poisson3d(16),
        flagship.params(dense_size=64).replace(coarse_size=32), None),
    "systems elasticity3d(6)": lambda: (
        models.elasticity3d(6),
        systems.params(3, dense_size=64).replace(coarse_size=32),
        models.elasticity3d_nullspace(6)),
    "systems elasticity2d(16)": lambda: (
        models.elasticity2d(16),
        systems.params(2, dense_size=64).replace(coarse_size=32),
        models.elasticity2d_nullspace(16)),
}


@functools.lru_cache(maxsize=None)
def _both(case):
    A, p, ns = CASES[case]()
    A = A.tocsr()
    return (amg_setup(A, p, nullspace=ns),
            jax_amg_setup(A, _jax(p), nullspace=ns))


def _same_csr(got, want, what):
    assert (got is None) == (want is None), what
    if got is None:
        return
    got, want = got.tocsr(), want.tocsr()
    assert got.shape == want.shape, what
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{what} {f}")


@pytest.mark.parametrize("case", CASES)
def test_port_setup_gives_the_jax_hierarchy(case):
    mine, ref = _both(case)
    assert mine.n_levels == ref.n_levels >= 3
    for li, (lm, lr) in enumerate(zip(mine.levels, ref.levels)):
        for f in ("A", "P", "R"):
            _same_csr(getattr(lm, f), getattr(lr, f), f"L{li} {f}")
        for f in ("cf", "agg"):
            a, b = getattr(lm, f), getattr(lr, f)
            assert (a is None) == (b is None), f"L{li} {f}"
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"L{li} {f}")
        assert lm.bs == lr.bs, f"L{li} bs"
    assert mine.operator_complexity() == ref.operator_complexity()


@pytest.mark.parametrize("case", CASES)
def test_port_models_match_jax_models(case):
    """The copied generators build the JAX package's matrices."""
    name = case.split()[1]
    fn, m = name.split("(")[0], int(name.split("(")[1].rstrip(")"))
    _same_csr(getattr(models, fn)(m), getattr(jmodels, fn)(m), name)
    if fn.startswith("elasticity"):
        np.testing.assert_array_equal(
            getattr(models, fn + "_nullspace")(m),
            getattr(jmodels, fn + "_nullspace")(m))


@pytest.mark.parametrize("mode", ["auto", "rcm", "none"])
def test_port_reorder_gives_the_jax_permutation(mode):
    A = models.poisson2d(40).tocsr()
    perm = np.random.default_rng(3).permutation(A.shape[0])
    A = A[perm][:, perm].tocsr()          # bandwidth scrambled
    (Am, pm), (Ar, pr) = maybe_reorder(A, mode), jax_reorder(A, mode)
    assert (pm is None) == (pr is None) == (mode == "none")
    if pm is not None:
        np.testing.assert_array_equal(pm, pr)
    _same_csr(sp.csr_matrix(Am), sp.csr_matrix(Ar), f"reordered {mode}")


# the families the port copied for the seven scalar acceptance
# configurations, each at a small size: (module, function, args, keywords)
FAMILIES = {
    "poisson2d": ("poisson", "poisson2d", (17,), {}),
    "poisson3d": ("poisson", "poisson3d", (7,), {}),
    "anisotropic2d rot45": ("anisotropic", "anisotropic2d", (19,),
                            dict(epsilon=1e-3, angle_deg=45)),
    "anisotropic3d": ("anisotropic", "anisotropic3d", (7,), {}),
    "convection2d": ("convection", "convection2d", (15,), {}),
    "convection3d": ("convection", "convection3d", (9,), {}),
    "jump2d checkerboard": ("jump", "jump2d", (18,), {}),
    "jump2d random 1e4": ("jump", "jump2d", (18,),
                          dict(contrast=1e4, pattern="random")),
    "delaunay_laplacian rcm": ("unstructured", "delaunay_laplacian", (400,),
                               {}),
    "delaunay_laplacian raw": ("unstructured", "delaunay_laplacian", (300,),
                               dict(rcm=False, seed=2)),
}


@pytest.mark.parametrize("family", FAMILIES)
def test_copied_model_families_match_jax(family):
    """Each copied generator gives the JAX package's CSR bit for bit, and
    get_problem the same named problem and right-hand side."""
    import importlib
    mod, fn, args, kw = FAMILIES[family]
    mine = getattr(importlib.import_module(
        f"sparsh_amg_tpu_torch.models.{mod}"), fn)(*args, **kw)
    ref = getattr(importlib.import_module(
        f"sparsh_amg_tpu.models.{mod}"), fn)(*args, **kw)
    _same_csr(sp.csr_matrix(mine), sp.csr_matrix(ref), family)
    name = {"anisotropic2d": "anisotropic", "jump2d": "jump",
            "convection2d": "convection"}.get(fn, fn)
    if name in ("poisson2d", "poisson3d", "anisotropic", "anisotropic3d",
                "convection", "convection3d", "jump") and not kw:
        n = args[0] ** (3 if name.endswith("3d") else 2)
        pm, pr = models.get_problem(name, n=n), jmodels.get_problem(name, n=n)
        assert (pm.name, pm.meta) == (pr.name, pr.meta)
        _same_csr(pm.A, pr.A, f"get_problem {name}")
        np.testing.assert_array_equal(pm.b, pr.b)


@pytest.mark.parametrize("entry", ["stable_counting_order",
                                   "coo_to_csr_pattern"])
def test_native_entries_raise_on_out_of_range_keys(entry):
    """The two native entries of the blocked setup refuse a key (row) out
    of range with a ValueError, where they used to abort the process, and
    the library still answers afterwards."""
    from sparsh_amg_tpu_torch import _native
    assert _native.get_lib() is not None
    keys = np.array([2, 0, 1, 0, 2], dtype=np.int64)
    cols = np.array([4, 1, 3, 0, 2], dtype=np.int64)

    def good():
        if entry == "stable_counting_order":
            np.testing.assert_array_equal(
                _native.stable_counting_order(keys, 3),
                np.argsort(keys, kind="stable"))
        else:
            indptr, got = _native.coo_to_csr_pattern(3, keys, cols)
            want = sp.csr_matrix((np.ones(5), (keys, cols)), shape=(3, 5))
            want.sort_indices()
            np.testing.assert_array_equal(indptr, want.indptr)
            np.testing.assert_array_equal(got, want.indices)
    good()
    for bad in (-1, 3):
        k = keys.copy()
        k[3] = bad
        with pytest.raises(ValueError, match=rf"{entry}: .*\[0, 3\)"):
            if entry == "stable_counting_order":
                _native.stable_counting_order(k, 3)
            else:
                _native.coo_to_csr_pattern(3, k, cols)
    good()

