"""The configurations' matrices against their sources: the published m,
n and nnz, and the published work of C = A @ A (intermediate products
and nnz(C), from the table the configuration names). The replicas are
synthesised, so what they must match is what sets the work: the
products a run computes and the entries it merges them into."""

import numpy as np
import pytest

from benchlib import inputs, spec
from conftest import BENCH

# published nnz(C-hat) and nnz(C) are given to three digits
WORK_TOLERANCE = 0.02
# every configuration that states the published work of its product
PUBLISHED = sorted(
    p.stem for p in (BENCH / "configs").glob("*.json")
    if "products" in spec.load_json(p).get("published", {}))


@pytest.mark.parametrize("name", PUBLISHED)
def test_the_replica_does_the_published_work(name):
    cfg = spec.load_json(BENCH / "configs" / f"{name}.json")
    pub = cfg["published"]
    family = spec.load_module(BENCH / "inputs" / f"{cfg['family']}.py",
                              "fidelity")
    a = inputs.structure(family, cfg, cfg["structure_seed"])
    assert a.shape == (pub["m"], pub["n"])
    assert abs(a.nnz - pub["nnz"]) <= inputs.NNZ_TOLERANCE * pub["nnz"]
    products = inputs.products(a.indptr, a.indices, a.indptr)
    nnz_c = (a @ a).nnz
    assert {"cage12", "cant"} <= set(PUBLISHED)
    assert abs(products / pub["products"] - 1) <= WORK_TOLERANCE, products
    assert abs(nnz_c / pub["nnz_c"] - 1) <= WORK_TOLERANCE, nnz_c
    # symmetric, full diagonal, sorted rows, no repeats
    assert (a != a.T).nnz == 0 and np.all(a.diagonal() != 0)
    assert a.has_sorted_indices and a.has_canonical_format


@pytest.mark.parametrize("name", PUBLISHED)
def test_every_seed_gives_the_same_structure_and_new_values(name):
    cfg = spec.load_json(BENCH / "configs" / f"{name}.json")
    family = spec.load_module(BENCH / "inputs" / f"{cfg['family']}.py",
                              "seeds")
    a, b = (inputs.generate(family, cfg, s) for s in (1, 2**31 + 9))
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert not np.any(a.data == b.data)
    np.testing.assert_array_equal(
        inputs.generate(family, cfg, 1).data, a.data)
