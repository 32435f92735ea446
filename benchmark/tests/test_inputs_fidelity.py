"""The configurations' matrices against their sources: the published m,
n and nnz, and the published work of C = A @ A (intermediate products
and nnz(C), from the table the configuration names). The replicas are
synthesised, so what they must match is what sets the work: the
products a run computes and the entries it merges them into."""

import functools

import numpy as np
import pytest
import scipy.sparse as sp

from benchlib import inputs, spec
from conftest import BENCH

# published nnz(C-hat) and nnz(C) are given to three digits
WORK_TOLERANCE = 0.02
# every configuration that states the published work of its product
PUBLISHED = sorted(
    p.stem for p in (BENCH / "configs").glob("*.json")
    if "products" in spec.load_json(p).get("published", {}))


def structure_faults(a, published):
    """How the replica `a` contradicts the structure its configuration
    states under ``published``: ``symmetric`` and ``full_diagonal``, each
    true where the configuration says nothing."""
    seen = {"symmetric": (a != a.T).nnz == 0,
            "full_diagonal": bool(np.all(a.diagonal() != 0))}
    return [k for k, v in seen.items() if v != published.get(k, True)]


@functools.lru_cache(maxsize=None)
def replica(name):
    cfg = spec.load_json(BENCH / "configs" / f"{name}.json")
    family = spec.load_module(BENCH / "inputs" / f"{cfg['family']}.py",
                              "fidelity")
    return inputs.structure(family, cfg, cfg["structure_seed"])


@pytest.mark.parametrize("name", PUBLISHED)
def test_the_replica_does_the_published_work(name):
    pub = spec.load_json(BENCH / "configs" / f"{name}.json")["published"]
    a = replica(name)
    assert a.shape == (pub["m"], pub["n"])
    assert abs(a.nnz - pub["nnz"]) <= inputs.NNZ_TOLERANCE * pub["nnz"]
    products = inputs.products(a.indptr, a.indices, a.indptr)
    nnz_c = (a @ a).nnz
    assert {"cage12", "cant"} <= set(PUBLISHED)
    assert abs(products / pub["products"] - 1) <= WORK_TOLERANCE, products
    assert abs(nnz_c / pub["nnz_c"] - 1) <= WORK_TOLERANCE, nnz_c
    # the stated structure (symmetric, full diagonal unless it says
    # otherwise), sorted rows, no repeats
    assert structure_faults(a, pub) == []
    assert a.has_sorted_indices and a.has_canonical_format


# a directed graph with an empty diagonal entry, as a web crawl is
DIRECTED = sp.csr_matrix(np.array([[1.0, 2.0, 0.0], [0.0, 0.0, 3.0],
                                   [4.0, 0.0, 5.0]]))
BOTH = {"symmetric": False, "full_diagonal": False}


@pytest.mark.parametrize("matrix,declared,faults", [
    ("cage12", {}, []),
    ("cage12", {"symmetric": False}, ["symmetric"]),
    ("cage12", {"full_diagonal": False}, ["full_diagonal"]),
    ("cage12", BOTH, ["symmetric", "full_diagonal"]),
    ("directed", BOTH, []),
    ("directed", {}, ["symmetric", "full_diagonal"]),
    ("directed", {"symmetric": False}, ["full_diagonal"]),
    ("directed", {"full_diagonal": False}, ["symmetric"])])
def test_the_structure_check_holds_a_replica_to_its_declaration(
        matrix, declared, faults):
    """cage12's replica (symmetric, full diagonal) and a directed graph,
    each against copies of cage12's published facts that declare either
    structure: the check reads each key both ways."""
    pub = spec.load_json(BENCH / "configs" / "cage12.json")["published"]
    a = replica("cage12") if matrix == "cage12" else DIRECTED
    assert structure_faults(a, dict(pub, **declared)) == faults


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
