"""PyTorch port, the named corpus and the synthetic generators
(io/suitesparse.py) against the JAX package: the specs, the replicas of
tests/test_named_corpus.py's SMALL names bit for bit (the JAX suite
checks every name against its spec, so the larger replicas are not built
twice), every generator and synthetic_suite at m = 48 bit for bit, the
replica statistics, and the local collection on .mtx files the test
writes (a CSR on the CPU equal to the JAX reader's)."""

import os

import numpy as np
import pytest
import torch

from ia_spgemm_tpu.io import suitesparse as jss
from ia_spgemm_tpu_torch.formats.types import CSR as TCSR
from ia_spgemm_tpu_torch.io import mmio as tmmio
from ia_spgemm_tpu_torch.io import suitesparse as tss
from tests import fixtures

SMALL = ("poisson3Da", "pdb1HYS", "rma10", "cant", "scircuit",
         "m133-b3", "cage12", "2cubes_sphere")


def _bit_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def test_specs_are_the_jax_packages():
    assert tss.NAMED_SPECS == jss.NAMED_SPECS
    assert sorted(tss.GENERATORS) == sorted(jss.GENERATORS)


@pytest.mark.parametrize("name", SMALL)
def test_named_replica_bit_equal(name):
    a = tss.gen_named(name)
    _bit_equal(a, jss.gen_named(name))
    assert tss.replica_stats(a) == jss.replica_stats(a)
    assert a.shape == (tss.NAMED_SPECS[name]["m"],
                       tss.NAMED_SPECS[name]["n"])


def test_named_suite_streams_the_given_names():
    got = [(n, a.nnz) for n, a in tss.named_suite(["poisson3Da"], seed=1)]
    want = [(n, a.nnz) for n, a in jss.named_suite(["poisson3Da"], seed=1)]
    assert got == want


@pytest.mark.parametrize("gen", sorted(jss.GENERATORS))
@pytest.mark.parametrize("seed", [0, 3])
def test_generators_bit_equal(gen, seed):
    _bit_equal(tss.GENERATORS[gen](48, seed=seed),
               jss.GENERATORS[gen](48, seed=seed))


def test_synthetic_suite_bit_equal():
    got = list(tss.synthetic_suite(m=48))
    want = list(jss.synthetic_suite(m=48))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) == 12
    for (_, a), (_, b) in zip(got, want):
        _bit_equal(a, b)


def test_local_collection_and_fetch(tmp_path):
    assert tss.local_collection(str(tmp_path / "absent")) == {}
    paths = {kind: fixtures.mtx_file(tmp_path, kind)
             for kind in ("general_real", "symmetric_real")}
    coll = tss.local_collection(str(tmp_path))
    assert coll == jss.local_collection(str(tmp_path))
    assert sorted(coll) == sorted(os.path.splitext(os.path.basename(p))[0]
                                  for p in paths.values())
    for name in coll:
        T = tss.fetch(name, str(tmp_path), device="cpu")
        J = jss.fetch(name, str(tmp_path))
        assert isinstance(T, TCSR) and T.device == torch.device("cpu")
        for f in ("row_ptr", "col_ind", "values"):
            np.testing.assert_array_equal(getattr(T, f).numpy(),
                                          np.asarray(getattr(J, f)))
    with pytest.raises(FileNotFoundError, match="not_a_matrix"):
        tss.fetch("not_a_matrix", str(tmp_path), device="cpu")


def test_fetch_defaults_to_the_card(tmp_path, monkeypatch):
    path = fixtures.mtx_file(tmp_path, "general_real")
    name = os.path.splitext(os.path.basename(path))[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tss.fetch(name, str(tmp_path))
    assert tmmio.read_mtx_to_csr(path, device="cpu").nnz == \
        tss.fetch(name, str(tmp_path), device="cpu").nnz
