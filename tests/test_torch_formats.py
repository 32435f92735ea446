"""PyTorch port, formats layer: CSR / ELL / BlockCSR round trips, the
conversions and bucket_capacity against the JAX package, .mtx read
parity, and the port's independence from JAX."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ia_spgemm_tpu import config as jcfg
from ia_spgemm_tpu.formats import convert as jconvert
from ia_spgemm_tpu.formats import types as jtypes
from ia_spgemm_tpu.io import mmio as jmmio
from ia_spgemm_tpu.ops import flops as jflops
from ia_spgemm_tpu_torch import config as tcfg
from ia_spgemm_tpu_torch.formats import convert as tconvert
from ia_spgemm_tpu_torch.formats import types as ttypes
from ia_spgemm_tpu_torch.io import mmio as tmmio
from ia_spgemm_tpu_torch.ops import flops as tflops
from tests import fixtures

REPO = Path(__file__).resolve().parents[1]


def _mats():
    a = fixtures.random_csr(40, 30, density=0.15, seed=3, dtype=np.float32)
    b = fixtures.banded_csr(64, bandwidth=2, seed=4).astype(np.float32)
    c = sp.csr_matrix((6, 5), dtype=np.float32)      # no entries
    d = sp.random(300, 200, density=0.02, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(5))
    d[7] = np.arange(200, dtype=np.float32)          # one 200-long row
    return {"random": a, "banded": b, "empty": c, "long_row": d.tocsr()}


MATS = _mats()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_scipy(x, y):
    x, y = x.tocsr(), y.tocsr()
    x.sort_indices()
    y.sort_indices()
    assert x.shape == y.shape
    assert np.array_equal(x.indptr, y.indptr)
    assert np.array_equal(x.indices, y.indices)
    np.testing.assert_array_equal(x.data, y.data)


@pytest.mark.parametrize("name", sorted(MATS))
@pytest.mark.parametrize("fmt", ["CSR", "ELL", "BlockCSR"])
def test_scipy_round_trip(name, fmt):
    a = MATS[name]
    X = getattr(ttypes, fmt).from_scipy(a, device="cpu")
    _same_scipy(X.to_scipy(), a)
    assert int(X.nnz) == a.nnz
    assert float(X.checksum()) == pytest.approx(float(a.sum()), rel=1e-6)
    assert X.to("cpu").to_scipy().nnz == a.nnz


@pytest.mark.parametrize("name", sorted(MATS))
def test_csr_to_ell_matches_jax(name):
    a = MATS[name]
    J = jconvert.csr_to_ell(jtypes.CSR.from_scipy(a), check_guard=False)
    T = tconvert.csr_to_ell(ttypes.CSR.from_scipy(a, device="cpu"),
                            check_guard=False)
    for f in ("col_ind", "values", "nnz_row", "nnz"):
        np.testing.assert_array_equal(_np(getattr(T, f)),
                                      np.asarray(getattr(J, f)), err_msg=f)
    # the viability guard and the width check agree too
    for ratio in (1.0, 3.0, 50.0):
        jg = jconvert.csr_to_ell(jtypes.CSR.from_scipy(a), ratio=ratio)
        tg = tconvert.csr_to_ell(ttypes.CSR.from_scipy(a, device="cpu"),
                                 ratio=ratio)
        assert (jg is None) == (tg is None), ratio
    if a.nnz:
        with pytest.raises(ValueError, match="truncate"):
            tconvert.csr_to_ell(ttypes.CSR.from_scipy(a, device="cpu"),
                                width=0)


@pytest.mark.parametrize("name", sorted(MATS))
def test_ell_to_csr_matches_jax(name):
    a = MATS[name]
    J = jconvert.ell_to_csr(
        jconvert.csr_to_ell(jtypes.CSR.from_scipy(a), check_guard=False))
    T = tconvert.ell_to_csr(
        tconvert.csr_to_ell(ttypes.CSR.from_scipy(a, device="cpu"),
                            check_guard=False))
    for f in ("row_ptr", "col_ind", "values", "nnz"):
        np.testing.assert_array_equal(_np(getattr(T, f)),
                                      np.asarray(getattr(J, f)), err_msg=f)


@pytest.mark.parametrize("name", sorted(MATS))
@pytest.mark.parametrize("extra_blocks", [0, 3])
def test_bcsr_to_csr_matches_jax(name, extra_blocks):
    """Same BlockCSR arrays into both packages' bcsr_to_csr, with tight
    spans and with dead padding blocks past blk_ptr[m]."""
    T0 = ttypes.BlockCSR.from_scipy(MATS[name], device="cpu")
    colb = np.concatenate([_np(T0.col_blocks),
                           np.full((extra_blocks, 128), -1, np.int32)])
    valb = np.concatenate([_np(T0.val_blocks),
                           np.zeros((extra_blocks, 128), np.float32)])
    arrays = (_np(T0.blk_ptr), colb, valb, _np(T0.nnz_row), _np(T0.nnz))
    T = ttypes.BlockCSR.from_numpy(*arrays, T0.shape, device="cpu")
    J = jtypes.BlockCSR(blk_ptr=jnp.asarray(arrays[0]),
                        col_blocks=jnp.asarray(colb),
                        val_blocks=jnp.asarray(valb),
                        nnz_row=jnp.asarray(arrays[3]),
                        nnz=jnp.asarray(arrays[4]), shape=T0.shape)
    Jc, Tc = jconvert.bcsr_to_csr(J), tconvert.bcsr_to_csr(T)
    for f in ("row_ptr", "col_ind", "values", "nnz"):
        np.testing.assert_array_equal(_np(getattr(Tc, f)),
                                      np.asarray(getattr(Jc, f)), err_msg=f)
    assert T.padded_bytes() == J.padded_bytes()


def test_from_numpy_takes_jax_pytree_arrays():
    a = MATS["random"]
    J = jconvert.csr_to_ell(jtypes.CSR.from_scipy(a), check_guard=False)
    T = ttypes.ELL.from_numpy(*(np.asarray(x) for x in (
        J.col_ind, J.values, J.nnz_row, J.nnz)), J.shape, device="cpu")
    assert T.values.dtype == torch.float32
    _same_scipy(T.to_scipy(), J.to_scipy())
    Jc = jtypes.CSR.from_scipy(a)
    Tc = ttypes.CSR.from_numpy(*(np.asarray(x) for x in (
        Jc.row_ptr, Jc.col_ind, Jc.values, Jc.nnz)), Jc.shape, device="cpu")
    _same_scipy(Tc.to_scipy(), Jc.to_scipy())
    np.testing.assert_array_equal(_np(Tc.nnz_row), np.diff(a.indptr))


def test_bucket_capacity_matches_jax():
    ns = list(range(0, 4100)) + [10**5 + 7, 2**20 + 1, 3 * 2**24 - 5]
    for n in ns:
        assert tcfg.bucket_capacity(n) == jcfg.bucket_capacity(n), n
        assert tcfg.bucket_capacity(n, enabled=False) == \
            jcfg.bucket_capacity(n, enabled=False), n


def test_get_flop_matches_jax():
    a, b = MATS["long_row"], MATS["random"]
    b = sp.random(200, 90, density=0.1, format="csr",
                  random_state=np.random.RandomState(2))
    assert tflops.get_flop(ttypes.CSR.from_scipy(a, device="cpu"),
                           ttypes.CSR.from_scipy(b, device="cpu")) == \
        jflops.get_flop(jtypes.CSR.from_scipy(a), jtypes.CSR.from_scipy(b))


@pytest.mark.parametrize("kind", fixtures.ALL_KINDS)
def test_mmio_read_matches_jax(tmp_path, kind):
    path = fixtures.mtx_file(tmp_path, kind)
    J = jmmio.read_mtx_to_csr(path, use_native=False)
    T = tmmio.read_mtx_to_csr(path, device="cpu")
    assert T.shape == J.shape
    for f in ("row_ptr", "col_ind", "values", "nnz"):
        np.testing.assert_array_equal(_np(getattr(T, f)),
                                      np.asarray(getattr(J, f)), err_msg=f)
    _same_scipy(T.to_scipy(), fixtures.scipy_oracle_from_text(kind))


def test_port_never_imports_jax_source_scan():
    """No module of the port imports jax or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|ia_spgemm_tpu)(\.|\s|$)",
                     re.M)
    files = sorted((REPO / "ia_spgemm_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


def test_port_runs_with_jax_blocked():
    """A fresh interpreter where `import jax` fails imports the port and
    runs spgemm_bitonic on the CPU."""
    code = r"""
import sys
sys.modules["jax"] = None
import numpy as np, scipy.sparse as sp
import ia_spgemm_tpu_torch as port
from ia_spgemm_tpu_torch.formats import convert
a = sp.random(48, 48, density=0.1, format="csr", dtype=np.float32,
              random_state=np.random.RandomState(0))
A = convert.csr_to_ell(port.CSR.from_scipy(a, device="cpu"),
                       check_guard=False)
C = port.spgemm_bitonic(A, A)
d = abs(C.to_scipy() - (a @ a))
assert (d.max() if d.nnz else 0.0) < 1e-4
assert not [m for m in sys.modules if m.split(".")[0] == "ia_spgemm_tpu"]
print("OK", int(C.nnz))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")


@pytest.mark.parametrize("name", sorted(MATS))
@pytest.mark.parametrize("fmt", ["COO", "DIA", "Dense"])
def test_scipy_round_trip_coo_dia_dense(name, fmt):
    """DIA keeps the in-band slots of its diagonals as explicit zeros, so
    the comparison drops stored zeros on both sides."""
    a = MATS[name]
    X = getattr(ttypes, fmt).from_scipy(a, device="cpu")
    back = X.to_scipy().tocsr()
    back.eliminate_zeros()
    ref = a.copy()
    ref.eliminate_zeros()
    _same_scipy(back, ref)
    # Dense counts nonzero values; the others keep the stored count
    assert int(X.nnz) == (ref.nnz if fmt == "Dense" else a.nnz)
    assert float(X.checksum()) == pytest.approx(float(a.sum()), rel=1e-6)
    _same_scipy(X.to("cpu").to_scipy(), X.to_scipy())


@pytest.mark.parametrize("name", sorted(MATS))
def test_coo_dia_dense_conversions_match_jax(name):
    a = MATS[name]
    JA, TA = jtypes.CSR.from_scipy(a), ttypes.CSR.from_scipy(a, device="cpu")
    Jc, Tc = jconvert.csr_to_coo(JA), tconvert.csr_to_coo(TA)
    for f in ("row_offset", "row_ind", "col_ind", "values", "nnz"):
        np.testing.assert_array_equal(_np(getattr(Tc, f)),
                                      np.asarray(getattr(Jc, f)), err_msg=f)
    Tb = tconvert.coo_to_csr(Tc)
    np.testing.assert_array_equal(_np(Tb.row_ptr), _np(TA.row_ptr))
    np.testing.assert_array_equal(tconvert.plan_dia_offsets(TA),
                                  jconvert.plan_dia_offsets(JA))
    Jd = jconvert.csr_to_dia(JA, check_guard=False)
    Td = tconvert.csr_to_dia(TA, check_guard=False)
    for f in ("offsets", "values", "diag_ind", "nnz"):
        np.testing.assert_array_equal(_np(getattr(Td, f)),
                                      np.asarray(getattr(Jd, f)), err_msg=f)
    Jr, Tr = jconvert.dia_to_csr(Jd), tconvert.dia_to_csr(Td)
    for f in ("row_ptr", "col_ind", "values", "nnz"):
        np.testing.assert_array_equal(_np(getattr(Tr, f)),
                                      np.asarray(getattr(Jr, f)), err_msg=f)
    for ratio in (1.0, 3.0, 50.0):
        assert (jconvert.csr_to_dia(JA, ratio=ratio) is None) == \
            (tconvert.csr_to_dia(TA, ratio=ratio) is None), ratio
    Jn, Tn = jconvert.csr_to_dense(JA), tconvert.csr_to_dense(TA)
    np.testing.assert_array_equal(_np(Tn.values), np.asarray(Jn.values))
    Jb, Tb = jconvert.dense_to_csr(Jn), tconvert.dense_to_csr(Tn)
    for f in ("row_ptr", "col_ind", "values", "nnz"):
        np.testing.assert_array_equal(_np(getattr(Tb, f)),
                                      np.asarray(getattr(Jb, f)), err_msg=f)


def test_csr_to_dia_drops_entries_off_the_given_offsets():
    a = MATS["banded"]
    offs = np.array([-1, 0, 2], np.int32)
    J = jconvert.csr_to_dia(jtypes.CSR.from_scipy(a), offsets=offs,
                            check_guard=False)
    T = tconvert.csr_to_dia(ttypes.CSR.from_scipy(a, device="cpu"),
                            offsets=offs,
                            check_guard=False)
    np.testing.assert_array_equal(_np(T.values), np.asarray(J.values))


def test_compact_ell_matches_jax():
    """Random interior holes, as the hash route's tables carry."""
    rng = np.random.default_rng(9)
    col = rng.integers(0, 50, (30, 16)).astype(np.int32)
    col[rng.random((30, 16)) < 0.6] = -1
    val = np.where(col >= 0, rng.standard_normal((30, 16)), 0).astype(
        np.float32)
    nnz_row = (col >= 0).sum(1).astype(np.int32)
    J = jconvert.compact_ell(jtypes.ELL(
        col_ind=jnp.asarray(col), values=jnp.asarray(val),
        nnz_row=jnp.asarray(nnz_row), nnz=jnp.asarray(nnz_row.sum()),
        shape=(30, 50)))
    T = tconvert.compact_ell(ttypes.ELL.from_numpy(col, val, nnz_row,
                                                   nnz_row.sum(), (30, 50),
                                                   device="cpu"))
    for f in ("col_ind", "values", "nnz_row"):
        np.testing.assert_array_equal(_np(getattr(T, f)),
                                      np.asarray(getattr(J, f)), err_msg=f)


def test_size_formulas_and_guards_match_jax():
    for m, n, nnz, k in [(10, 12, 30, 5), (32768, 32768, 556940, 29),
                         (4, 4, 0, 0), (1000, 10, 900, 1000)]:
        assert tconvert.sizeof_coo(m, nnz) == jconvert.sizeof_coo(m, nnz)
        assert tconvert.sizeof_dia(m, n, k) == jconvert.sizeof_dia(m, n, k)
        for ratio in (1.0, 20.0, 50.0):
            assert tconvert.coo_viable(m, nnz, ratio) == \
                jconvert.coo_viable(m, nnz, ratio)
            assert tconvert.dia_viable(m, n, nnz, k, ratio) == \
                jconvert.dia_viable(m, n, nnz, k, ratio)
    for f in ("timeout_scale", "default_timeout_s", "dense_bytes_budget",
              "bucket_capacities", "size_guard_ratio"):
        assert getattr(tcfg.DEFAULT_CONFIG, f) == \
            getattr(jcfg.DEFAULT_CONFIG, f), f
    assert tcfg.DENSITY_IMAGE_SIZE == jcfg.DENSITY_IMAGE_SIZE


@pytest.mark.parametrize("make", ["CSR", "COO", "DIA", "Dense", "ELL",
                                  "BlockCSR", "CSR.from_numpy",
                                  "read_mtx_to_csr"])
def test_constructors_default_to_the_card(tmp_path, make):
    """The constructors and the reader put a matrix on the card unless
    asked for the host, as the JAX package's land on its default device;
    with no card they raise instead of carrying on on the CPU."""
    a = (sp.eye(5, format="csr") * 2.0).tocsr()
    if make == "read_mtx_to_csr":
        path = str(tmp_path / "a.mtx")
        tmmio.write_mtx(path, ttypes.CSR.from_scipy(a, device="cpu"))

        def build(**kw):
            return tmmio.read_mtx_to_csr(path, **kw)
    elif make == "CSR.from_numpy":
        def build(**kw):
            return ttypes.CSR.from_numpy(a.indptr, a.indices, a.data, a.nnz,
                                         a.shape, **kw)
    else:
        def build(**kw):
            return getattr(ttypes, make).from_scipy(a, **kw)
    assert build(device="cpu").device == torch.device("cpu")
    assert abs(build(device="cpu").to_scipy() - a).max() == 0
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            build()
