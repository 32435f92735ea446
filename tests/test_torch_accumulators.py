"""PyTorch port, the remaining accumulators against the JAX package: the
plain versions of K11 (dense row), K12 (hash) and K7 (the bf16 serve
lane, with its key packing), and the plain-XLA routes ell, dia, dense
and coo. The JAX side runs its Pallas kernels in interpret mode, pinned
to float32 (tests/conftest.py turns x64 on). The CUDA kernels against
these plain versions: tests/test_torch_kernels_cuda.py.

Tolerances: structure exact; values within 1e-5 * max(1, max|C|) of the
JAX package (sums in another order), 1e-4 of the scipy oracle."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental import pallas as pl

from ia_spgemm_tpu.formats import convert as jconvert
from ia_spgemm_tpu.formats.types import CSR as JCSR
from ia_spgemm_tpu.ops import bitonic as jbt
from ia_spgemm_tpu.ops import dense as jdense
from ia_spgemm_tpu.ops import dense_row as jdr
from ia_spgemm_tpu.ops import dia as jdia
from ia_spgemm_tpu.ops import ell as jell_ops
from ia_spgemm_tpu.ops import esc as jesc
from ia_spgemm_tpu.ops import hash_spgemm as jhash
from ia_spgemm_tpu_torch.formats import convert as tconvert
from ia_spgemm_tpu_torch.formats.types import CSR as TCSR
from ia_spgemm_tpu_torch.formats.types import ELL as TELL
from ia_spgemm_tpu_torch.formats.types import Dense as TDense
from ia_spgemm_tpu_torch.ops import bitonic as tbt
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
from ia_spgemm_tpu_torch.ops import dense as tdense
from ia_spgemm_tpu_torch.ops import dense_row as tdr
from ia_spgemm_tpu_torch.ops import dia as tdia
from ia_spgemm_tpu_torch.ops import ell as tell_ops
from ia_spgemm_tpu_torch.ops import esc as tesc
from ia_spgemm_tpu_torch.ops import hash_spgemm as thash
from tests import fixtures
from tests.torch_parity import (RUN, assert_same, assert_tables_match,
                                assert_values_close, jell, table_inputs,
                                tell)


def _f32(a):
    return a.astype(np.float32)


def _jtables(C):
    """A JAX hash ELL as the port's (col, val, nnz) tensors."""
    return (torch.from_numpy(np.array(C.col_ind)),
            torch.from_numpy(np.array(C.values)),
            torch.from_numpy(np.array(C.nnz_row)))


# ------------------------------------------------------------ K11 dense_row

@pytest.mark.parametrize("name,m,k,n,da,db", [
    ("small", 16, 16, 16, 0.3, 0.3),
    ("rect", 24, 10, 32, 0.25, 0.4),
    ("tall", 40, 8, 8, 0.3, 0.5),
    ("uneven_tile", 13, 13, 13, 0.3, 0.3),
])
def test_dense_row_plain_matches_jax(name, m, k, n, da, db):
    """The shapes of tests/test_dense_row.py."""
    a = _f32(fixtures.random_csr(m, k, density=da, seed=70))
    b = _f32(fixtures.random_csr(k, n, density=db, seed=71))
    J = jdr.spgemm_dense_row(jell(a), jconvert.csr_to_dense(
        JCSR.from_scipy(b)))
    T = tdr.spgemm_dense_row(tell(a), tconvert.csr_to_dense(
        TCSR.from_scipy(b, device="cpu")))
    assert T.values.dtype == torch.float32
    assert_values_close(T.values, np.asarray(J.values))
    np.testing.assert_allclose(T.values.numpy(), (a @ b).toarray(),
                               rtol=1e-5, atol=1e-5)


def test_dense_row_empty_rows_and_oversized_n():
    a = sp.csr_matrix((np.float32([2.0]), ([3], [5])), shape=(16, 16))
    T = tdr.spgemm_dense_row(tell(a), TDense(
        values=torch.eye(16, dtype=torch.float32)))
    np.testing.assert_array_equal(T.values.numpy(), a.toarray())
    assert not T.values[torch.arange(16) != 3].any()
    wide = TDense(values=torch.zeros((16, tdr.MAX_N_F32 + 128)))
    with pytest.raises(ValueError, match="VMEM"):
        tdr.spgemm_dense_row(tell(a), wide)


# ------------------------------------------------------------ K12 hash

@pytest.mark.parametrize("name,m,k,n", [
    ("square", 16, 16, 16),
    ("rect", 12, 20, 9),
    ("uneven", 13, 13, 13),
])
def test_hash_plain_matches_jax(name, m, k, n):
    """The shapes of tests/test_hash.py, compared after compact_ell: nnz
    per row and each row's columns exact, values within tolerance."""
    a = _f32(fixtures.random_csr(m, k, density=0.25, seed=100))
    b = _f32(fixtures.random_csr(k, n, density=0.3, seed=101))
    J = jhash.spgemm_hash(jell(a), jell(b))
    T = thash.spgemm_hash(tell(a), tell(b))
    assert T.col_ind.shape == J.col_ind.shape
    got = (T.col_ind, T.values, T.nnz_row)
    assert_tables_match(got, _jtables(J), (m, n))
    C = tconvert.ell_to_csr(tconvert.compact_ell(T))
    np.testing.assert_allclose(C.to_scipy().toarray(), (a @ b).toarray(),
                               rtol=1e-5, atol=1e-5)


def test_hash_collision_chains_match_jax():
    """table_size=8 on an 8-column product: long probe chains."""
    a = _f32(fixtures.random_csr(8, 8, density=0.6, seed=102))
    J = jhash.spgemm_hash(jell(a), jell(a), table_size=8)
    T = thash.spgemm_hash(tell(a), tell(a), table_size=8)
    assert_tables_match((T.col_ind, T.values, T.nnz_row), _jtables(J),
                        (8, 8))


def test_hash_counts_numeric_zeros_as_the_jax_kernel():
    """A column whose products cancel still occupies its slot and
    counts in nnz_row."""
    a = sp.csr_matrix(np.array([[1.0, 1.0], [0.0, 0.0]], np.float32))
    b = sp.csr_matrix(np.array([[2.0, 0.0], [-2.0, 0.0]], np.float32))
    J = jhash.spgemm_hash(jell(a), jell(b))
    T = thash.spgemm_hash(tell(a), tell(b))
    assert T.nnz_row.tolist() == np.asarray(J.nnz_row).tolist() == [1, 0]


def test_hash_guards():
    big = _f32(fixtures.random_csr(2000, 2000, density=0.05, seed=103))
    with pytest.raises(ValueError, match="SMEM"):
        thash.spgemm_hash(tell(big), tell(big))
    a = fixtures.random_csr(8, 8, density=0.5, seed=1)
    A64 = tconvert.csr_to_ell(TCSR.from_scipy(a, device="cpu"),
                              check_guard=False)
    assert A64.dtype == torch.float64
    with pytest.raises(ValueError, match="f32"):
        thash.spgemm_hash(A64, A64)
    A = tell(fixtures.random_csr(20, 20, density=0.5, seed=2))
    with pytest.raises(ValueError, match="may not fit"):
        thash.spgemm_hash(A, A, table_size=16)
    for ka, kb, n in [(29, 29, 32768), (64, 64, 100), (3, 200, 5000),
                      (1, 1, 1), (100, 100, 10**6)]:
        assert thash.hash_viable(ka, kb, n) == jhash.hash_viable(ka, kb, n)


# ------------------------------------------------ K7 bf16 serve lane

def test_pack_unpack_colval_bit_identical_to_jax():
    """Round to nearest even on negative products, ties, the 0xFFFE cap,
    zeros, subnormals, infinities and column 32767."""
    rng = np.random.default_rng(7)
    vals = np.concatenate([
        rng.standard_normal(500).astype(np.float32) * 1e3,
        np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 3e38, -3e38,
                  np.inf, -np.inf, np.nan], np.float32),
        # ties at the bf16 boundary, both parities, both signs
        np.array([0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,
                  0x7F7FFFFF, 0xFF7FFFFF], np.uint32).view(np.float32)])
    cols = rng.integers(0, 32768, vals.size).astype(np.int32)
    cols[:3] = [0, 32767, 1]
    jp = np.asarray(jbt._pack_colval(jnp.asarray(cols), jnp.asarray(vals)))
    tp = K._pack_colval(torch.from_numpy(cols), torch.from_numpy(vals))
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert (tp.numpy() != K.SENTINEL).all()
    pk = np.append(jp, K.SENTINEL).astype(np.int32)
    jk, jv = jbt._unpack_colval(jnp.asarray(pk))
    tk, tv = K._unpack_colval(torch.from_numpy(pk))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))


def _jax_packed_keys(g, avT, *, ka, width):
    """The JAX package's _expand_sort_kernel_packed in interpret mode,
    as _sort_compress_from_gather_packed launches it: sorted keys
    (width, m), returned (m, width)."""
    m, lanes = avT.shape[1], g.shape[2]
    L = 128
    out, = pl.pallas_call(
        functools.partial(jbt._expand_sort_kernel_packed, ka=ka, run=RUN,
                          width=width, start_kk=2 * RUN,
                          static_strides=False),
        grid=(pl.cdiv(m, L),),
        in_specs=[pl.BlockSpec((ka, L, lanes), lambda i: (0, i, 0)),
                  pl.BlockSpec((ka, L), lambda i: (0, i))],
        out_specs=(pl.BlockSpec((width, L), lambda i: (0, i)),),
        out_shape=(jax.ShapeDtypeStruct((width, m), jnp.int32),),
        interpret=True,
    )(jnp.asarray(g.numpy()), jnp.asarray(avT.numpy()))
    return np.asarray(out).T


@pytest.mark.parametrize("ka", [16, 128])
def test_packed_sort_keys_bit_identical_to_jax(ka):
    """K7a's plain version: the same multiset of packed keys, so the same
    sorted array, bit for bit (widths 128 and 1024; NaN A values on the
    empty rows are masked by column)."""
    table, rT, avT, width = table_inputs(ka)
    got = K.expand_sort_packed(table, rT, avT, ka=ka, run=RUN, width=width,
                               start_kk=2 * RUN)
    np.testing.assert_array_equal(
        got.numpy(), _jax_packed_keys(K.table_gather(table, rT), avT,
                                      ka=ka, width=width))


@pytest.mark.parametrize("compact", [True, False])
def test_compress_packed_matches_jax(compact):
    """K7b's plain version against the JAX packed pipeline, compacted
    and with holes (out_width ignored when not compacting)."""
    table, rT, avT, width = table_inputs(32, seed=5)
    g = K.table_gather(table, rT)
    want = jbt._sort_compress_from_gather_packed(
        jnp.asarray(g.numpy()), jnp.asarray(avT.numpy()), width=width,
        run=RUN, ka=32, start_kk=2 * RUN, interpret=True, out_width=128,
        compact=compact)
    p = K.expand_sort_packed(table, rT, avT, ka=32, run=RUN, width=width,
                             start_kk=2 * RUN)
    out_w = 128 if compact else width
    col, val, nnz = K.compress_packed(p, width=width, out_w=out_w,
                                      compact=compact)
    assert_same(nnz, np.asarray(want[2]), "nnz")
    assert_same(col, np.asarray(want[0]), "col")
    assert_values_close(val, np.asarray(want[1]), "val")


@pytest.mark.parametrize("compact", [True, False])
def test_serve_lane_matches_jax(compact):
    rng = np.random.RandomState(5)
    a = sp.random(96, 96, density=0.06, format="csr", dtype=np.float32,
                  random_state=rng)
    a.data[:] = rng.standard_normal(a.nnz).astype(np.float32)
    J = jbt.spgemm_bitonic(jell(a), jell(a), value_mode="bf16",
                           compact=compact)
    T = tbt.spgemm_bitonic(tell(a), tell(a), value_mode="bf16",
                           compact=compact)
    assert_same(T.col_ind, J.col_ind, "col_ind")
    assert_same(T.nnz_row, J.nnz_row, "nnz_row")
    assert_values_close(T.values, J.values, "values")
    want = (a.astype(np.float64) @ a.astype(np.float64)).toarray()
    got = T.to_scipy().toarray()
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-2
    assert int(T.nnz) == (a @ a).nnz


def test_serve_lane_rejections():
    a = sp.random(64, 64, density=0.1, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(0))
    A = tell(a)
    wide_B = TELL(col_ind=A.col_ind, values=A.values, nnz_row=A.nnz_row,
                  nnz=A.nnz, shape=(64, 40000))
    with pytest.raises(ValueError, match="15 bits"):
        tbt.spgemm_bitonic(A, wide_B, value_mode="bf16")
    A64 = tconvert.csr_to_ell(TCSR.from_scipy(a.astype(np.float64),
                                              device="cpu"),
                              check_guard=False)
    with pytest.raises(ValueError, match="fused-expand"):
        tbt.spgemm_bitonic(A64, A64, value_mode="bf16")
    with pytest.raises(ValueError, match="fused-expand"):
        tbt.spgemm_bitonic(A, A, layout="rows", value_mode="bf16")


# ------------------------------------------- the plain-XLA routes

MATS = {"random": _f32(fixtures.random_csr(40, 40, density=0.1, seed=3)),
        "banded": _f32(fixtures.banded_csr(64, bandwidth=2, seed=4))}


def _check_oracle(C, a, tol=1e-4):
    want = (a.astype(np.float64) @ a.astype(np.float64)).toarray()
    np.testing.assert_allclose(C.to_scipy().toarray(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", sorted(MATS))
def test_ell_route_matches_jax(name):
    a = MATS[name]
    J = jell_ops.spgemm_ell(jell(a), jell(a))
    T = tell_ops.spgemm_ell(tell(a), tell(a))
    assert_same(T.col_ind, J.col_ind, "col_ind")
    assert_same(T.nnz_row, J.nnz_row, "nnz_row")
    assert_values_close(T.values, J.values, "values")
    _check_oracle(T, a)


@pytest.mark.parametrize("name", sorted(MATS))
def test_dia_route_matches_jax(name):
    a = MATS[name]
    Jd = jconvert.csr_to_dia(JCSR.from_scipy(a), check_guard=False)
    Td = tconvert.csr_to_dia(TCSR.from_scipy(a, device="cpu"),
                             check_guard=False)
    J, T = jdia.spgemm_dia(Jd, Jd), tdia.spgemm_dia(Td, Td)
    assert_same(T.offsets, J.offsets, "offsets")
    assert_same(T.diag_ind, J.diag_ind, "diag_ind")
    assert int(T.nnz) == int(J.nnz)
    assert_values_close(T.values, J.values, "values")
    _check_oracle(tconvert.dia_to_csr(T), a)


def test_dia_compute_budget_rejects_before_dispatch():
    assert tdia.DIA_PAIR_FLOP_BUDGET == jdia.DIA_PAIR_FLOP_BUDGET
    for nd, m in [(5, 262144), (2047, 1024), (100, 26844)]:
        assert tdia.dia_compute_viable(nd, nd, m) == \
            jdia.dia_compute_viable(nd, nd, m)
    d = tconvert.csr_to_dia(TCSR.from_scipy(sp.eye(300, format="csr"),
                                            device="cpu"),
                            check_guard=False)
    wide = type(d)(offsets=torch.arange(1000, dtype=torch.int32) - 500,
                   values=torch.zeros((300, 1000)), diag_ind=d.diag_ind,
                   nnz=d.nnz, shape=d.shape)
    with pytest.raises(ValueError, match="compute budget"):
        tdia.spgemm_dia(wide, wide)


@pytest.mark.parametrize("name", sorted(MATS))
def test_dense_route_matches_jax(name):
    a = MATS[name]
    J = jdense.spgemm_dense(JCSR.from_scipy(a), JCSR.from_scipy(a))
    T = tdense.spgemm_dense(TCSR.from_scipy(a, device="cpu"),
                            TCSR.from_scipy(a, device="cpu"))
    assert T.values.dtype == torch.float32
    assert_values_close(T.values, np.asarray(J.values))
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("name", sorted(MATS))
def test_coo_route_matches_jax(name):
    a = MATS[name]
    Jc = jconvert.csr_to_coo(JCSR.from_scipy(a))
    Tc = tconvert.csr_to_coo(TCSR.from_scipy(a, device="cpu"))
    J, T = jesc.spgemm_coo(Jc, Jc), tesc.spgemm_coo(Tc, Tc)
    nnz = int(J.nnz)
    assert int(T.nnz) == nnz
    for f in ("row_offset", "row_ind", "col_ind"):
        assert_same(getattr(T, f)[:nnz], np.asarray(getattr(J, f))[:nnz], f)
    assert_values_close(T.values[:nnz], np.asarray(J.values)[:nnz])
    _check_oracle(T, a)
    # a sliced plan runs the sliced engine
    plan = tesc.plan_spgemm(tconvert.coo_to_csr(Tc), tconvert.coo_to_csr(Tc),
                            workspace_elems=64)
    assert plan.slabs is not None
    _check_oracle(tesc.spgemm_coo(Tc, Tc, plan), a)
