"""PyTorch port, the cols layout (K5, K6 + K3 over the torch expand) and
the float64 width-class route, against the JAX package (Pallas in
interpret mode, under the suite's x64 setting).

Covered: ``_expand_ell`` (float32 / float64, chunks 1 and 3, padded class
rows with NaN A values); ``_sort_compress_cols`` (K5 at width 256, K6 +
K3 at 1024, with an out_width cap) on the same expanded rows; the flat
``spgemm_bitonic`` in float64 (layout auto and rows) and in float32
outside the gather budget (B rows <= 2: K5; <= 8: K6 + K3); the
width-class route in float64 against the JAX package's
``layout="chunked"`` (ELL and BlockCSR), the classes above 1024 through
K4 in float64; ``layout=`` forced on float32; a float64 B-skewed input
(the port answers or declines, the JAX package's ragged probe raises);
the harness's ``bitonic`` row on a float64 CSR.

Tolerances: structure (columns, row counts, block pointers) identical;
float32 values within 1e-5 * max(1, max|C|), float64 values within
1e-12 * max(1, max|C|) (duplicates are summed in another order); against
the float64 scipy oracle 1e-4 (float32) and 1e-9 (float64, the
harness's gate).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp
from ia_spgemm_tpu.bench import harness as jharness
from ia_spgemm_tpu.formats.types import CSR as JCSR
from ia_spgemm_tpu.ops import bitonic as jbt
from ia_spgemm_tpu_torch.bench import harness as tharness
from ia_spgemm_tpu_torch.formats.types import CSR as TCSR
from ia_spgemm_tpu_torch.ops import bitonic as tbt
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
from tests import fixtures
from tests.torch_parity import (F64_RTOL, assert_same,
                                assert_values_close, cols_inputs, host,
                                jell, tell, value_rtol)

F64_ORACLE_TOL = 1e-9
DTYPES = {"f32": np.float32, "f64": np.float64}


def _check_oracle(a, b, C, tol):
    want = (a.astype(np.float64) @ b.astype(np.float64)).tocsr()
    d = abs(C.to_scipy() - want)
    err = d.max() if d.nnz else 0.0
    assert err <= tol * max(1.0, abs(want).max()), err
    assert int(C.nnz) == want.nnz


def _assert_ell_matches(T, J):
    assert_same(T.col_ind, J.col_ind, "col_ind")
    assert_same(T.nnz_row, J.nnz_row, "nnz_row")
    assert host(T.values).dtype == np.asarray(J.values).dtype
    assert_values_close(T.values, J.values, "values",
                        value_rtol(J.values))


def _rows_matrix(m, n, lens, seed):
    """m x n, row r holding lens[r] distinct random columns."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), lens)
    cols = np.concatenate([rng.choice(n, size=k, replace=False)
                           for k in lens])
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(m, n))


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls of the cols layout's and the gather route's
    kernel wrappers (on the CPU they run the plain versions)."""
    calls = {}
    for name in ("expand_sort_compress", "expand_sort", "compress",
                 "sort_compress_rows", "sort_compress", "sort_only"):
        fn = getattr(K, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(K, name, spy)
    return calls


# ---------------------------------------------------------- _expand_ell

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("chunks", [1, 3])
def test_expand_ell_matches_jax(dtype, chunks):
    """Keys identical, values identical to the rounding of one product,
    padded rows (col INT32_MIN, A value NaN) all SENTINEL / 0."""
    dt = DTYPES[dtype]
    run = 8
    a = _rows_matrix(40, 60, np.random.default_rng(1).integers(0, 9, 40),
                     seed=2)
    b = _rows_matrix(60, 50, np.random.default_rng(3).integers(
        0, chunks * run + 1, 60), seed=4)
    A, B = tell(a, dtype=dt), tell(b, dtype=dt)
    a_col = np.concatenate([host(A.col_ind),
                            np.full((3, A.col_ind.shape[1]), -2**31,
                                    np.int32)])
    a_val = np.concatenate([host(A.values),
                            np.full((3, A.values.shape[1]), np.nan, dt)])
    ka = a_col.shape[1]
    width = max(128, tbt._next_pow2(ka * chunks * run))
    import torch
    tk, tv = tbt._expand_ell(torch.from_numpy(a_col),
                             torch.from_numpy(a_val), B.col_ind, B.values,
                             width=width, run=run, chunks=chunks)
    jk, jv = jbt._expand_ell(jnp.asarray(a_col), jnp.asarray(a_val),
                             jnp.asarray(host(B.col_ind)),
                             jnp.asarray(host(B.values)), width=width,
                             run=run, chunks=chunks)
    assert tk.shape == (a_col.shape[0], width)
    assert host(tv).dtype == np.asarray(jv).dtype == dt
    assert_same(tk, jk, "key")
    assert_values_close(tv, jv, "val", value_rtol(jv))
    assert (host(tk)[-3:] == K.SENTINEL).all()
    assert (host(tv)[-3:] == 0).all() and np.isfinite(host(tv)).all()


# ------------------------------------------------- K5, K6 + K3 vs the JAX

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ka,out_width", [(32, None), (32, 128),
                                          (128, None), (128, 300)])
def test_sort_compress_cols_matches_jax(kernel_calls, dtype, ka,
                                        out_width):
    """Width 256 (ka 32 at run 8) takes K5, width 1024 (ka 128) K6 then
    K3, in the port and the JAX package."""
    key, val, width = cols_inputs(ka, DTYPES[dtype], m=60, seed=ka)
    assert jbt.FUSED_MAX_WIDTH == tbt.FUSED_MAX_WIDTH
    assert width == 8 * ka
    got = tbt._sort_compress_cols(key, val, width=width, start_kk=16,
                                  out_width=out_width)
    want = jbt._sort_compress_cols(jnp.asarray(host(key)),
                                   jnp.asarray(host(val)), width=width,
                                   start_kk=16, interpret=True,
                                   out_width=out_width)
    fused = width <= tbt.FUSED_MAX_WIDTH
    assert kernel_calls == ({"sort_compress": 1} if fused
                            else {"sort_only": 1, "compress": 1})
    out_w = width if out_width is None else min(out_width, width)
    assert got[0].shape == (key.shape[0], out_w)
    assert_same(got[2], want[2], "nnz")
    assert_same(got[0], want[0], "col")
    assert_values_close(got[1], want[1], "val", value_rtol(want[1]))


# ------------------------------------------------------------ flat route

@pytest.mark.parametrize("seed,layout", [(3, "auto"), (5, "rows"),
                                         (7, "cols")])
def test_flat_float64_matches_jax(kernel_calls, seed, layout):
    rng = np.random.default_rng(seed)
    a = sp.random(96, 96, density=0.08, format="csr",
                  random_state=np.random.RandomState(seed))
    a.data[:] = rng.standard_normal(a.nnz)
    JA, TA = jell(a, np.float64), tell(a, dtype=np.float64)
    T = tbt.spgemm_bitonic(TA, TA, layout=layout)
    J = jbt.spgemm_bitonic(JA, JA, layout=layout)
    _assert_ell_matches(T, J)
    _check_oracle(a, a, T, F64_ORACLE_TOL)
    assert "expand_sort_compress" not in kernel_calls
    assert "expand_sort" not in kernel_calls
    if layout == "rows":
        assert kernel_calls == {"sort_compress_rows": 1}


@pytest.mark.parametrize("kb,route", [(2, "K5"), (8, "K6")])
def test_flat_float32_outside_gather_budget_matches_jax(kernel_calls, kb,
                                                        route):
    """A with rows of up to 101 entries: ka * 128 lanes > 8192, so the
    float32 flat route leaves the gather kernels for the cols layout, at
    width 256 (B rows <= 2, K5) or 1024 (B rows <= 8, K6 + K3)."""
    rng = np.random.default_rng(kb)
    lens_a = rng.integers(30, 102, 48)
    lens_a[0] = 101
    a = _rows_matrix(48, 200, lens_a, seed=kb)
    lens_b = rng.integers(0, kb + 1, 200)
    lens_b[0] = kb
    b = _rows_matrix(200, 150, lens_b, seed=kb + 1)
    JA, JB, TA, TB = jell(a), jell(b), tell(a), tell(b)
    plan = tbt.plan_bitonic(TA, TB)
    assert plan.width == (256 if kb == 2 else 1024)
    assert TA.max_nnz_per_row * max(128, 4 * plan.run) \
        > tbt._EXPAND_TILE_ELEMS
    T = tbt.spgemm_bitonic(TA, TB)
    J = jbt.spgemm_bitonic(JA, JB)
    _assert_ell_matches(T, J)
    _check_oracle(a, b, T, 1e-4)
    assert kernel_calls == ({"sort_compress": 1} if route == "K5"
                            else {"sort_only": 1, "compress": 1})


def test_flat_float32_within_gather_budget_keeps_gather_kernels(
        kernel_calls):
    a = fixtures.random_csr(40, 40, density=0.1, seed=9)
    A = tell(a)
    tbt.spgemm_bitonic(A, A)
    assert set(kernel_calls) <= {"expand_sort_compress", "expand_sort",
                                 "compress"}


def test_flat_float64_out_width_cap_matches_jax():
    a = fixtures.random_csr(64, 64, density=0.1, seed=12)
    JA, TA = jell(a, np.float64), tell(a, dtype=np.float64)
    T = tbt.spgemm_bitonic(TA, TA, out_width=128)
    J = jbt.spgemm_bitonic(JA, JA, out_width=128)
    assert T.col_ind.shape[1] == 128
    _assert_ell_matches(T, J)


# ------------------------------------------------ width-class route, f64

def _a_skew_pair(seed=31):
    """A with light rows (1-5 entries) and rows of 40, 100 and 150
    entries, times a B with rows of at most 6: the chunked plan (run 8)
    has classes 128, 512, 1024 and 2048, so K5, K6 + K3 and K4 all run."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 6, 256)
    for every, length in ((17, 40), (41, 100), (64, 150)):
        lens[::every] = length
    a = _rows_matrix(256, 256, lens, seed)
    b = _rows_matrix(256, 256, rng.integers(0, 7, 256), seed + 1)
    return a, b


@pytest.mark.parametrize("assemble", ["ell", "bcsr"])
def test_multiclass_float64_matches_jax_chunked(kernel_calls, assemble):
    a, b = _a_skew_pair()
    TA, TB = tell(a, dtype=np.float64), tell(b, dtype=np.float64)
    call = tbt.multiclass_planned(TA, TB, assemble=assemble)
    assert not call.ragged and call.widths == (128, 512, 1024, 2048)
    T = call()
    J = jbt.multiclass_planned(jell(a, np.float64), jell(b, np.float64),
                               assemble=assemble, layout="chunked")()
    if assemble == "ell":
        _assert_ell_matches(T, J)
    else:
        assert T.shape == J.shape
        assert_same(T.blk_ptr, J.blk_ptr, "blk_ptr")
        assert_same(T.nnz_row, J.nnz_row, "nnz_row")
        assert_same(T.col_blocks, J.col_blocks, "col_blocks")
        assert host(T.val_blocks).dtype == np.float64
        assert_values_close(T.val_blocks, J.val_blocks, "val_blocks",
                            F64_RTOL)
    _check_oracle(a, b, T, F64_ORACLE_TOL)
    fused = sum(w <= tbt.FUSED_MAX_WIDTH for w in call.widths)
    assert kernel_calls == {"sort_compress": fused,
                            "sort_only": 3 - fused, "compress": 3 - fused,
                            "sort_compress_rows": 1}


def test_multiclass_float64_square_matches_jax():
    """C = A @ A in float64 on the suite's narrow skewed matrix."""
    from tests.test_bitonic import _skewed
    a = _skewed(7, 300)
    T = tbt.spgemm_bitonic_multiclass(tell(a, dtype=np.float64),
                                      tell(a, dtype=np.float64))
    JA = jell(a, np.float64)
    J = jbt.spgemm_bitonic_multiclass(JA, JA, layout="chunked")
    _assert_ell_matches(T, J)
    _check_oracle(a, a, T, F64_ORACLE_TOL)


def test_float64_ragged_layout_not_viable():
    a = fixtures.random_csr(64, 64, density=0.05, seed=12)
    A = tell(a, dtype=np.float64)
    assert tbt.multiclass_planned(A, A, layout="ragged") is None


def _b_skew(seed=13, m=256):
    """tests/test_bitonic.py::test_multiclass_ragged_b_skew's input: a few
    rows of 160 entries among rows of 1-4."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(m):
        ln = 160 if r % 64 == 0 else int(rng.integers(1, 5))
        for c in rng.choice(m, size=ln, replace=False):
            rows.append(r)
            cols.append(int(c))
            vals.append(float(rng.standard_normal()))
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()


def test_float64_b_skew_declines_where_reference_raises():
    """The port holds float64 operands to the chunked layout, which a B
    row of 160 entries makes inviable here: it declines (None) where the
    JAX package's host-view probe plans the float32-only ragged layout
    and fails (TypeError at bitonic.py:1985)."""
    a = _b_skew()
    A = tell(a, dtype=np.float64)
    C = tbt.spgemm_bitonic_multiclass(A, A)
    if C is not None:
        _check_oracle(a, a, C, F64_ORACLE_TOL)
    assert tbt.multiclass_planned(A, A, layout="chunked") is None
    JA = jell(a, np.float64)
    with pytest.raises(TypeError):
        jbt.spgemm_bitonic_multiclass(JA, JA)


# -------------------------------------------------- forced layouts, f32

@pytest.mark.parametrize("layout", ["chunked", "ragged"])
def test_forced_layout_float32_matches_jax(layout):
    """The port's counterpart of tests/test_bitonic.py's forced-layout
    test: the same plan and output as the JAX package under each
    layout."""
    rng = np.random.default_rng(21)
    a = sp.random(128, 128, density=0.06,
                  random_state=np.random.RandomState(21), format="csr")
    a.data[:] = rng.standard_normal(a.nnz)
    TA, JA = tell(a), jell(a)
    call = tbt.multiclass_planned(TA, TA, layout=layout)
    assert call.ragged == (layout == "ragged")
    T = call()
    J = jbt.spgemm_bitonic_multiclass(JA, JA, layout=layout)
    _assert_ell_matches(T, J)
    _check_oracle(a, a, T, 1e-4)
    lens = host(TA.nnz_row)
    tplan, tW = tbt.plan_multiclass(lens, TA.max_nnz_per_row,
                                    a_col_h=host(TA.col_ind),
                                    b_len_h=lens.astype(np.int64),
                                    layout=layout)
    jplan, jW = jbt.plan_multiclass(lens, TA.max_nnz_per_row,
                                    a_col_h=host(TA.col_ind),
                                    b_len_h=lens.astype(np.int64),
                                    layout=layout)
    assert (tplan.run, tplan.widths, tplan.ragged) == \
        (jplan.run, jplan.widths, jplan.ragged)
    assert_same(tW, jW, "W")


def test_layout_option_checked_and_cached_apart():
    a = fixtures.random_csr(48, 48, density=0.08, seed=5)
    A = tell(a)
    with pytest.raises(ValueError, match="layout"):
        tbt.plan_multiclass(np.ones(4, np.int64), 4, layout="cols")
    tbt.clear_plan_cache()
    c1 = tbt.multiclass_planned(A, A, layout="chunked")
    c2 = tbt.multiclass_planned(A, A, layout="ragged")
    assert c1 is not c2 and not c1.ragged and c2.ragged
    assert tbt.multiclass_planned(A, A, layout="chunked") is c1
    tbt.clear_plan_cache()


# --------------------------------------------------------------- harness

def test_harness_bitonic_row_float64_matches_jax():
    """The bitonic row on a float64 CSR: ok in both harnesses, held to
    the 1e-9 gate, the JAX row's verified_sum and memory size."""
    a = fixtures.random_csr(48, 48, density=0.12, seed=11,
                            dtype=np.float64)
    menu = ("baseline", "bitonic", "csr")
    jrep = jharness.run_benchmark(JCSR.from_scipy(a), JCSR.from_scipy(a),
                                  menu, iters=1)
    trep = tharness.run_benchmark(TCSR.from_scipy(a), TCSR.from_scipy(a),
                                  menu, iters=1)
    base = trep.by_name("baseline").verified_sum
    for name in menu:
        j, t = jrep.by_name(name), trep.by_name(name)
        assert t.ok and j.ok and not t.error and not j.error, (t, j)
        assert abs(t.verified_sum - base) <= F64_ORACLE_TOL * max(
            1.0, abs(base))
        assert t.verified_sum == pytest.approx(j.verified_sum, rel=1e-12,
                                               abs=1e-12)
        assert t.memory_bytes == j.memory_bytes
