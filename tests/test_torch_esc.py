"""PyTorch port, ESC and the production CSR entry (ops/esc.py,
ops/symbolic.py, utils/scans.py) against the JAX package: the scans and
the symbolic pass, SpGEMMPlan field by field (gather, rowexpand and
sliced), the global engine in float32 and float64, the cost model and
its route choice, the tiled route through spgemm_csr_auto, the
expansion's plain path (K14's, ops/esc_kernels.py) against the products
written out in numpy, the compensated global core against the float64
oracle, dd_sum, and the harness's csr / esc / compensated rows.

Tolerances: structure (row pointers, columns, nnz, padding) identical;
float32 values within 1e-5 * max(1, max|C|) (duplicates summed in
another order), float64 values within 1e-12 * max(1, max|C|); predicted
route times within 1e-9 ms; compensated results within 1e-12 * max|C|
of the float64 oracle on the float32 inputs."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import bench
from ia_spgemm_tpu.bench import harness as jharness
from ia_spgemm_tpu.formats.types import CSR as JCSR
from ia_spgemm_tpu.ops import esc as jesc
from ia_spgemm_tpu.ops import symbolic as jsym
from ia_spgemm_tpu.utils import scans as jscans
from ia_spgemm_tpu_torch.bench import harness as tharness
from ia_spgemm_tpu_torch.formats.types import CSR as TCSR
from ia_spgemm_tpu_torch.formats.types import BlockCSR
from ia_spgemm_tpu_torch.ops import esc as tesc
from ia_spgemm_tpu_torch.ops import esc_kernels as tek
from ia_spgemm_tpu_torch.ops import symbolic as tsym
from ia_spgemm_tpu_torch.utils import scans as tscans
from tests import fixtures
from tests.test_route_dispatch import _skew_matrix
from tests.test_slab_dd import _ill_conditioned
from tests.test_spgemm import _pairs
from tests.torch_parity import (DD_RTOL, ESC_EXPAND_CASES,
                                ESC_EXPAND_TYPES, assert_same,
                                assert_same_bits, assert_values_close,
                                esc_expand_case, esc_expand_reference,
                                esc_expand_tensors, host)

REPO = Path(__file__).resolve().parents[1]
F64_RTOL = 1e-12


def _long_row():
    """A long row among short ones: the gather variant (rowexpand would
    more than double the sort)."""
    a = sp.random(96, 96, density=0.03, format="lil",
                  random_state=np.random.RandomState(8))
    a[3] = np.linspace(1.0, 2.0, 96)
    return a.tocsr()


PAIRS = {name: (a, b) for name, a, b in _pairs()}
PAIRS["headline256"] = (bench.build_matrix(m=256),) * 2
PAIRS["long_row"] = (_long_row(),) * 2
DTYPES = {"f32": np.float32, "f64": np.float64}


def _both(a, b, dt):
    a, b = a.astype(dt), b.astype(dt)
    return (JCSR.from_scipy(a), JCSR.from_scipy(b),
            TCSR.from_scipy(a, device="cpu"), TCSR.from_scipy(b, device="cpu"))


def _assert_csr_matches(T, J, dt):
    """Exact structure over the whole capacity (padding included)."""
    assert T.shape == J.shape
    for f in ("row_ptr", "col_ind", "nnz"):
        assert_same(getattr(T, f), getattr(J, f), f)
    got, want = host(T.values), np.asarray(J.values)
    assert got.dtype == want.dtype
    if dt == np.float32:
        assert_values_close(got, want, "values")
    elif want.size:
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= F64_RTOL * scale


def _oracle64(a, b):
    return (a.astype(np.float64) @ b.astype(np.float64)).tocsr()


# ----------------------------------------------------- scans and symbolic

ROW_PTRS = {"mixed": [0, 0, 3, 3, 7, 8, 8], "dense": [0, 2, 4, 6],
            "all_empty": [0, 0, 0, 0]}


@pytest.mark.parametrize("name", sorted(ROW_PTRS))
def test_entry_rows_matches_jax(name):
    rp = np.asarray(ROW_PTRS[name], np.int32)
    cap = max(int(rp[-1]), 1) + 3
    want = np.asarray(jscans.entry_rows(jnp.asarray(rp), cap))
    got = tscans.entry_rows(torch.from_numpy(rp), cap)
    assert got.dtype == torch.int32
    assert_same(got, want)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_symbolic_pass_matches_jax(name):
    a, b = PAIRS[name]
    JA, JB, TA, TB = _both(a, b, np.float32)
    assert_same(tsym.row_flops_csr(TA.row_ptr, TA.col_ind, TA.nnz,
                                   TB.row_ptr),
                jsym.row_flops_csr(JA.row_ptr, JA.col_ind, JA.nnz,
                                   JB.row_ptr))
    t = tsym.plan_symbolic(TA, TB, return_rows=True)
    j = jsym.plan_symbolic(JA, JB, return_rows=True)
    assert t[:3] == j[:3]
    assert_same(t[3], j[3])


def test_symbolic_int64_host_fallback_matches_jax():
    """max_row_nnz(A) * max_row_nnz(B) >= 2^31: per-row flops on the host
    in int64 (symbolic.py:57-74)."""
    k = 46341
    a = sp.csr_matrix((np.ones(k, np.float32), np.arange(k), [0, k, k]),
                      shape=(2, k))
    b = sp.csr_matrix((np.ones(k, np.float32), np.arange(k),
                       np.r_[0, np.full(k, k)]), shape=(k, k))
    JA, JB, TA, TB = _both(a, b, np.float32)
    t = tsym.plan_symbolic(TA, TB, return_rows=True)
    assert t[:3] == jsym.plan_symbolic(JA, JB)
    assert_same(t[3], [k, 0])


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_plan_spgemm_matches_jax(name, dt):
    a, b = PAIRS[name]
    JA, JB, TA, TB = _both(a, b, DTYPES[dt])
    assert dataclasses.asdict(tesc.plan_spgemm(TA, TB)) == \
        dataclasses.asdict(jesc.plan_spgemm(JA, JB))


@pytest.mark.parametrize("ws", [150, 1000])
def test_sliced_plan_matches_jax(ws):
    a = fixtures.random_csr(60, 60, density=0.15, seed=21)
    JA, _, TA, _ = _both(a, a, np.float64)
    t, j = tesc.plan_spgemm(TA, TA, workspace_elems=ws), \
        jesc.plan_spgemm(JA, JA, workspace_elems=ws)
    assert t.slabs is not None
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_plan_guards_match_jax():
    a = fixtures.random_csr(8, 8, density=0.9, seed=22)
    JA, _, TA, _ = _both(a, a, np.float64)
    for mod, A in ((tesc, TA), (jesc, JA)):
        with pytest.raises(ValueError, match="row-partition"):
            mod.plan_spgemm(A, A, workspace_elems=3)


# ---------------------------------------------------------- global engine

@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_global_engine_matches_jax(name, dt):
    a, b = PAIRS[name]
    JA, JB, TA, TB = _both(a, b, DTYPES[dt])
    T = tesc.spgemm_csr(TA, TB)
    _assert_csr_matches(T, jesc.spgemm_csr(JA, JB), DTYPES[dt])
    want = _oracle64(a.astype(DTYPES[dt]), b.astype(DTYPES[dt]))
    d = abs(T.to_scipy() - want)
    tol = 1e-5 if dt == "f32" else F64_RTOL
    assert (d.max() if d.nnz else 0.0) <= tol * max(1.0, abs(want).max()
                                                    if want.nnz else 0.0)


def test_both_variants_match_jax():
    """The same float32 problem through the rowexpand and the gather
    expansion (a plan forced to gather), in both packages."""
    a = fixtures.random_csr(80, 64, density=0.12, seed=80)
    b = fixtures.random_csr(64, 96, density=0.1, seed=81)
    JA, JB, TA, TB = _both(a, b, np.float32)
    plan = tesc.plan_spgemm(TA, TB)
    assert plan.variant == "rowexpand"
    assert tesc.plan_spgemm(*_both(*PAIRS["long_row"],
                                   np.float32)[2:]).variant == "gather"
    forced = dict(expansion_capacity=plan.expansion_capacity,
                  out_capacity=plan.out_capacity, flops=plan.flops)
    for tp, jp in ((plan, jesc.plan_spgemm(JA, JB)),
                   (tesc.SpGEMMPlan(**forced), jesc.SpGEMMPlan(**forced))):
        _assert_csr_matches(tesc.spgemm_csr(TA, TB, tp),
                            jesc.spgemm_csr(JA, JB, jp), np.float32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_sliced_engine_matches_jax(dt):
    a = fixtures.random_csr(60, 60, density=0.15, seed=21)
    JA, _, TA, _ = _both(a, a, DTYPES[dt])
    T = tesc.spgemm_csr(TA, TA, tesc.plan_spgemm(TA, TA,
                                                 workspace_elems=150))
    J = jesc.spgemm_csr(JA, JA, jesc.plan_spgemm(JA, JA,
                                                 workspace_elems=150))
    _assert_csr_matches(T, J, DTYPES[dt])
    assert int(host(T.row_ptr)[-1]) == int(T.nnz)


def test_sliced_mixed_dtype_matches_jax():
    a = fixtures.random_csr(40, 40, density=0.15, seed=28)
    JA32, JA64 = (JCSR.from_scipy(a.astype(d))
                  for d in (np.float32, np.float64))
    TA32, TA64 = (TCSR.from_scipy(a.astype(d), device="cpu")
                  for d in (np.float32, np.float64))
    T = tesc.spgemm_csr(TA32, TA64, tesc.plan_spgemm(TA32, TA64,
                                                     workspace_elems=150))
    J = jesc.spgemm_csr(JA32, JA64, jesc.plan_spgemm(JA32, JA64,
                                                     workspace_elems=150))
    assert T.values.dtype == torch.float64
    _assert_csr_matches(T, J, np.float64)


# ------------------------------------------ the expansion (K14's plain path)

@pytest.mark.parametrize("types", sorted(ESC_EXPAND_TYPES))
@pytest.mark.parametrize("case", ESC_EXPAND_CASES)
def test_esc_expand_plain_path_matches_the_definition(case, types):
    """The wrapper on CPU tensors (the engine's expansion and key
    formation, launching nothing) against the products written out in
    numpy: keys and values bit for bit, float32 / float64 / float32 into
    float64 / float32 x float64, int32 and int64 keys, empty A and B
    rows, entries past nnz, e_cap past the products, a sliced slab."""
    args, kw = esc_expand_case(case, ESC_EXPAND_TYPES[types])
    before = tek.launch_counts()
    key, val = tek.esc_expand(*esc_expand_tensors(args, "cpu"), **kw)
    assert tek.launch_counts() == before
    want_key, want_val = esc_expand_reference(args, **kw)
    assert_same_bits(key, want_key, "key")
    assert_same_bits(val, want_val, "value")


def test_slab_row_pointer_is_non_decreasing():
    """K14 finds an entry's row by a binary search of the row pointer:
    the sliced engine's slab pointer stays non-decreasing over the rows
    padded past m."""
    args, kw = esc_expand_case("slab", ESC_EXPAND_TYPES["f32"])
    rp = args[0]
    assert rp.shape == (kw["m"] + 1,)
    assert (np.diff(rp) >= 0).all() and rp[-1] == args[3]


def test_esc_expand_checks_its_operands_and_has_no_fallback():
    args, kw = esc_expand_case("empty_rows", ESC_EXPAND_TYPES["f32"])
    t = esc_expand_tensors(args, "cpu")
    with pytest.raises(ValueError, match="a_row_ptr"):
        tek.esc_expand(t[0][:-1], *t[1:], **kw)
    with pytest.raises(TypeError, match="a_col"):
        tek.esc_expand(t[0], t[1].long(), *t[2:], **kw)
    with pytest.raises(ValueError, match="b_val"):
        tek.esc_expand(*t[:6], t[6][:-1], **kw)
    meta = tuple(x.to("meta") if isinstance(x, torch.Tensor) else x
                 for x in t)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tek.esc_expand(*meta, **kw)
    with pytest.raises(TypeError, match="float64 operands"):
        tek.esc_expand(*meta[:6], meta[6].double(),
                       **dict(kw, val_dtype=torch.float32))


# ---------------------------------------------------------------- routing

ROUTE_INPUTS = {
    "headline2048": lambda: bench.build_matrix(m=2048).astype(np.float32),
    "skew2048": lambda: _skew_matrix().astype(np.float32),
    "skew512_f64": lambda: _skew_matrix(m=512, heavy_every=100,
                                        heavy_len=300),
    "ill_conditioned": lambda: _ill_conditioned(),
    "random200": lambda: fixtures.random_csr(200, 200, density=0.05,
                                             seed=7).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(ROUTE_INPUTS))
def test_predict_csr_route_ms_matches_jax(name):
    a = ROUTE_INPUTS[name]()
    JA, _, TA, _ = _both(a, a, a.dtype)
    t, j = tesc.predict_csr_route_ms(TA, TA), jesc.predict_csr_route_ms(
        JA, JA)
    assert t.keys() == j.keys()
    for route in j:
        assert t[route] == pytest.approx(j[route], abs=1e-9), route


@pytest.mark.parametrize("name", ["headline2048", "skew2048",
                                  "skew512_f64"])
def test_plan_csr_auto_picks_jax_route(name):
    a = ROUTE_INPUTS[name]()
    JA, _, TA, _ = _both(a, a, a.dtype)
    route, _call = tesc.plan_csr_auto(TA, TA)
    assert route == jesc.plan_csr_auto(JA, JA)[0]
    assert route == {"headline2048": "tiled", "skew2048": "hybrid",
                     "skew512_f64": "global"}[name]


def test_headline_auto_route_matches_chip_smoke():
    """chip_smoke.py holds the card's plan_csr_auto on the m=32768
    headline to the route the JAX package's cost model ranks first."""
    import chip_smoke
    a = bench.build_matrix().astype(np.float32)
    pred = jesc.predict_csr_route_ms(*_both(a, a, np.float32)[:2])
    assert min(pred, key=pred.get) == chip_smoke.HEADLINE_AUTO_ROUTE


def test_csr_auto_tiled_matches_jax():
    a = bench.build_matrix(m=256).astype(np.float32)
    JA, _, TA, _ = _both(a, a, np.float32)
    T = tesc.spgemm_csr_auto(TA, TA)
    J = jesc.spgemm_csr_auto(JA, JA)
    assert isinstance(T, BlockCSR)
    for f in ("blk_ptr", "nnz_row", "col_blocks", "nnz"):
        assert_same(getattr(T, f), getattr(J, f), f)
    assert_values_close(T.val_blocks, J.val_blocks, "val_blocks")


def test_tiled_route_declines_as_jax():
    a = fixtures.random_csr(64, 64, density=0.2, seed=7)
    _, _, T64, _ = _both(a, a, np.float64)
    assert tesc.plan_csr_tiled(T64, T64) is None
    _, _, T32, _ = _both(a, a, np.float32)
    orig = tesc.TILED_ELL_BUDGET_ELEMS
    try:
        tesc.TILED_ELL_BUDGET_ELEMS = 8
        assert tesc.plan_csr_tiled(T32, T32) is None
    finally:
        tesc.TILED_ELL_BUDGET_ELEMS = orig


# ------------------------------------------------------------ compensated

@pytest.mark.parametrize("m,seed", [(96, 11), (80, 7)])
def test_compensated_global_matches_jax_and_oracle(m, seed):
    a32 = _ill_conditioned(m=m, seed=seed)
    want = _oracle64(a32, a32)
    JA, _, TA, _ = _both(a32, a32, np.float32)
    T = tesc.spgemm_csr_compensated(TA, TA, engine="global")
    J = jesc.spgemm_csr_compensated(JA, JA, engine="global")
    assert isinstance(T, TCSR) and T.values_lo is not None
    for f in ("row_ptr", "col_ind", "nnz"):
        assert_same(getattr(T, f), getattr(J, f), f)
    scale = max(1.0, abs(want).max())
    d = abs(T.to_scipy() - want)
    assert d.max() <= DD_RTOL * scale
    assert abs(T.to_scipy() - J.to_scipy()).max() <= DD_RTOL * scale
    # hi is the float32 rounding of the value, lo the rest
    assert_same(T.values, T.values_f64().astype(np.float32))
    assert abs(float(T.checksum()) - want.sum()) \
        <= 1e-12 * max(1.0, abs(want).sum())


def test_compensated_guards_match_jax():
    a = fixtures.random_csr(60, 60, density=0.15, seed=26)
    JA, _, TA, _ = _both(a, a, np.float32)
    for mod, A in ((tesc, TA), (jesc, JA)):
        plan = mod.plan_spgemm(A, A, workspace_elems=150)
        with pytest.raises(ValueError, match="does not slice"):
            mod.spgemm_csr_compensated(A, A, plan)
    _, _, T64, _ = _both(a, a, np.float64)
    with pytest.raises(ValueError, match="float32"):
        tesc.spgemm_csr_compensated(T64, T64)


def test_dd_sum_is_float64_grade():
    rng = np.random.default_rng(9)
    x = rng.standard_normal(1000) * 1e6
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    h, l = tesc.dd_sum(torch.from_numpy(hi), torch.from_numpy(lo))
    want = float(np.sum(hi.astype(np.float64) + lo))
    assert h.dtype == l.dtype == torch.float32
    assert float(h) + float(l) == pytest.approx(want, rel=1e-14)
    jh, jl = jesc.dd_sum(jnp.asarray(hi), jnp.asarray(lo))
    assert float(h) + float(l) == pytest.approx(float(jh) + float(jl),
                                                rel=1e-13)


# ---------------------------------------------------------------- harness

@pytest.mark.parametrize("algo", ["csr", "esc", "compensated"])
def test_harness_row_matches_jax(algo):
    a = fixtures.random_csr(32, 32, density=0.15, seed=11,
                            dtype=np.float32)
    jrep = jharness.run_benchmark(JCSR.from_scipy(a), JCSR.from_scipy(a),
                                  ("baseline", algo), iters=1)
    trep = tharness.run_benchmark(TCSR.from_scipy(a, device="cpu"),
                                  TCSR.from_scipy(a, device="cpu"),
                                  ("baseline", algo), iters=1)
    j, t = jrep.by_name(algo), trep.by_name(algo)
    assert t.ok and j.ok and not t.error, t.error
    assert t.verified_sum == pytest.approx(j.verified_sum, rel=1e-5)
    assert t.memory_bytes == j.memory_bytes
    assert (t.trans_time_ms > 0) == (j.trans_time_ms > 0)


def test_esc_module_imports_with_jax_blocked():
    code = r"""
import sys
sys.modules["jax"] = None
import numpy as np, scipy.sparse as sp
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.ops import esc
a = sp.random(64, 64, density=0.08, format="csr", dtype=np.float32,
              random_state=np.random.RandomState(0))
A = CSR.from_scipy(a, device="cpu")
route, call = esc.plan_csr_auto(A, A)
C = esc.spgemm_csr(A, A)
assert abs(C.to_scipy() - a @ a).max() < 1e-5
assert not [m for m in sys.modules if m.split(".")[0] == "ia_spgemm_tpu"]
print("OK", route)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")
