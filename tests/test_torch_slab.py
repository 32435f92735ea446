"""PyTorch port, the slab engine (ops/slab.py, ops/slab_kernels.py) against
the JAX package: SlabPlan field by field, the plain versions of K8, K9
and K10 against the Pallas kernels (interpret mode) on the same slab
inputs, SlabCSR results, slab_to_csr (both engines), the compensated
slab pipeline against the float64 oracle, and the slab + global hybrid.

Tolerances: structure (keys, nnz, columns, row pointers) identical;
float32 values within 1e-5 * max(1, max|C|) (duplicates summed in
another order); compensated values (hi + lo in float64) within 1e-12 *
max(1, max|C|) of the float64 oracle, as tests/test_slab_dd.py holds the
JAX package. JAX results are computed once per module (each Pallas call
in interpret mode costs seconds here)."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import bench
from ia_spgemm_tpu.formats.types import CSR as JCSR
from ia_spgemm_tpu.ops import esc as jesc
from ia_spgemm_tpu.ops import slab as jslab
from ia_spgemm_tpu_torch.formats.types import CSR as TCSR
from ia_spgemm_tpu_torch.formats.types import SlabCSR
from ia_spgemm_tpu_torch.ops import bitonic_kernels as BK
from ia_spgemm_tpu_torch.ops import esc as tesc
from ia_spgemm_tpu_torch.ops import slab as tslab
from ia_spgemm_tpu_torch.ops import slab_kernels as SK
from tests import fixtures
from tests.test_route_dispatch import _skew_matrix
from tests.test_slab_dd import _ill_conditioned
from tests.torch_parity import (DD_RTOL, assert_dd_outputs_match,
                                assert_kernel_outputs_match, assert_same,
                                assert_values_close, host, ill_conditioned,
                                slab_gather_np, slab_operands)

REPO = Path(__file__).resolve().parents[1]


def _rect():
    rng = np.random.default_rng(11)
    a = sp.random(120, 90, density=0.08, random_state=rng, format="csr")
    b = sp.random(90, 150, density=0.06, random_state=rng, format="csr")
    return a, b


def _empty_rows():
    """Empty rows in A, and A entries pointing at empty B rows."""
    rng = np.random.default_rng(3)
    a = sp.random(64, 64, density=0.05, random_state=rng,
                  format="csr").tolil()
    a[5] = 0
    a[31] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    b = a.copy().tolil()
    b[np.unique(a.tocoo().col)[:3]] = 0
    b = b.tocsr()
    b.eliminate_zeros()
    return a, b


def _multirow():
    """Short rows: many rows per slab, keys must keep them apart."""
    rng = np.random.default_rng(5)
    lens = rng.integers(1, 4, 300)
    rows = np.repeat(np.arange(300), lens)
    cols = rng.integers(0, 300, rows.shape[0])
    a = sp.coo_matrix((rng.standard_normal(rows.shape[0]), (rows, cols)),
                      shape=(300, 300)).tocsr()
    a.sum_duplicates()
    return a, a


def _same(a):
    return a, a


PAIRS = {
    "random200": _same(fixtures.random_csr(200, 200, density=0.05,
                                           seed=7)),
    "rect": _rect(),
    "empty_rows": _empty_rows(),
    "multirow": _multirow(),
    "headline256": _same(bench.build_matrix(m=256)),
}
# (pair, planner overrides) for plan parity; run/width overrides too
PLAN_CASES = [(name, {}) for name in PAIRS] + [
    ("random200", {"run": 16}), ("multirow", {"width": 1024}),
    ("headline256", {"run": 8})]


def _ports(a, b):
    return (TCSR.from_scipy(a.astype(np.float32), device="cpu"),
            TCSR.from_scipy(b.astype(np.float32), device="cpu"))


def _jaxes(a, b):
    return (JCSR.from_scipy(a.astype(np.float32)),
            JCSR.from_scipy(b.astype(np.float32)))


def _oracle64(a, b):
    return (a.astype(np.float32).astype(np.float64)
            @ b.astype(np.float32).astype(np.float64)).tocsr()


def _assert_slabcsr_matches(T, J):
    assert T.shape == J.shape
    for f in ("keys", "nnz_slab", "slab_first_row", "nnz"):
        assert_same(getattr(T, f), getattr(J, f), f)
    if J.values_lo is None:
        assert T.values_lo is None
        assert_values_close(T.values, J.values, "values")
    else:
        assert_dd_outputs_match(
            (T.keys, T.values, T.values_lo, T.nnz_slab),
            (np.asarray(J.keys), np.asarray(J.values),
             np.asarray(J.values_lo), np.asarray(J.nnz_slab)))


def _assert_dd_oracle(C, want):
    d = abs(C.to_scipy().tocsr() - want)
    scale = max(1.0, abs(want).max())
    assert (d.max() if d.nnz else 0.0) <= DD_RTOL * scale


@pytest.fixture(scope="module")
def jax_slab():
    """JAX SlabCSR results, computed once per (pair, dd)."""
    cache = {}

    def get(name, dd=False):
        if (name, dd) not in cache:
            A, B = _jaxes(*PAIRS[name])
            cache[(name, dd)] = jslab.plan_slab_csr(A, B, dd=dd)()
        return cache[(name, dd)]
    return get


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("name,over", PLAN_CASES,
                         ids=[f"{n}-{o}" for n, o in PLAN_CASES])
def test_slab_plan_matches_jax(name, over):
    a, b = PAIRS[name]
    J = jslab._plan_slab_csr_uncached(*_jaxes(a, b), **over).plan
    T = tslab._plan_slab_csr_uncached(*_ports(a, b), **over).plan
    for f in ("width", "run", "n_slabs", "out_cap", "nnz_bound", "m", "n",
              "padded_slots", "true_flops"):
        assert getattr(T, f) == getattr(J, f), f
    for f in ("mt", "avt", "lrt", "table", "slab_first_row"):
        assert_same(getattr(T, f), getattr(J, f), f)


def test_slab_planner_declines_as_jax():
    """float64 operands, and a row whose padded products exceed the slab
    width cap: both planners return None (the JAX package's routing)."""
    a = fixtures.random_csr(32, 32, density=0.1, seed=1)
    A64 = TCSR.from_scipy(a.astype(np.float64), device="cpu")
    assert tslab.plan_slab_csr(A64, A64) is None
    assert jslab.plan_slab_csr(JCSR.from_scipy(a), JCSR.from_scipy(a)) \
        is None
    m = 64
    rows = np.concatenate([np.zeros(m, np.int64), np.arange(m)])
    cols = np.concatenate([np.arange(m), np.zeros(m, np.int64)])
    w = sp.coo_matrix((np.ones(2 * m, np.float32), (rows, cols)),
                      shape=(m, m)).tocsr()
    big = sp.csr_matrix(np.ones((m, m), np.float32))
    assert tslab.plan_slab_csr(*_ports(w, big)) is None
    assert jslab.plan_slab_csr(*_jaxes(w, big)) is None


def test_slab_plan_cache_keys_on_identity_and_version():
    a = fixtures.random_csr(100, 100, density=0.06, seed=13)
    A, _ = _ports(a, a)
    tslab.clear_plan_cache()
    c1 = tslab.plan_slab_csr(A, A)
    assert tslab.plan_slab_csr(A, A) is c1
    A.values.mul_(2.0)           # in-place edit: the version moves
    c2 = tslab.plan_slab_csr(A, A)
    assert c2 is not c1
    want = _oracle64(a, a) * 4.0
    d = abs(c2().to_scipy() - want)
    assert d.max() <= 1e-5 * max(1.0, abs(want).max())


# ----------------------------------------------------------------- kernels

KERNEL_INPUTS = {"headline256": lambda: bench.build_matrix(m=256),
                 "ill_conditioned": ill_conditioned}


@pytest.fixture(scope="module")
def slab_inputs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = slab_operands(KERNEL_INPUTS[name]())
        return cache[name]
    return get


def _spec(shape):
    """Block of 128 slab columns of an (F, S[, lanes]) or (width, S)
    operand, as the JAX launchers cut them."""
    block = (shape[0], 128) + tuple(shape[2:])
    return pl.BlockSpec(block, lambda i: (0, i) + (0,) * (len(block) - 2),
                        memory_space=pltpu.VMEM)


def _pallas(kernel, ins, outs, **kw):
    """One of the JAX package's slab kernels over all slabs, in interpret
    mode. ins: (ka, S[, lanes]) / (width, S) arrays; outs: (rows, dtype)
    per (rows, S) output, rows None for the (S, 1) nnz."""
    S = ins[-1].shape[1]
    nnz_spec = pl.BlockSpec((128, 1), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)
    res = pl.pallas_call(
        functools.partial(kernel, static_strides=False, **kw),
        grid=(S // 128,), in_specs=[_spec(x.shape) for x in ins],
        out_specs=tuple(nnz_spec if r is None else _spec((r, S))
                        for r, _ in outs),
        out_shape=tuple(jax.ShapeDtypeStruct((S, 1) if r is None
                                             else (r, S), dt)
                        for r, dt in outs),
        interpret=True)(*(jnp.asarray(x) for x in ins))
    return [np.asarray(r) for r in res]


def _lr_kernel_kw(kw):
    return dict(ka=kw["ka"], run=kw["run"], width=kw["width"], n=kw["n"],
                start_kk=kw["start_kk"])


@pytest.mark.parametrize("name", sorted(KERNEL_INPUTS))
def test_k8_plain_matches_jax_kernel(slab_inputs, name):
    """Sorted keys identical; values compared through their run sums
    (the network is not stable). The JAX kernel takes the fragment gather
    table[mt], built with numpy; the port's K8 reads the table itself."""
    _, (table, mt, avT, lrT), kw = slab_inputs(name)
    w = kw["width"]
    jk, jv = _pallas(jslab._expand_sort_kernel_lr,
                     [slab_gather_np(table, mt), host(avT), host(lrT)],
                     [(w, jnp.int32), (w, jnp.float32)], **_lr_kernel_kw(kw))
    key, val = SK.expand_sort_lr_plain(table, mt, avT, lrT, **kw)
    assert_same(key, jk.T, "sorted keys")
    jkt, jvt = torch.from_numpy(jk.T.copy()), torch.from_numpy(jv.T.copy())
    assert_kernel_outputs_match(
        BK.compress_plain(key, val, width=w, out_w=w),
        BK.compress_plain(jkt, jvt, width=w, out_w=w))


@pytest.mark.parametrize("name", sorted(KERNEL_INPUTS))
def test_k8_k3_plain_match_jax_launcher(slab_inputs, name):
    """K8 then K3 against the JAX package's own launcher of the pair (on
    table[mt], built with numpy)."""
    _, (table, mt, avT, lrT), kw = slab_inputs(name)
    w = kw["width"]
    jk, jv, jn = jslab._slab_sort_compress(
        jnp.asarray(slab_gather_np(table, mt)), jnp.asarray(host(avT)),
        jnp.asarray(host(lrT)), width=w, run=kw["run"], ka=kw["ka"],
        n=kw["n"], start_kk=kw["start_kk"], interpret=True)
    # the wrappers take the plain versions for CPU tensors, uncounted
    before = (BK.launch_counts(), SK.launch_counts())
    got = BK.compress(*SK.expand_sort_lr(table, mt, avT, lrT, **kw),
                      width=w, out_w=w)
    assert (BK.launch_counts(), SK.launch_counts()) == before
    assert_kernel_outputs_match(got, tuple(np.asarray(x)
                                           for x in (jk, jv, jn)))


@pytest.mark.parametrize("name", sorted(KERNEL_INPUTS))
def test_k9_k10_plain_match_jax_kernels(slab_inputs, name):
    """K9: sorted keys identical, exact products (JAX's Dekker hi + lo
    equals the float64 product); K10 on JAX's K9 output against JAX's
    K10, and K9 + K10 of the port against both. The JAX side takes
    table[mt], built with numpy."""
    _, (table, mt, avT, lrT), kw = slab_inputs(name)
    w = kw["width"]
    jk, jhi, jlo = _pallas(jslab._expand_sort_kernel_lr_dd,
                           [slab_gather_np(table, mt), host(avT),
                            host(lrT)],
                           [(w, jnp.int32), (w, jnp.float32),
                            (w, jnp.float32)], **_lr_kernel_kw(kw))
    key, val = SK.expand_sort_lr_dd(table, mt, avT, lrT, **kw)
    assert val.dtype == torch.float64
    assert_same(key, jk.T, "sorted keys")
    j64 = jhi.astype(np.float64) + jlo
    kc, hc, lc, nc = _pallas(jslab._compress_kernel_t_dd, [jk, jhi, jlo],
                             [(w, jnp.int32), (w, jnp.float32),
                              (w, jnp.float32), (None, jnp.int32)], width=w)
    want = (kc.T, hc.T, lc.T, nc)
    same_in = SK.compress_dd(torch.from_numpy(jk.T.copy()),
                             torch.from_numpy(j64.T.copy()), width=w)
    assert_dd_outputs_match(same_in, want)
    assert_dd_outputs_match(SK.compress_dd(key, val, width=w), want)


def test_slab_kernel_wrappers_validate_operands(slab_inputs):
    _, (table, mt, avT, lrT), kw = slab_inputs("ill_conditioned")
    with pytest.raises(TypeError):
        SK.expand_sort_lr(table, mt, avT, lrT.float(), **kw)
    with pytest.raises(ValueError, match="power of two"):
        SK.expand_sort_lr(table, mt, avT, lrT, **dict(kw, width=2048))
    with pytest.raises(ValueError, match="ka\\*run"):
        SK.expand_sort_lr_dd(table, mt, avT, lrT, **dict(kw, width=256))
    with pytest.raises(TypeError):
        SK.compress_dd(torch.zeros((2, 512), dtype=torch.int32),
                       torch.zeros((2, 512)), width=512)
    meta = torch.empty((2, 512), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        SK.compress_dd(meta, torch.empty((2, 512), dtype=torch.float64,
                                         device="meta"), width=512)


@pytest.mark.parametrize("fn", [SK.expand_sort_lr, SK.expand_sort_lr_dd])
@pytest.mark.parametrize("bad", ["table_dtype", "table_1d", "lanes_short",
                                 "lanes_not_mult4", "mt_dtype", "mt_shape",
                                 "mt_transposed"])
def test_slab_kernel_wrappers_check_table_and_mt(slab_inputs, fn, bad):
    """K8's and K9's table and fragment-index operands: table a 2-d int32
    (F, lanes) with lanes >= 4 * run and a multiple of 4; mt int32 (ka,
    S) like avT and lrT. mt's values are not checked (a device sync)."""
    _, (table, mt, avT, lrT), kw = slab_inputs("ill_conditioned")
    run = kw["run"]
    table, mt, err = {
        "table_dtype": (table.float(), mt, TypeError),
        "table_1d": (table.reshape(-1), mt, TypeError),
        "lanes_short": (table[:, :4 * run - 4].contiguous(), mt, ValueError),
        "lanes_not_mult4": (torch.nn.functional.pad(table, (0, 2)), mt,
                            ValueError),
        "mt_dtype": (table, mt.long(), TypeError),
        "mt_shape": (table, mt[:-1].contiguous(), ValueError),
        "mt_transposed": (table, mt.T.contiguous(), ValueError),
    }[bad]
    with pytest.raises(err):
        fn(table, mt, avT, lrT, **kw)


# ----------------------------------------------------------------- results

@pytest.mark.parametrize("name", sorted(PAIRS))
def test_slab_route_matches_jax(jax_slab, name):
    a, b = PAIRS[name]
    T = tslab.spgemm_csr_slab(*_ports(a, b))
    assert isinstance(T, SlabCSR)
    _assert_slabcsr_matches(T, jax_slab(name))
    want = _oracle64(a, b)
    d = abs(T.to_scipy() - want)
    assert (d.max() if d.nnz else 0.0) <= 1e-5 * max(1.0, abs(want).max())
    assert float(T.checksum()) == pytest.approx(want.sum(), rel=1e-5,
                                                abs=1e-5)


@pytest.mark.parametrize("dd", [False, True])
def test_jax_results_load_through_from_numpy(jax_slab, dd):
    """A JAX SlabCSR (and its flattened CSR) becomes a port object through
    from_numpy, with the same scipy matrix and checksum."""
    J = jax_slab("random200", dd=dd)
    T = SlabCSR.from_numpy(
        J.keys, J.values, J.nnz_slab, J.slab_first_row, J.nnz, J.shape,
        values_lo=None if J.values_lo is None else J.values_lo, device="cpu")
    assert (T.values_lo is None) == (not dd)
    assert abs(T.to_scipy() - J.to_scipy()).max() == 0
    assert float(T.checksum()) == pytest.approx(float(J.checksum()),
                                                rel=1e-6)
    Jf = jslab.slab_to_csr(J)
    Tf = TCSR.from_numpy(Jf.row_ptr, Jf.col_ind, Jf.values, Jf.nnz,
                         Jf.shape, values_lo=Jf.values_lo, device="cpu")
    assert abs(Tf.to_scipy() - Jf.to_scipy()).max() == 0
    assert_same(Tf.values_f64(), Jf.values_f64())


@pytest.mark.parametrize("engine", ["gather", "scatter"])
@pytest.mark.parametrize("name", ["random200", "empty_rows"])
def test_slab_to_csr_matches_jax(jax_slab, name, engine):
    a, b = PAIRS[name]
    T = tslab.slab_to_csr(tslab.spgemm_csr_slab(*_ports(a, b)),
                          engine=engine)
    J = jslab.slab_to_csr(jax_slab(name), engine=engine)
    for f in ("row_ptr", "col_ind", "nnz"):
        assert_same(getattr(T, f), getattr(J, f), f)
    assert_values_close(T.values, J.values, "values")
    want = _oracle64(a, b)
    want.sort_indices()
    got = T.to_scipy()
    assert_same(got.indptr, want.indptr)
    assert_same(got.indices, want.indices)


def test_spgemm_csr_slab_engine_matches_jax():
    """spgemm_csr(engine="slab") flattens the slab result at the plan's
    out_cap, as in the JAX package."""
    a, b = PAIRS["multirow"]
    T = tesc.spgemm_csr(*_ports(a, b), engine="slab")
    J = jesc.spgemm_csr(*_jaxes(a, b), engine="slab")
    for f in ("row_ptr", "col_ind", "nnz"):
        assert_same(getattr(T, f), getattr(J, f), f)
    assert_values_close(T.values, J.values, "values")


# ------------------------------------------------------------- compensated

DD_SEEDS = [(96, 11), (64, 3)]


@pytest.mark.parametrize("m,seed", DD_SEEDS)
def test_compensated_slab_matches_jax_and_oracle(m, seed):
    a32 = _ill_conditioned(m=m, seed=seed)
    assert (a32 != ill_conditioned(m=m, seed=seed)).nnz == 0
    want = _oracle64(a32, a32)
    TA, _ = _ports(a32, a32)
    T = tesc.spgemm_csr_compensated(TA, TA)
    assert isinstance(T, SlabCSR) and T.values_lo is not None
    _assert_dd_oracle(T, want)
    JA = JCSR.from_scipy(a32)
    _assert_slabcsr_matches(T, jslab.plan_slab_csr(JA, JA, dd=True)())
    # float32 sums are measurably worse on this input
    d32 = abs(tslab.spgemm_csr_slab(TA, TA).to_scipy() - want)
    assert d32.max() / max(1.0, abs(want).max()) > 1e-8


@pytest.mark.parametrize("engine", ["gather", "scatter"])
def test_compensated_slab_to_csr_keeps_lo(engine):
    a32 = _ill_conditioned(m=64, seed=3)
    want = _oracle64(a32, a32)
    TA, _ = _ports(a32, a32)
    flat = tslab.slab_to_csr(tslab.plan_slab_csr(TA, TA, dd=True)(),
                             engine=engine)
    assert flat.values_lo is not None
    _assert_dd_oracle(flat, want)
    assert abs(float(flat.checksum()) - want.sum()) \
        <= 1e-7 * max(1.0, abs(want).sum())


# ----------------------------------------------------------------- hybrid

@pytest.fixture(scope="module")
def skew():
    """_skew_matrix(m=2048): the JAX package routes it to the hybrid."""
    a = _skew_matrix().astype(np.float32)
    JA = JCSR.from_scipy(a)
    route, call = jesc.plan_csr_auto(JA, JA)
    assert route == "hybrid"
    return a, call()


def test_hybrid_matches_jax(skew):
    a, J = skew
    TA, _ = _ports(a, a)
    call = tslab.plan_slab_hybrid(TA, TA)
    assert call.n_heavy == jslab.plan_slab_hybrid(
        *_jaxes(a, a)).n_heavy > 0
    T = call()
    _assert_slabcsr_matches(T.light, J.light)
    for f in ("row_ptr", "col_ind", "nnz"):
        assert_same(getattr(T.heavy, f), getattr(J.heavy, f), f)
    assert_values_close(T.heavy.values, J.heavy.values, "heavy values")
    assert int(T.nnz) == int(J.nnz)


def test_csr_auto_hybrid_matches_jax_and_oracle(skew):
    a, J = skew
    TA, _ = _ports(a, a)
    route, call = tesc.plan_csr_auto(TA, TA)
    assert route == "hybrid"
    T = tesc.spgemm_csr_auto(TA, TA)
    want = _oracle64(a, a)
    for C in (T, call()):
        d = abs(C.to_scipy() - want)
        assert d.max() <= 1e-4 * max(1.0, abs(want).max())
        assert int(C.nnz) == want.nnz == int(J.nnz)
    assert float(T.checksum()) == pytest.approx(float(J.checksum()),
                                                rel=1e-5)


def test_hot_paths_never_flatten_slabcsr(monkeypatch):
    """The auto route and the harness's timed rows keep the native
    SlabCSR / HybridCSR: slab_to_csr (a priced conversion) never runs
    there (the port's test_route_dispatch.py:84)."""
    from ia_spgemm_tpu_torch.bench import harness

    def _boom(*a, **k):
        raise AssertionError("slab_to_csr called on a hot path")

    monkeypatch.setattr(tslab, "slab_to_csr", _boom)
    a = _skew_matrix(m=512, heavy_every=100, heavy_len=300)
    A, _ = _ports(a, a)
    route, call = tesc.plan_csr_auto(A, A)
    assert call().to_scipy().shape == (512, 512)
    rep = harness.run_benchmark(A, A, ("baseline", "csr", "esc"), iters=1)
    assert all(r.ok and not r.error for r in rep.results), rep.results


def test_slab_modules_import_with_jax_blocked():
    code = r"""
import sys
sys.modules["jax"] = None
import numpy as np
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.ops import slab, slab_kernels
from tests.torch_parity import ill_conditioned
a = ill_conditioned(m=48, seed=2)
A = CSR.from_scipy(a, device="cpu")
C = slab.spgemm_csr_slab(A, A)
want = a.astype(np.float64) @ a.astype(np.float64)
assert abs(C.to_scipy() - want).max() < 1e-5 * abs(want).max()
assert not [m for m in sys.modules if m.split(".")[0] == "ia_spgemm_tpu"]
print("OK", int(C.nnz))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")
