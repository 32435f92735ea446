"""PyTorch port, the slab + global hybrid on a B with one long row: the
light part's fragment table built from B's CSR arrays (no ELL of B),
equal to the ELL-built table; the production entry routing such a
product to the hybrid and matching a float64 scipy product; and the
hybrid's spans and counters (``ia_spgemm_tpu_torch/tracing.py``).

    python -m pytest tests/test_torch_hybrid.py -q
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ia_spgemm_tpu_torch import tracing
from ia_spgemm_tpu_torch.formats import convert
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.ops import bitonic, esc
from ia_spgemm_tpu_torch.ops import slab as tslab


def _long_row_matrix(m, long_len, callers=20, seed=0):
    """Rows of 0-3 entries at random columns, row 0 with long_len
    distinct entries, and `callers` rows that meet row 0 (heavy rows of
    A @ A); float32 normal values."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 4, m)
    lens[0] = 0
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.size)
    long_cols = rng.choice(m, long_len, replace=False)
    who = rng.choice(np.arange(1, m), callers, replace=False)
    rows = np.concatenate([rows, np.zeros(long_len, np.int64), who])
    cols = np.concatenate([cols, long_cols, np.zeros(callers, np.int64)])
    a = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(m, m))
    a.sum_duplicates()
    a.data = rng.standard_normal(a.nnz)
    return a.astype(np.float32)


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    tslab.clear_plan_cache()
    yield
    tracing.reset()


def test_a_b_with_one_long_row_routes_to_the_hybrid_without_an_ell(
        monkeypatch):
    """m x kb = 65,536 x 4,097 > 2^28: an ELL of B would hold over 2^28
    slots. The light part's planner builds B's fragment table from its
    CSR arrays instead, so the router takes the hybrid with no ELL of B
    built, and C matches scipy's float64 product."""
    m = 65536
    a = _long_row_matrix(m, 4097)
    assert m * int(np.diff(a.indptr).max()) > 1 << 28

    def no_ell(*args, **kw):
        raise AssertionError("an ELL of an operand was built")

    monkeypatch.setattr(convert, "csr_to_ell", no_ell)
    A = CSR.from_scipy(a, device="cpu")
    pred = esc.predict_csr_route_ms(A, A)
    assert "tiled" not in pred and pred["hybrid"] < pred["global"]
    assert isinstance(tslab.plan_slab_hybrid(A, A), tslab.HybridCall)
    route, call = esc.plan_csr_auto(A, A)
    assert route == "hybrid" and call.n_heavy >= 21
    C = call()
    a64 = a.astype(np.float64)
    want = (a64 @ a64).tocsr()
    scale = (abs(a64) @ abs(a64)).tocsr()      # no cancellation: pattern
    got = C.to_scipy().tocsr()
    got.sort_indices()
    scale.sort_indices()
    np.testing.assert_array_equal(got.indptr, scale.indptr)
    np.testing.assert_array_equal(got.indices, scale.indices)
    assert int(C.nnz) == scale.nnz
    err = abs(got - want).tocsr()
    rel = np.asarray(err[scale.nonzero()]).ravel() / scale.data
    assert rel.max() <= 1e-4


def _ell_cut_table(ell, js, within, run):
    """The table as the ELL layout cuts it (the JAX package's
    _ragged_table): B's ELL rows padded to whole runs, fragment (j, w)
    the w-th run of row j."""
    k, kb = ell.col_ind.shape
    cm = max(-(-kb // run), 1)
    bc = F.pad(ell.col_ind, (0, cm * run - kb), value=-1).reshape(k * cm,
                                                                  run)
    bv = F.pad(ell.values, (0, cm * run - kb)).reshape(k * cm, run)
    src = torch.from_numpy(js * cm + within)
    return bitonic._wide_rows(bc[src], bv.view(torch.int32)[src])


@pytest.mark.parametrize("frags", ["slab", "tiled"])
@pytest.mark.parametrize("case", ["random", "empty_rows", "long_rows"])
@pytest.mark.parametrize("run", [8, 32])
def test_the_csr_built_table_equals_the_ell_built_table(case, run, frags):
    """The fragment table from B's CSR arrays (the slab planner) and from
    B's ELL read as a CSR of row stride kb (the tiled planner) equal the
    table cut from the padded ELL rows, element for element; for the
    slab planner's fragments (each nonempty row cut into runs) and the
    tiled planner's (an empty row keeps one all-padding fragment)."""
    rng = np.random.default_rng(run)
    if case == "random":
        b = sp.random(300, 200, density=0.03, random_state=rng,
                      format="csr")
    elif case == "empty_rows":
        b = sp.random(300, 200, density=0.01, random_state=rng,
                      format="csr")
        assert (np.diff(b.indptr) == 0).any()
    else:       # rows of several fragments, a negative zero value
        b = _long_row_matrix(300, 150, seed=run).astype(np.float64)
        b.data[0] = -0.0
    B = CSR.from_scipy(b.astype(np.float32), device="cpu")
    b_len = np.diff(b.indptr).astype(np.int64)
    b_cnt = -(-b_len // run)
    if frags == "tiled":
        b_cnt = np.maximum(b_cnt, 1)
    starts = np.concatenate([[0], np.cumsum(b_cnt)])
    js = np.repeat(np.arange(len(b_cnt)), b_cnt)
    within = np.arange(int(starts[-1])) - np.repeat(starts[:-1], b_cnt)
    kb = convert.plan_ell_width(B)
    ell = convert.csr_to_ell(B, width=kb, check_guard=False)
    want = _ell_cut_table(ell, js, within, run)
    js_t, within_t = torch.from_numpy(js), torch.from_numpy(within)
    from_csr = bitonic._ragged_table(B.row_ptr, B.col_ind, B.values, js_t,
                                     within_t, run=run)
    from_ell = bitonic._ragged_table(
        torch.arange(0, (ell.nrows + 1) * kb, kb), ell.col_ind.reshape(-1),
        ell.values.reshape(-1), js_t, within_t, run=run)
    for got in (from_csr, from_ell):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


def test_a_hybrid_call_records_its_spans_and_the_plans_counters():
    """One call under tracing.enable(): the hybrid's spans, nested as the
    engines run, once each; the counters are the plan's constants."""
    a = _long_row_matrix(2048, 300, seed=3)
    A = CSR.from_scipy(a, device="cpu")
    call = tslab.plan_slab_hybrid(A, A)
    assert call is not None
    with tracing.enable():
        C = call()
    snap = tracing.snapshot()
    spans = snap["spans"]
    names = ("hybrid.call", "hybrid.light", "slab.sort", "slab.compress",
             "hybrid.heavy", "esc.expand", "esc.sort", "esc.compress")
    assert set(spans) == set(names)
    for name in names:
        assert spans[name]["calls"] == 1 and spans[name]["timed"] == 1
    # each parent holds its children: self time is what they leave
    for parent, kids in (("hybrid.light", ("slab.sort", "slab.compress")),
                         ("hybrid.heavy", ("esc.expand", "esc.sort",
                                           "esc.compress")),
                         ("hybrid.call", ("hybrid.light",
                                          "hybrid.heavy"))):
        inside = sum(spans[k]["host_ns"] for k in kids)
        assert spans[parent]["self_ns"] == spans[parent]["host_ns"] - inside
    p = call.light_call.plan
    assert snap["counters"]["hybrid.calls"] == 1
    assert snap["counters"]["hybrid.light_products"] == p.true_flops > 0
    assert snap["counters"]["hybrid.heavy_products"] == \
        call.heavy_plan.flops > 0
    assert snap["counters"]["slab.padded_slots"] == p.padded_slots
    want = a.astype(np.float64) @ a.astype(np.float64)
    assert abs(C.to_scipy() - want).max() <= 1e-4 * abs(want).max()
    # off, the same call records no span and counts again
    call()
    after = tracing.snapshot()
    assert after["spans"]["hybrid.call"]["calls"] == 1
    assert after["counters"]["hybrid.calls"] == 2


def test_the_slab_and_global_engines_alone_open_no_span():
    """Only the hybrid opens the engines' spans: the slab and global
    routes run alone record none under tracing.enable(), and the slab
    call still counts its padded slots."""
    a = _long_row_matrix(512, 40, seed=4)
    A = CSR.from_scipy(a, device="cpu")
    slab_call = tslab.plan_slab_csr(A, A)
    assert slab_call is not None
    with tracing.enable():
        slab_call()
        esc.spgemm_csr(A, A, engine="global")
    snap = tracing.snapshot()
    assert not snap["spans"]
    assert snap["counters"]["slab.padded_slots"] == \
        slab_call.plan.padded_slots
