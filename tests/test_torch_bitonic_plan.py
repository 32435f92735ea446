"""PyTorch port, host planning and plan-time fragment tables: the port's
planner reproduces the JAX plan exactly (the plan fixes the output
layout), and the arrays a planned call holds are identical; the port's
plan cache."""

import numpy as np
import pytest
import scipy.sparse as sp

import bench
from ia_spgemm_tpu.ops import bitonic as jbt
from ia_spgemm_tpu_torch.ops import bitonic as tbt
from tests.test_bitonic import _skewed
from tests.torch_parity import assert_same, host, jax_call_state, jell, tell


def _random_pair(m, k, n, da, db, seed):
    rng = np.random.default_rng(seed)
    a = sp.random(m, k, density=da, format="csr",
                  random_state=np.random.RandomState(seed))
    a.data[:] = rng.standard_normal(a.nnz)
    b = sp.random(k, n, density=db, format="csr",
                  random_state=np.random.RandomState(seed + 100))
    b.data[:] = rng.standard_normal(b.nnz)
    return a, b


# the inputs of tests/test_bitonic.py's oracle test, plus the skewed and
# headline-shaped matrices of the width-class tests
PAIRS = {f"random{i}": _random_pair(*p) for i, p in enumerate([
    (16, 16, 16, 0.3, 0.3, 0), (64, 64, 64, 0.05, 0.05, 1),
    (128, 96, 200, 0.08, 0.06, 2), (33, 17, 65, 0.2, 0.15, 3),
    (8, 8, 8, 1.0, 1.0, 4)])}
PAIRS["skew_b"] = (_skewed(23, 256, heavy_every=64, heavy=160, light=5),) * 2
PAIRS["skew_a"] = (_skewed(21, 200),) * 2
PAIRS["headline256"] = (bench.build_matrix(m=256),) * 2


@pytest.mark.parametrize("ka,kb", [(1, 1), (3, 7), (16, 8), (33, 40),
                                   (64, 9), (200, 200), (5, 1000)])
@pytest.mark.parametrize("m", [1, 1000, 200_000_000])
@pytest.mark.parametrize("allow_split", [True, False])
def test_plan_bitonic_dims_matches_jax(m, ka, kb, allow_split):
    assert tbt.plan_bitonic_dims(m, ka, kb, allow_split).__dict__ == \
        jbt.plan_bitonic_dims(m, ka, kb, allow_split).__dict__


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("run_override", [None, 8, 16])
def test_plan_multiclass_matches_jax(name, run_override):
    a, b = PAIRS[name]
    JA, JB = jell(a), jell(b)
    TA, TB = tell(a), tell(b)
    lens = np.asarray(JA.nnz_row)
    jplan, jW = jbt.plan_multiclass(
        lens, JB.max_nnz_per_row, a_col_h=np.asarray(JA.col_ind),
        b_len_h=np.asarray(JB.nnz_row).astype(np.int64),
        run_override=run_override)
    tplan, tW = tbt.plan_multiclass(
        host(TA.nnz_row), TB.max_nnz_per_row, a_col_h=host(TA.col_ind),
        b_len_h=host(TB.nnz_row).astype(np.int64),
        run_override=run_override)
    assert tplan.__dict__ == jplan.__dict__
    assert_same(tW, jW)
    # without the ragged probe (chunked candidates only) as well
    jp2, jW2 = jbt.plan_multiclass(lens, JB.max_nnz_per_row,
                                   run_override=run_override)
    tp2, tW2 = tbt.plan_multiclass(lens, TB.max_nnz_per_row,
                                   run_override=run_override)
    assert tp2.__dict__ == jp2.__dict__
    assert_same(tW2, jW2)
    assert tbt.multiclass_viable(lens, TB.max_nnz_per_row) == \
        jbt.multiclass_viable(lens, JB.max_nnz_per_row)


@pytest.mark.parametrize("name", ["skew_a", "skew_b", "headline256"])
@pytest.mark.parametrize("pregather,run_override",
                         [(False, None), (True, None), (True, 8)])
def test_planned_arrays_match_jax(name, pregather, run_override):
    """Fragment matrices MT (or the pregathered g), AVT, the packed B
    table, class rows and the BlockCSR map are identical (AVT's NaN pad
    rows included)."""
    a, _ = PAIRS[name]
    JA, TA = jell(a), tell(a)
    jcall = jbt.multiclass_planned(JA, JA, assemble="bcsr",
                                   pregather=pregather,
                                   run_override=run_override)
    tcall = tbt.multiclass_planned(TA, TA, assemble="bcsr",
                                   pregather=pregather,
                                   run_override=run_override)
    st = jax_call_state(jcall)
    nc = len(st["idxs"])
    assert nc == len(tcall.widths) == len(tcall.idxs)
    extra = st["extra"]
    assert len(extra) == 2 * nc + 3
    for c in range(nc):
        assert_same(tcall.idxs[c], st["idxs"][c], f"idxs[{c}]")
        assert_same(tcall.frags[c], extra[c], f"MT/g[{c}]")
        assert_same(tcall.avts[c], extra[nc + c], f"AVT[{c}]")
    assert_same(tcall.src_full, extra[2 * nc], "src_full")
    assert_same(tcall.blk_ptr, extra[2 * nc + 1], "blk_ptr")
    assert_same(tcall.table, extra[2 * nc + 2], "table")
    if pregather:
        assert tcall.pregather


def test_plan_cache_hit_eviction_and_in_place_edit():
    a = _skewed(31, 192)
    A = tell(a)
    tbt.clear_plan_cache()
    call1 = tbt.multiclass_planned(A, A, assemble="bcsr")
    assert tbt.plan_cache_stats() == {"hits": 0, "misses": 1}
    assert tbt.multiclass_planned(A, A, assemble="bcsr") is call1
    assert tbt.plan_cache_stats()["hits"] == 1
    # another assemble mode is another plan
    assert tbt.multiclass_planned(A, A, assemble="ell") is not call1
    # an in-place edit of an operand misses, and the new plan sees it
    A.values.mul_(2.0)
    call2 = tbt.multiclass_planned(A, A, assemble="bcsr")
    assert call2 is not call1
    assert tbt.plan_cache_stats()["misses"] == 3
    want = 4.0 * float((a.astype(np.float64) @ a).sum())
    assert float(call2().checksum()) == pytest.approx(want, rel=1e-4)
    # FIFO bound: older entries are evicted
    for i in range(tbt._BUILD_CACHE_MAX):
        Ai = tell(_skewed(40 + i, 64))
        assert tbt.multiclass_planned(Ai, Ai) is not None
    assert len(tbt._BUILD_CACHE) <= tbt._BUILD_CACHE_MAX
    assert tbt.multiclass_planned(A, A, assemble="bcsr") is not call2
    tbt.clear_plan_cache()
