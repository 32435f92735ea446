"""PyTorch port, the ring distributed route (parallel/ring.py,
parallel/rdma_ring.py, ops/bitonic.doubled_table_gather) against the JAX
package on its 8 virtual CPU devices (Pallas in interpret mode, as its
own tests run it), on an 8-shard CPU mesh of the port.

Tolerances: partitions, plans, row maps and the gathered result's
columns and nnz_row identical; float32 values within 1e-6 * max(1,
max|C|) (duplicates summed in another order: the JAX K4 network against
the plain version's stable sort); the doubled table gather and K13's
plain version exact."""

import dataclasses

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ia_spgemm_tpu.ops import bitonic as jbt
from ia_spgemm_tpu.parallel import ring as jring
from ia_spgemm_tpu.parallel.mesh import make_mesh as jmake_mesh
from ia_spgemm_tpu_torch.ops import bitonic as tbt
from ia_spgemm_tpu_torch.parallel import distributed as tdist
from ia_spgemm_tpu_torch.parallel import rdma_ring
from ia_spgemm_tpu_torch.parallel import ring as tring
from ia_spgemm_tpu_torch.parallel.mesh import make_mesh
from tests import fixtures
from tests.torch_parity import assert_same, assert_values_close, jell, tell

D = 8
RING_RTOL = 1e-6


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < D:
        pytest.skip("needs 8 virtual devices")
    return jmake_mesh(D)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(D, devices=["cpu"] * D)


def _subrun_matrix():
    """B rows just past a power of two (kb ~ 40): the split plan picks
    chunks > 1 (tests/test_ring.py:118)."""
    rng = np.random.default_rng(69)
    m = 48
    rows, cols, vals = [], [], []
    for r in range(m):
        ln = int(rng.integers(33, 41))
        for c in rng.choice(m, size=ln, replace=False):
            rows.append(r)
            cols.append(int(c))
            vals.append(float(rng.standard_normal()))
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()


def _flops_block():
    return sp.vstack([fixtures.random_csr(8, 72, density=0.9, seed=66),
                      fixtures.random_csr(64, 72, density=0.02, seed=67)]
                     ).tocsr()[:72, :72].tocsr()


# (A, B, A's balance, B's balance): every case of tests/test_ring.py
# :44-135, plus a permuted B whose row count leaves padded slots
RING_CASES = {
    "square": (lambda: fixtures.random_csr(64, 64, density=0.08, seed=60),
               lambda: fixtures.random_csr(64, 64, density=0.1, seed=61),
               "rows", "rows"),
    "uneven_61x53x47": (
        lambda: fixtures.random_csr(61, 53, density=0.12, seed=62),
        lambda: fixtures.random_csr(53, 47, density=0.15, seed=63),
        "rows", "rows"),
    "a_squared": (lambda: fixtures.random_csr(96, 96, density=0.06,
                                              seed=64), None, "rows",
                  "rows"),
    "flops_balanced_a": (_flops_block, None, "flops", "rows"),
    "permuted_b": (lambda: fixtures.random_csr(64, 64, density=0.1,
                                               seed=68), None, "rows",
                   "flops"),
    "permuted_b_uneven": (lambda: fixtures.random_csr(61, 61, density=0.1,
                                                      seed=68), None,
                          "rows", "flops"),
    "subrun_split": (_subrun_matrix, None, "rows", "rows"),
}


def _case(name):
    fa, fb, ba, bb = RING_CASES[name]
    a = fa().astype(np.float32)
    b = a if fb is None else fb().astype(np.float32)
    return a, b, ba, bb


@pytest.fixture(scope="module")
def ring_results(jmesh, mesh):
    """JAX and port ring results of every case, computed once."""
    out = {}
    for name in RING_CASES:
        a, b, ba, bb = _case(name)
        JA, JB, TA, TB = jell(a), jell(b), tell(a), tell(b)
        jplan = jring.plan_ring(JA, JB, D)
        tplan = tring.plan_ring(TA, TB, D)
        Jc = jring.ring_spgemm(
            jring.partition_rows_ell(JA, D, mesh=jmesh, balance=ba),
            jring.partition_rows_ell(JB, D, mesh=jmesh, balance=bb),
            jmesh, jplan)
        Tc = tring.ring_spgemm(
            tring.partition_rows_ell(TA, D, mesh=mesh, balance=ba),
            tring.partition_rows_ell(TB, D, mesh=mesh, balance=bb),
            mesh, tplan)
        out[name] = (a, b, jplan, tplan, Jc, Tc)
    return out


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_spgemm_matches_jax(ring_results, name):
    a, b, jplan, tplan, Jc, Tc = ring_results[name]
    assert (tplan.width, tplan.run, tplan.chunks, tplan.viable) == \
        (jplan.width, jplan.run, jplan.chunks, jplan.viable)
    if name == "subrun_split":
        assert tplan.chunks > 1
    J, T = jring.gather_result_ell(Jc), tring.gather_result_ell(Tc)
    assert_same(T.nnz_row, np.asarray(J.nnz_row), "nnz_row")
    assert_same(T.col_ind, np.asarray(J.col_ind), "col_ind")
    assert T.values.dtype == torch.float32
    assert_values_close(T.values, np.asarray(J.values), "values",
                        RING_RTOL)
    want = (a.astype(np.float64) @ b.astype(np.float64)).tocsr()
    got = T.to_scipy()
    assert got.nnz == want.nnz
    assert abs(got - want).max() < 1e-4 * max(1.0, abs(want).max())


def test_ring_flops_balance_spreads_heavy_rows(ring_results):
    *_, Tc = ring_results["flops_balanced_a"]
    rmap = tdist.stacked(Tc.row_map)
    assert len({d for d in range(D) for r in rmap[d] if 0 <= r < 8}) == D


@pytest.mark.parametrize("name", sorted(RING_CASES))
@pytest.mark.parametrize("balance", ["rows", "flops"])
def test_partition_rows_ell_matches_jax(name, balance):
    a, b, _, _ = _case(name)
    JA, JB, TA, TB = jell(a), jell(b), tell(a), tell(b)
    J = jring.partition_rows_ell(JA, D, balance=balance, B=JB)
    T = tring.partition_rows_ell(TA, D, balance=balance, B=TB)
    for f in ("col_ind", "values", "nnz_row", "row_map"):
        assert_same(tdist.stacked(getattr(T, f)), np.asarray(getattr(J, f)),
                    f)
    assert T.contiguous == J.contiguous
    assert (T.num_shards, T.rows_per_shard, T.width) == (
        J.num_shards, J.rows_per_shard, J.width)


@pytest.mark.parametrize("name", sorted(RING_CASES))
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_plan_ring_matches_jax(name, shards):
    a, b, _, _ = _case(name)
    for split in (True, False):
        j = jring.plan_ring(jell(a), jell(b), shards, allow_split=split)
        t = tring.plan_ring(tell(a), tell(b), shards, allow_split=split)
        assert (t.width, t.run, t.tile_rows, t.viable, t.reason,
                t.chunks) == (j.width, j.run, j.tile_rows, j.viable,
                              j.reason, j.chunks)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("run", [4, 16])
def test_doubled_table_gather_matches_jax(dtype, run):
    rng = np.random.default_rng(run)
    kt = 37
    bc = rng.integers(-1, 500, (kt, run)).astype(np.int32)
    bv = rng.standard_normal((kt, run)).astype(dtype)
    rows = rng.integers(0, 2 * kt, 300)
    jc, jv = jbt.doubled_table_gather(bc, bv, rows, run=run,
                                      out_shape=(20, 15, run))
    tc, tv = tbt.doubled_table_gather(torch.from_numpy(bc),
                                      torch.from_numpy(bv),
                                      torch.from_numpy(rows), run=run,
                                      out_shape=(20, 15, run))
    assert tv.dtype == torch.from_numpy(bv).dtype
    assert_same(tc, np.asarray(jc))
    assert_same(tv, np.asarray(jv))


@pytest.mark.parametrize("D_", [1, 2, 8])
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64])
def test_k13_plain_version_is_a_roll(D_, dtype):
    rng = np.random.default_rng(D_)
    x = (rng.standard_normal((D_, 13, 29)) * 100).astype(dtype)
    blocks = [torch.from_numpy(x[d].copy()) for d in range(D_)]
    v = [torch.from_numpy(x[d][::-1].copy()) for d in range(D_)]
    n0 = rdma_ring.launch_counts()["K13"]
    for fn in (rdma_ring.ring_hop_plain, rdma_ring.ring_hop_rdma):
        out, out_v = fn(blocks, v)
        assert_same(np.stack([t.numpy() for t in out]), np.roll(x, -1, 0))
        assert_same(np.stack([t.numpy() for t in out_v]),
                    np.roll(x[:, ::-1], -1, 0))
        # fresh tensors: the hop never hands a shard another's storage
        assert all(o.data_ptr() != b.data_ptr()
                   for o in out for b in blocks)
    # the CPU wrapper runs the plain version and counts nothing
    assert rdma_ring.launch_counts()["K13"] == n0


def test_k13_wrapper_checks_its_blocks():
    a = [torch.zeros(3), torch.zeros(3)]
    with pytest.raises(ValueError, match="arrays of 1 and 2"):
        rdma_ring.ring_hop_rdma(a, [torch.zeros(3)])
    with pytest.raises(ValueError, match="contiguous"):
        rdma_ring.ring_hop_rdma([torch.zeros(4, 4).T, torch.zeros(4, 4)])
    with pytest.raises(ValueError, match="3 devices for 2"):
        rdma_ring.ring_hop_rdma(a, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="no blocks"):
        rdma_ring.ring_hop_rdma()


def test_rdma_needs_cards_in_one_process(mesh):
    """K13 runs only on meshes of cards (in one process or across
    processes): never on the CPU, and use_rdma=True raises there rather
    than taking the plain hop."""
    assert rdma_ring.rdma_available(mesh) is False
    assert rdma_ring.rdma_available(None) is False
    a = fixtures.random_csr(32, 32, density=0.1, seed=1).astype(np.float32)
    A = tell(a)
    S = tring.partition_rows_ell(A, D, mesh=mesh)
    with pytest.raises(ValueError, match="use_rdma=True"):
        tring.ring_spgemm(S, S, mesh, tring.plan_ring(A, A, D),
                          use_rdma=True)


def test_ring_on_one_shard():
    """D = 1: no hop; the single shard multiplies by all of B."""
    a = fixtures.random_csr(40, 40, density=0.1, seed=7).astype(np.float32)
    A = tell(a)
    mesh1 = make_mesh(1, devices=["cpu"])
    S = tring.partition_rows_ell(A, 1, mesh=mesh1)
    C = tring.gather_result_ell(tring.ring_spgemm(
        S, S, mesh1, tring.plan_ring(A, A, 1)))
    single = tbt.spgemm_bitonic(A, A)
    assert_same(C.nnz_row, single.nnz_row)
    assert abs(C.to_scipy() - (a @ a)).max() < 1e-5


def test_ring_without_mesh_matches_mesh(mesh):
    a = fixtures.random_csr(64, 64, density=0.1, seed=65).astype(np.float32)
    A = tell(a)
    plan = tring.plan_ring(A, A, D)
    C0 = tring.gather_result_ell(tring.ring_spgemm(
        tring.partition_rows_ell(A, D), tring.partition_rows_ell(A, D),
        None, plan))
    C1 = tring.gather_result_ell(tring.ring_spgemm(
        tring.partition_rows_ell(A, D, mesh=mesh),
        tring.partition_rows_ell(A, D, mesh=mesh), mesh, plan))
    for f in ("col_ind", "values", "nnz_row"):
        assert_same(getattr(C0, f), getattr(C1, f), f)


def test_ring_rejects_nonviable_plan(mesh):
    a = fixtures.banded_csr(32, bandwidth=1, seed=77).astype(np.float32)
    A = tell(a)
    S = tring.partition_rows_ell(A, D, mesh=mesh)
    bad = dataclasses.replace(tring.plan_ring(A, A, D), viable=False)
    with pytest.raises(ValueError, match="not viable"):
        tring.ring_spgemm(S, S, mesh, bad)



ALT_CASES = ("square", "permuted_b", "permuted_b_uneven", "subrun_split")


@pytest.fixture(scope="module")
def jmesh4():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    return jmake_mesh(4)


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("name", ALT_CASES)
def test_ring_alternating_receivers_matches_jax(monkeypatch, jmesh, jmesh4,
                                                shards, name):
    """The ring's hops write into two sets of receivers made once per
    call, step s into set s % 2 (the set step s - 1 read), on 4- and
    8-shard CPU meshes; the result is the JAX ring's (a permuted B and
    chunks > 1 among the cases)."""
    a, b, ba, bb = _case(name)
    tm = make_mesh(shards, devices=["cpu"] * shards)
    jm = jmesh if shards == 8 else jmesh4
    hops = []
    real = rdma_ring.ring_hop_plain

    def spy(*arrays, out=None, **kw):
        hops.append((out, [[t.data_ptr() for t in arr] for arr in arrays]))
        return real(*arrays, out=out, **kw)

    monkeypatch.setattr(tring, "ring_hop_plain", spy)
    JA, JB, TA, TB = jell(a), jell(b), tell(a), tell(b)
    jplan, tplan = jring.plan_ring(JA, JB, shards), tring.plan_ring(TA, TB,
                                                                      shards)
    if name == "subrun_split":
        assert tplan.chunks > 1
    Jc = jring.ring_spgemm(
        jring.partition_rows_ell(JA, shards, mesh=jm, balance=ba),
        jring.partition_rows_ell(JB, shards, mesh=jm, balance=bb), jm, jplan)
    Tc = tring.ring_spgemm(
        tring.partition_rows_ell(TA, shards, mesh=tm, balance=ba),
        tring.partition_rows_ell(TB, shards, mesh=tm, balance=bb), tm, tplan)
    # D - 1 hops, alternating between two receiver sets; from the second
    # hop on, the blocks hopped are the previous hop's receivers
    assert len(hops) == shards - 1
    sets = [out for out, _ in hops]
    assert all(isinstance(o, rdma_ring.Receivers) for o in sets)
    assert sets[0] is not sets[1]
    assert all(sets[s] is sets[s % 2] for s in range(len(sets)))
    for s in range(1, len(hops)):
        assert hops[s][1] == [[t.data_ptr() for t in arr]
                              for arr in sets[s - 1]]
    J, T = jring.gather_result_ell(Jc), tring.gather_result_ell(Tc)
    assert_same(T.nnz_row, np.asarray(J.nnz_row), "nnz_row")
    assert_same(T.col_ind, np.asarray(J.col_ind), "col_ind")
    assert_values_close(T.values, np.asarray(J.values), "values", RING_RTOL)


def _blocks(D, dtype=torch.float32, rows=13, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal((rows, 29)) * 100)
                             .astype(np.float32)).to(dtype)
            for _ in range(D)]


@pytest.mark.parametrize("fn", ["ring_hop_rdma", "ring_hop_plain"])
def test_k13_public_call_returns_fresh_tensors(fn):
    """Without out=, every call returns new tensors: never a source's
    storage, nor an earlier call's."""
    hop = getattr(rdma_ring, fn)
    bc, bv = _blocks(4, torch.int32), _blocks(4, seed=1)
    first = hop(bc, bv)
    second = hop(bc, bv)
    src = {t.data_ptr() for arr in (bc, bv) for t in arr}
    seen = [{t.data_ptr() for arr in res for t in arr}
            for res in (first, second)]
    assert not (seen[0] & src) and not (seen[1] & src)
    assert not (seen[0] & seen[1])
    for res in (first, second):
        for arr, got in zip((bc, bv), res):
            for d in range(4):
                assert torch.equal(got[d], arr[(d + 1) % 4])


def test_k13_receivers_reused_in_place():
    """out= writes into the given receivers (one buffer per array and
    device) and returns their lists; receivers of another layout, or a
    plain list, are refused."""
    bc, bv = _blocks(4, torch.int32), _blocks(4, seed=1)
    recv = rdma_ring.alloc_receivers(bc, bv)
    assert len({t.untyped_storage().data_ptr() for t in recv[0]}) == 1
    assert len({t.untyped_storage().data_ptr() for t in recv[1]}) == 1
    ptrs = [[t.data_ptr() for t in arr] for arr in recv]
    for hop in (rdma_ring.ring_hop_rdma, rdma_ring.ring_hop_plain):
        got = hop(bc, bv, out=recv)
        assert [[t.data_ptr() for t in arr] for arr in got] == ptrs
        assert all(g is r for g, r in zip(got, recv))
        for arr, res in zip((bc, bv), got):
            for d in range(4):
                assert torch.equal(res[d], arr[(d + 1) % 4])
        # the receivers as the next hop's blocks: their layout is known
        assert rdma_ring._layout(tuple(got), None) is recv.own
    other = rdma_ring.alloc_receivers(_blocks(4, rows=7), _blocks(4, rows=7))
    with pytest.raises(ValueError, match="alloc_receivers"):
        rdma_ring.ring_hop_rdma(bc, bv, out=other)
    with pytest.raises(ValueError, match="alloc_receivers"):
        rdma_ring.ring_hop_plain(bc, bv, out=[list(bc), list(bv)])


def test_k13_layout_checked_once_and_cached():
    bc = _blocks(4)
    first = rdma_ring._layout((bc,), None)
    assert rdma_ring._layout((list(bc),), None) is first
    # another shape is another layout; a non-contiguous block is refused
    assert rdma_ring._layout((_blocks(4, rows=5),), None) is not first
    with pytest.raises(ValueError, match="contiguous"):
        rdma_ring._layout(([torch.zeros(29, 13).T] * 4,), None)
    key, targets, plan, recv, same = first
    assert same and recv == [[(torch.device("cpu"), [0, 1, 2, 3],
                               torch.Size([13, 29]), torch.float32)]]
    (srcs, dsts, table, remote), = plan.values()
    assert srcs == [1, 2, 3, 0] and dsts == [0, 1, 2, 3] and remote == []
    assert table == [0, 0, 13 * 29 * 4] * 4


def test_k13_zero_byte_blocks_left_out_of_the_plan():
    blocks = [torch.zeros(0, 29), torch.zeros(3, 29), torch.zeros(0, 29)]
    _, _, plan, recv, same = rdma_ring._layout((blocks,), None)
    assert not same and len(recv[0]) == 3       # one receiver per block
    (srcs, dsts, table, _), = plan.values()
    assert srcs == [1] and dsts == [0] and table == [0, 0, 3 * 29 * 4]
    got = rdma_ring.ring_hop_rdma(blocks)
    assert [tuple(t.shape) for t in got[0]] == [(3, 29), (0, 29), (0, 29)]


@pytest.mark.parametrize("copies,sizes", [
    (1, [1]), (16, [16]), (128, [128]), (129, [128, 1]),
    (300, [128, 128, 44]), (0, [])])
def test_k13_pack_launches(copies, sizes):
    """The copy triples go out as launches of at most 128 copies (what
    the kernel's parameter struct holds), in order, as int64 tables."""
    flat = [x for i in range(copies)
            for x in (1000 + i, 2**40 + i, 16 * (i + 1))]
    got = rdma_ring.pack_launches(flat)
    assert [n for _, n in got] == sizes
    assert all(t.typecode == "q" and t.itemsize == 8 for t, _ in got)
    assert [x for t, _ in got for x in t] == flat
    assert rdma_ring.MAX_COPIES == 128
    with pytest.raises(ValueError, match="triples"):
        rdma_ring.pack_launches(flat + [1])
