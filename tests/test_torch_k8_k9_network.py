"""K8 and K9 on the register network (csrc/slab.cu, ``row_net_rows`` with
the ``TableIn`` source of csrc/sort_common.cuh and its slab-local rows),
modelled in numpy: which
fragment slot, table row and lanes each thread and register reads
straight from the packed B table through the fragment index mt, the key
lr * n + col and the product each slot gets (float32 rounded once for
K8, exact float64 for K9), and the selects that leave empty slots
SENTINEL / 0. The sort is tests/test_torch_k4_network.py's model, which
the .cu follows step for step; here the whole of K8 and K9 (slab source
-> network from start_kk = 2 * run) must give the plain versions' sorted
keys exactly and the same (key, value) pairs, at the slab widths 512 and
1024 and runs 8 and 32; the source alone must give
``slab_kernels._expand_lr_plain``'s products bit for bit at every run
1-32. ``bench.kernels.table_read_bytes`` (the bytes K8's and K9's bound
counts) is checked against the lanes the plain version reads.

Layout: a slab of W slots is held E = 8 per thread, thread t holding
slots t*E .. t*E + E - 1. Slot p is position p % run of fragment slot
e = p / run: table row mt[e], lane (2 * run for odd e) + p % run for the
column and run lanes further for the value bits, A value avT[e], local
row lrT[e]. A column < 0 (the fill row F_B of empty and padding slots
is all -1) and every slot past ka * run are SENTINEL / 0, by a select:
those slots carry NaN A values and junk local rows."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from ia_spgemm_tpu_torch.bench import kernels as KB
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
from ia_spgemm_tpu_torch.ops import slab_kernels as SK
from tests.test_torch_k4_network import (compress_model, elems_per_thread,
                                         run_network)
from tests.torch_parity import (F64_RTOL, GATHER_RUNS, INT32_MAX,
                                VALUE_RTOL, slab_fragments, slab_operands)

SENT = K.SENTINEL
WIDTHS = [512, 1024]            # the slab widths (ops/slab.py)
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def slot_map(width, run, ka, E=None):
    """K8's / K9's source, per (thread, register): the fragment slot e,
    the column's lane in its table row, and whether the slot can hold a
    product (e < ka). Arrays of shape (T, E)."""
    E = E or elems_per_thread(width)
    p = np.arange(width).reshape(width // E, E)
    e = p // run
    return e, (e & 1) * 2 * run + p % run, e < ka


def product(a, bits, dtype):
    """csrc/sort_common.cuh product<V>: a * the B value rounded once in
    float32 (numpy's float32 multiply is IEEE, as __fmul_rn), or exact in
    float64."""
    b = bits.view(np.float32)
    if dtype == np.float32:
        return a.astype(np.float32) * b
    return a.astype(np.float64) * b.astype(np.float64)


def slab_model(table, mt, avT, lrT, *, width, run, ka, n, dtype, E=None):
    """load_slots for TableIn, thread by thread as the kernel runs it:
    where run is a multiple of E one fragment per thread (one mt, avT and
    lrT read, E neighbouring lanes for the columns and E for the value
    bits), below that each slot its own fragment. lrT None (K2, K7a):
    the key is the column. Returns (key, val) (S, width) in the normal
    layout."""
    table, mt, avT = (x.numpy() for x in (table, mt, avT))
    lrT = np.zeros(mt.shape, np.int32) if lrT is None else lrT.numpy()
    S = mt.shape[1]
    E = E or elems_per_thread(width)
    key = np.full((S, width), SENT, np.int64)
    val = np.zeros((S, width), dtype)

    def frag(e, lanes):
        """Columns and value bits at `lanes` of fragment slot e of every
        slab, its A value and key base (lr * n in wrapping 32-bit
        arithmetic, as the kernel's unsigned multiply)."""
        rows = mt[e][:, None]
        key0 = (lrT[e].astype(np.uint32) * np.uint32(n)).astype(np.int32)
        return (table[rows, lanes], table[rows, lanes + run], avT[e][:, None],
                key0.astype(np.int64)[:, None])

    def put(sl, c, bits, a, key0):
        ok = c >= 0
        key[:, sl] = np.where(ok, key0 + c, SENT)
        with np.errstate(invalid="ignore"):
            val[:, sl] = np.where(ok, product(a, bits, dtype), 0)

    for t in range(width // E):
        base = t * E
        if run % E == 0:
            e = base // run
            if e < ka:
                off = (e & 1) * 2 * run + base - e * run
                put(slice(base, base + E),
                    *frag(e, np.arange(off, off + E)))
            continue
        for p in range(base, base + E):
            e = p // run
            if e < ka:
                put(slice(p, p + 1),
                    *frag(e, np.array([(e & 1) * 2 * run + p % run])))
    return key, val


def sorted_model(table, mt, avT, lrT, *, width, run, ka, n, dtype):
    """K8 / K9 as the kernel runs them: the slab source, then the
    register network from start_kk = 2 * run."""
    key, val = slab_model(table, mt, avT, lrT, width=width, run=run, ka=ka,
                          n=n, dtype=dtype)
    return run_network(key, val.astype(np.float64), 2 * run)


def plain_sorted(dtype):
    return (SK.expand_sort_lr_plain if dtype == np.float32
            else SK.expand_sort_lr_dd_plain)


def assert_same_pairs(k1, v1, k2, v2):
    """Equal sorted keys, and per slab the same multiset of (key, value)
    pairs: the network is not stable, so values of one key may sit in
    another order."""
    np.testing.assert_array_equal(k1, k2)
    for a, b, c, d in zip(k1, v1, k2, v2):
        o1, o2 = np.lexsort((b, a)), np.lexsort((d, c))
        np.testing.assert_array_equal(b[o1], d[o2])


def _ka(width, run, short):
    return width // run - (3 if short else 0)


# ------------------------------------------------------------- the source

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("run", GATHER_RUNS)
def test_slab_slot_map(width, run):
    """Every slot of the slab is one (thread, register); where run is a
    multiple of E (the vector load), a thread's E slots are E
    neighbouring lanes of one fragment slot starting on a multiple of 4
    (a 16-byte load from a table row of a multiple of 4 lanes), its value
    bits too; below that the thread spans E / run fragment slots. Even
    slots read the forward half, odd slots the reversed half, within the
    4 * run lanes of a table row."""
    E = elems_per_thread(width)
    e, lane, live = slot_map(width, run, width // run)
    assert live.all() and e.shape == (width // E, E)
    if run % E == 0:
        assert (e == e[:, :1]).all()
        assert (np.diff(lane, axis=1) == 1).all()
        assert (lane[:, 0] % 4 == 0).all()
        assert ((lane[:, 0] + run) % 4 == 0).all()
    else:
        assert run < E
        assert all(len(np.unique(row)) == E // run for row in e)
    half = lane // (2 * run)
    assert (half == (e & 1)).all()
    assert (lane % (2 * run) < run).all()
    assert lane.max() + run < 4 * run
    # each (fragment slot, position) is one slot
    assert len(set(zip(e.ravel(), (lane % run).ravel()))) == width


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("run", GATHER_RUNS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_slab_source_matches_expand_plain(width, run, dtype):
    """The source gives _expand_lr_plain's keys and products bit for bit,
    with fill-row slots (NaN A values, junk local rows up to 2^31 - 1)
    and padding slabs, fragment slots all used and a few short (slots
    past ka * run): those are SENTINEL / 0, and no NaN gets through."""
    npt, tt = DTYPES[dtype]
    for short in (False, True):
        ka = _ka(width, run, short)
        table, mt, avT, lrT, n = slab_fragments(6, ka, run,
                                                seed=width + run + short)
        fill = (mt == table.shape[0] - 1).numpy()
        assert np.isnan(avT.numpy()[fill]).all() and fill[:, -2:].all()
        assert (lrT.numpy()[fill] > 2**30).any()
        key, val = slab_model(table, mt, avT, lrT, width=width, run=run,
                              ka=ka, n=n, dtype=npt)
        pk, pv = SK._expand_lr_plain(table, mt, avT, lrT, ka, run, width, n,
                                     tt)
        np.testing.assert_array_equal(key, pk.numpy())
        assert np.isfinite(val).all()
        np.testing.assert_array_equal(val.view(np.int8),
                                      pv.numpy().view(np.int8))
        assert (key[-2:] == SENT).all() and not val[-2:].any()
        if short:
            assert (key[:, ka * run:] == SENT).all()
        e = np.arange(ka * run) // run
        assert (key[:, :ka * run][fill[e].T] == SENT).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("width,run", [(512, 8), (1024, 32)])
def test_keys_near_int32_max(dtype, width, run):
    """Keys lr * n + col up to rspan * n - 1, within rspan of 2^31 - 1
    (the planner declines slabs whose keys would reach it): the largest
    key is there, below SENTINEL, and after the network every slab is
    sorted with its SENTINEL slots last, as the plain version sorts."""
    npt = DTYPES[dtype][0]
    rspan = 64
    table, mt, avT, lrT, n = slab_fragments(5, width // run, run,
                                            rspan=rspan, seed=run)
    kw = dict(width=width, run=run, ka=width // run, n=n)
    key, _ = slab_model(table, mt, avT, lrT, dtype=npt, **kw)
    live = key[key != SENT]
    assert live.max() == rspan * n - 1 >= INT32_MAX - rspan
    sk, sv = sorted_model(table, mt, avT, lrT, dtype=npt, **kw)
    assert (np.diff(sk, axis=1) >= 0).all()
    assert ((sk == SENT).sum(axis=1) == (key == SENT).sum(axis=1)).all()
    pk, pv = plain_sorted(npt)(table, mt, avT, lrT, start_kk=2 * run, **kw)
    assert_same_pairs(sk, sv, pk.numpy(), pv.numpy().astype(np.float64))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_products_rounded_once_or_exact(dtype):
    """K8's product is the float32 product rounded once (the exact
    product, formed in float64, then rounded to float32); K9's is the
    exact product (two 24-bit mantissas fit 53 bits), checked against
    rational arithmetic."""
    npt = DTYPES[dtype][0]
    width, run = 1024, 32
    table, mt, avT, lrT, n = slab_fragments(4, width // run, run, seed=7)
    key, val = slab_model(table, mt, avT, lrT, width=width, run=run,
                          ka=width // run, n=n, dtype=npt)
    exact64 = slab_model(table, mt, avT, lrT, width=width, run=run,
                         ka=width // run, n=n, dtype=np.float64)[1]
    live = key != SENT
    assert live.sum() > 100
    if npt == np.float32:
        np.testing.assert_array_equal(
            val[live].view(np.int32),
            exact64[live].astype(np.float32).view(np.int32))
        return
    # the factors behind each live slot, rebuilt from the table
    t, m, a = table.numpy(), mt.numpy(), avT.numpy()
    s_idx, p_idx = np.nonzero(live)
    e = p_idx // run
    lanes = (e & 1) * 2 * run + p_idx % run + run
    b = t[m[e, s_idx], lanes].view(np.float32)
    for s, p, x, y in zip(s_idx[:400], p_idx[:400], a[e, s_idx], b):
        assert Fraction(float(val[s, p])) == Fraction(float(x)) * Fraction(
            float(y))


# ------------------------------------------------------------ K8, K9 whole

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("run", [8, 32])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["random", "one_key"])
def test_slab_model_sorts_as_plain(width, run, dtype, kind):
    """Source -> network from 2 * run against expand_sort_lr_plain /
    _dd_plain: sorted keys exactly, the same (key, value) pairs, and
    the run sums (the register compress against the plain compress, as
    K3 / K10 take them) within 1e-5 / 1e-12 of max(1, max|C|)."""
    npt = DTYPES[dtype][0]
    ka = width // run
    table, mt, avT, lrT, n = slab_fragments(5, ka, run, kind=kind,
                                            seed=width * run)
    kw = dict(width=width, run=run, ka=ka, n=n)
    sk, sv = sorted_model(table, mt, avT, lrT, dtype=npt, **kw)
    pk, pv = plain_sorted(npt)(table, mt, avT, lrT, start_kk=2 * run, **kw)
    assert_same_pairs(sk, sv, pk.numpy(), pv.numpy().astype(np.float64))
    col, sums, nnz = compress_model(sk, sv)
    pc, ps, pn = K.compress_plain(pk, pv, width=width, out_w=width)
    np.testing.assert_array_equal(nnz, pn.numpy()[:, 0])
    np.testing.assert_array_equal(col, pc.numpy())
    if kind == "one_key":
        assert (nnz[:-2] == 1).all() and (nnz[-2:] == 0).all()
    rtol = VALUE_RTOL if npt == np.float32 else F64_RTOL
    want = ps.numpy().astype(np.float64)
    assert np.abs(sums - want).max() <= rtol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_slab_model_on_planned_operands(dtype):
    """The model on the port's slab plan of the headline at m = 256 (the
    planner's table, mt, avT and lrT; padded slabs up to a multiple of
    128) against the plain version."""
    import bench
    npt = DTYPES[dtype][0]
    p, ops, kw = slab_operands(bench.build_matrix(m=256))
    assert (p.mt == p.table.shape[0] - 1).all(dim=0).any()
    mkw = dict(width=kw["width"], run=kw["run"], ka=kw["ka"], n=kw["n"])
    sk, sv = sorted_model(*ops, dtype=npt, **mkw)
    pk, pv = plain_sorted(npt)(*ops, **kw)
    assert_same_pairs(sk, sv, pk.numpy(), pv.numpy().astype(np.float64))


# --------------------------------------------------------------- the bound

@pytest.mark.parametrize("run", [8, 32])
def test_slab_read_bytes_counts_the_halves_k8_reads(run):
    """bench.kernels.table_read_bytes (the bytes K8's and K9's bound
    counts) is what the source reads: every table lane outside the
    halves some fragment slot reads (2 * run lanes: columns and value
    bits) may be overwritten without changing the plain version's
    products; overwriting the read lanes changes them; and the read
    halves plus mt, avT and lrT are table_read_bytes."""
    width = 512
    ka = width // run
    table, mt, avT, lrT, n = slab_fragments(6, ka, run, seed=run)
    read = np.zeros(table.shape, bool)
    for e in range(ka):
        off = (e & 1) * 2 * run
        read[mt[e].numpy(), off:off + 2 * run] = True
    assert KB.table_read_bytes(table, mt, run, avT, lrT) == (
        read.sum() * 4 + 3 * mt.numel() * 4)
    args = (mt, avT, lrT, ka, run, width, n, torch.float32)
    want = SK._expand_lr_plain(table, *args)
    rng = np.random.default_rng(run)
    noise = torch.from_numpy(rng.integers(0, 2**31 - 1, table.shape,
                                          dtype=np.int32))
    mask = torch.from_numpy(read)
    got = SK._expand_lr_plain(torch.where(mask, table, noise), *args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    got = SK._expand_lr_plain(torch.where(mask, noise, table), *args)
    assert not torch.equal(got[0], want[0])
