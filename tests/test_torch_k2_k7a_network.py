"""K2 and K7a on the register network (csrc/bitonic.cu: ``row_net_rows``
with the ``TableIn`` source of csrc/sort_common.cuh, no slab rows; K7a
through ``PackedIn`` on the key-only network, value type ``NoVal``),
modelled in numpy: which fragment, table row and lanes each thread and
register reads straight from the wide B table through the fragment index
rT, the key (the column) and the float32 product each slot gets, the
selects that leave empty slots SENTINEL / 0, K7a's packing of each slot
into one int32 key (``pack_colval``), and the sort:
tests/test_torch_k4_network.py's schedule, which the .cu follows step for
step, at E = 8 slots a thread (K2) and E = 16 (K7a: its keys alone leave
the registers for twice K2's slots; half the threads a row, one stride
fewer across warps).
The source is tests/test_torch_k8_k9_network.py's model of the same
``TableIn`` with the slab rows left out (the kernel's null lrT: key0 0).

Here K2 (source -> network from start_kk = 2 * run) must give
``expand_sort_plain``'s sorted keys exactly and the same (key, value)
pairs, and K7a ``expand_sort_packed_plain``'s sorted packed keys bit for
bit, at widths 128-1024 (rows of one warp or less, which share a block,
and rows of more than a warp) and runs 8 and 32, with odd fragments on
the reversed half, sentinel-row fragments under NaN A values, columns at
32767 and products whose bf16 rounds to the 0xFFFE cap. The wrappers'
operand checks run here too; ``bench.kernels.table_read_bytes`` is
checked against the lanes the plain version reads."""

import numpy as np
import pytest
import torch

from ia_spgemm_tpu_torch.bench import kernels as KB
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
from tests.test_torch_k4_network import (compress_model, network_schedule,
                                         run_network, step_kind,
                                         transposed_slot)
from tests.test_torch_k8_k9_network import (assert_same_pairs, slab_model,
                                            slot_map)
from tests.torch_parity import (CAP_BITS, MAX_COL, RUN, VALUE_RTOL,
                                table_fragments, table_inputs)

SENT = K.SENTINEL
WIDTHS = [128, 256, 512, 1024]   # K2's and the flat route's widths
RUNS = [8, 32]
E_K2, E_K7A = 8, 16               # slots a thread


def table_model(table, rT, avT, *, width, run, ka, E=E_K2):
    """load_slots for TableIn without slab rows (K2, K7a), thread by
    thread: (key, val) (m, width) in the normal layout."""
    return slab_model(table, rT, avT, None, width=width, run=run, ka=ka,
                      n=1, dtype=np.float32, E=E)


def pack_model(key, val):
    """pack_colval (csrc/bitonic.cu) on uint32: round the float32 bits
    to nearest even bf16 (0x7FFF + the kept lsb, the add wrapping at
    2^32), keep the 16 high bits capped at 0xFFFE, below the column's 15
    bits; SENTINEL slots stay SENTINEL (PackedIn's select)."""
    pb = np.asarray(val, np.float32).view(np.uint32).astype(np.uint64)
    rnd = (pb + 0x7FFF + ((pb >> 16) & 1)) & 0xFFFFFFFF
    enc = np.minimum(rnd >> 16, 0xFFFE)
    col = np.where(key == SENT, 0, key).astype(np.uint64)
    packed = ((col << 16) | enc).astype(np.uint32).view(np.int32)
    return np.where(key == SENT, SENT, packed).astype(np.int64)


def k2_model(table, rT, avT, *, width, run, ka):
    """K2: the table source, then the (key, value) network from 2 * run
    (E = 8 at these widths)."""
    key, val = table_model(table, rT, avT, width=width, run=run, ka=ka)
    return run_network(key, val.astype(np.float64), 2 * run)


def k7a_model(table, rT, avT, *, width, run, ka, E=E_K7A):
    """K7a: the table source, each slot packed, then the key-only network
    (no value moves: the keys alone through the same schedule)."""
    key, val = table_model(table, rT, avT, width=width, run=run, ka=ka,
                           E=E)
    p = pack_model(key, val)
    return run_network(p, np.zeros(p.shape), 2 * run, E)[0]


def _ops(width, run, kind="random", short=False, m=9):
    ka = width // run - (3 if short else 0)
    table, rT, avT = table_fragments(m, ka, run, kind=kind,
                                     seed=width + run + short)
    return (table, rT, avT), dict(width=width, run=run, ka=ka)


# ------------------------------------------------------------- the source

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("E", [E_K2, E_K7A])
def test_table_slot_map(width, run, E):
    """Every slot of the row is one (thread, register); where run is a
    multiple of E (the vector load), a thread's E slots are E neighbouring
    lanes of one fragment starting on a multiple of 4 (16-byte loads from
    a table row of a multiple of 4 lanes), its value bits too; at E = 16
    and run 8 a thread spans two fragments, slot by slot. Even fragments
    read the forward half, odd ones the reversed half."""
    e, lane, live = slot_map(width, run, width // run, E)
    assert live.all() and e.shape == (width // E, E)
    if run % E == 0:
        assert (e == e[:, :1]).all()
        assert (np.diff(lane, axis=1) == 1).all()
        assert (lane[:, 0] % 4 == 0).all() and ((lane[:, 0] + run) % 4
                                                == 0).all()
    else:
        assert (run, E) == (8, 16)
        assert all(len(np.unique(row)) == E // run for row in e)
    assert (lane // (2 * run) == (e & 1)).all()
    assert (lane % (2 * run) < run).all() and lane.max() + run < 4 * run
    assert len(set(zip(e.ravel(), (lane % run).ravel()))) == width


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("E", [E_K2, E_K7A])
def test_table_source_matches_expand_plain(width, run, E):
    """The source gives _expand_plain's keys and products on g =
    table[rT] bit for bit, fragments all used and a few short: odd
    fragments read the reversed half, sentinel-row fragments (NaN A
    values) and the padding rows are SENTINEL / 0, no NaN gets through."""
    for short in (False, True):
        (table, rT, avT), kw = _ops(width, run, short=short)
        ka = kw["ka"]
        sent_row = (rT == table.shape[0] - 1).numpy()
        assert np.isnan(avT.numpy()[sent_row]).all()
        assert sent_row[:, -2:].all()
        key, val = table_model(table, rT, avT, E=E, **kw)
        pk, pv = K._expand_plain(K.table_gather(table, rT), avT, ka, run,
                                 width, 1)
        np.testing.assert_array_equal(key, pk.numpy())
        assert np.isfinite(val).all()
        np.testing.assert_array_equal(val.view(np.int32),
                                      pv.numpy().view(np.int32))
        assert (key[-2:] == SENT).all() and not val[-2:].any()
        if short:
            assert (key[:, ka * run:] == SENT).all()
        # odd fragments: the reversed half (lanes 2 * run .. 3 * run)
        t, r = table.numpy(), rT.numpy()
        for e in range(1, ka, 2):
            want = t[r[e], 2 * run:3 * run]
            got = key[:, e * run:(e + 1) * run]
            np.testing.assert_array_equal(np.where(want >= 0, want, SENT),
                                          got)


def test_pack_model_matches_plain_bit_for_bit():
    """pack_model against bitonic_kernels._pack_colval (the JAX package's
    _pack_colval bit for bit), on crafted products: ties to even, carries
    into the exponent, +-0, denormals, +-inf, the largest finite value,
    and the negative NaNs that round to 0xFFFF (capped at 0xFFFE) or wrap
    past 2^32 (to 0); columns 0 .. 32767. The keys order by (column,
    value bits) under signed compares, all below SENTINEL."""
    bits = np.array([0x3F800000, 0x3F808000, 0x3F818000, 0x3F80FFFF,
                     0xBF808000, 0x00000000, 0x80000000, 0x00000001,
                     0x807FFFFF, 0x7F800000, 0xFF800000, 0x7F7FFFFF,
                     0xFF7FFFFF, 0x7FC00000, *CAP_BITS], np.uint32)
    cols = np.array([0, 1, 12345, MAX_COL])
    c = np.repeat(cols, len(bits))
    v = np.tile(bits, len(cols)).view(np.float32)
    got = pack_model(c, v)
    want = K._pack_colval(torch.from_numpy(c),
                          torch.from_numpy(v.copy())).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    enc = got & 0xFFFF
    cap = np.isin(np.tile(bits, len(cols)), CAP_BITS[:3])
    assert (enc[cap] == 0xFFFE).all()
    assert (enc[np.tile(bits, len(cols)) >= 0xFFFF8000] == 0).all()
    assert (got >= 0).all() and (got < SENT).all()
    assert ((got >> 16) == c).all()


# ------------------------------------------------------------- the network

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("E", [E_K2, E_K7A])
def test_schedule_at_k2_and_k7a_slots(width, E):
    """K2's and K7a's sorts are K4's schedule at E slots a thread: lane
    compares stay inside the row's lane segment (rows of at most 32E
    slots, one warp or less, share a block and need no exchange);
    exchanges pair up around the strides of 32E and more. At 1024 from
    start_kk 64: 4 exchanges at K2's E = 8, 2 at K7a's E = 16 (one
    stride fewer crosses warps). The transposed layout is an
    involution."""
    T = width // E
    L = min(T, 32)
    steps = network_schedule(width, 64, E)
    for st in steps:
        if st[0] == "compare" and step_kind(width, st[2], E) == "lane":
            t = np.arange(T)
            assert ((t ^ (st[2] // E)) // L == t // L).all()
    ex = sum(st[0] == "exchange" for st in steps)
    if width <= 32 * E:
        assert ex == 0 and 128 % T == 0
    if width == 1024:
        assert ex == {8: 4, 16: 2}[E]
    p = np.arange(width)
    assert (transposed_slot(transposed_slot(p, width, E), width, E)
            == p).all()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("kind", ["random", "one_key", "cap"])
def test_k7a_model_sorts_as_plain(width, run, kind):
    """Source -> pack -> key-only network from 2 * run against
    expand_sort_packed_plain: the sorted packed keys bit for bit (equal
    multisets sort to equal arrays), SENTINEL slots last; one key over a
    whole row (column 32767), and B values that pack to the 0xFFFE cap
    or wrap to 0."""
    (table, rT, avT), kw = _ops(width, run, kind=kind)
    got = k7a_model(table, rT, avT, **kw)
    want = K.expand_sort_packed_plain(table, rT, avT, start_kk=2 * run,
                                      **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got, axis=1) >= 0).all()
    live = got[:-2][got[:-2] != SENT]
    assert live.size and (live >> 16).max() == MAX_COL
    if kind == "cap":
        assert ((live & 0xFFFF) == 0xFFFE).any()
    if kind == "one_key":
        assert ((live >> 16) == MAX_COL).all()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("kind", ["random", "one_key"])
def test_k2_model_sorts_as_plain(width, run, kind):
    """Source -> (key, value) network from 2 * run against
    expand_sort_plain from the table: sorted keys exactly, the same
    (key, value) pairs, and the run sums (the register compress against
    the plain compress, as K3 takes them) within 1e-5 of max(1,
    max|C|)."""
    (table, rT, avT), kw = _ops(width, run, kind=kind)
    sk, sv = k2_model(table, rT, avT, **kw)
    pk, pv = K.expand_sort_plain(table, avT, rT=rT, start_kk=2 * run, **kw)
    assert_same_pairs(sk, sv, pk.numpy(), pv.numpy().astype(np.float64))
    col, sums, nnz = compress_model(sk, sv)
    pc, ps, pn = K.compress_plain(pk, pv, width=width, out_w=width)
    np.testing.assert_array_equal(nnz, pn.numpy()[:, 0])
    np.testing.assert_array_equal(col, pc.numpy())
    want = ps.numpy().astype(np.float64)
    assert np.abs(sums - want).max() <= VALUE_RTOL * max(1.0,
                                                         np.abs(want).max())


@pytest.mark.parametrize("ka", [16, 32, 128])
def test_models_on_the_flat_route_operands(ka):
    """The models on the flat route's own table source (_flat_table of
    kernel_operands, NaN A values on the empty rows; widths 128 and
    1024, run 8): K7a bit for bit, K2 sorted keys exactly."""
    table, rT, avT, width = table_inputs(ka, m=40)
    kw = dict(width=width, run=RUN, ka=ka)
    np.testing.assert_array_equal(
        k7a_model(table, rT, avT, **kw),
        K.expand_sort_packed_plain(table, rT, avT, start_kk=2 * RUN,
                                   **kw).numpy())
    sk, sv = k2_model(table, rT, avT, **kw)
    pk, pv = K.expand_sort_plain(table, avT, rT=rT, start_kk=2 * RUN, **kw)
    assert_same_pairs(sk, sv, pk.numpy(), pv.numpy().astype(np.float64))


# ------------------------------------------------------------ the wrappers

def test_table_source_plain_equals_gather_source():
    """K2's plain version from the table through rT is its plain version
    on g = table[rT] (pack 1), and the wrappers run it on CPU tensors
    without counting a launch."""
    table, rT, avT, width = table_inputs(32)
    kw = dict(ka=32, run=RUN, width=width, start_kk=2 * RUN)
    want = K.expand_sort_plain(K.table_gather(table, rT), avT, **kw)
    before = K.launch_counts()
    for got in (K.expand_sort_plain(table, avT, rT=rT, **kw),
                K.expand_sort(table, avT, rT=rT, **kw)):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    p = K.expand_sort_packed(table, rT, avT, **kw)
    assert torch.equal(p, K.expand_sort_packed_plain(table, rT, avT, **kw))
    assert K.launch_counts() == before


BAD_OPERANDS = ["table_dtype", "table_1d", "lanes_short", "lanes_not_mult4",
                "rT_dtype", "rT_shape", "rT_transposed", "avT_shape",
                "device", "ka_run"]


@pytest.mark.parametrize("kernel,bad", [
    *((k, b) for k in ("K2", "K7a") for b in BAD_OPERANDS), ("K2", "pack")])
def test_table_wrappers_check_operands(kernel, bad):
    """K2's table source and K7a: the table a 2-d int32 (F, lanes) with
    lanes >= 4 * run and a multiple of 4; rT int32 (ka, m) like avT; all
    on one device; ka * run within the width; K2's table source at pack
    1. rT's values are not checked (a device sync)."""
    table, rT, avT, width = table_inputs(16, m=12)
    kw = dict(ka=16, run=RUN, width=width, start_kk=2 * RUN)
    err = ValueError
    if bad == "table_dtype":
        table, err = table.float(), TypeError
    elif bad == "table_1d":
        table, err = table.reshape(-1), TypeError
    elif bad == "lanes_short":
        table = table[:, :4 * RUN - 4].contiguous()
    elif bad == "lanes_not_mult4":
        table = torch.nn.functional.pad(table, (0, 2))
    elif bad == "rT_dtype":
        rT, err = rT.long(), TypeError
    elif bad == "rT_shape":
        rT = rT[:-1].contiguous()
    elif bad == "rT_transposed":
        rT = rT.T.contiguous()
    elif bad == "avT_shape":
        avT = avT[:, :-1].contiguous()
    elif bad == "device":
        table = torch.empty(table.shape, dtype=table.dtype, device="meta")
    elif bad == "ka_run":
        kw["width"] = 128 if width > 128 else 64
        err = ValueError
    else:
        kw["pack"] = 2
    with pytest.raises(err):
        if kernel == "K2":
            K.expand_sort(table, avT, rT=rT, **kw)
        else:
            K.expand_sort_packed(table, rT, avT, **kw)


# --------------------------------------------------------------- the bound

@pytest.mark.parametrize("run", RUNS)
def test_table_read_bytes_counts_the_halves_k2_reads(run):
    """bench.kernels.table_read_bytes (the bytes K2's and K7a's bound
    counts from the table) is what the source reads: lanes outside the
    halves some fragment reads may be overwritten without changing the
    plain version's products, overwriting the read lanes changes them,
    and the read halves plus rT and avT are table_read_bytes."""
    width = 512
    ka = width // run
    table, rT, avT = table_fragments(6, ka, run, seed=run)
    read = np.zeros(table.shape, bool)
    for e in range(ka):
        off = (e & 1) * 2 * run
        read[rT[e].numpy(), off:off + 2 * run] = True
    assert KB.table_read_bytes(table, rT, run, avT) == (
        read.sum() * 4 + 2 * rT.numel() * 4)

    def expand(t):
        return K._expand_plain(K.table_gather(t, rT), avT, ka, run, width, 1)

    want = expand(table)
    noise = torch.from_numpy(np.random.default_rng(run).integers(
        0, 2**31 - 1, table.shape, dtype=np.int32))
    mask = torch.from_numpy(read)
    got = expand(torch.where(mask, table, noise))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert not torch.equal(expand(torch.where(mask, noise, table))[0],
                           want[0])
