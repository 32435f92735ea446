"""K4's register network (csrc/sort_common.cuh, ``row_net_*``), modelled
in numpy: which slot each thread, register and lane compares at each
stage, where the shared-memory exchanges fall, and the duplicate sums /
compaction in registers that follow. The .cu follows this schedule step
for step; here it must sort random rows at every width 128-16384 from
every power-of-two start_kk, and compress them as the plain version
does (structure exact; float64 sums within 1e-9 * max(1, max|C|), as
the two sum each run in another order).

Layout: a row of W slots is held E per thread (E = 8, 16 at W = 16384),
T = W / E threads; in the normal layout thread t holds slots t*E ..
t*E + E - 1. Strides below E are compared inside a thread, strides E ..
16E between lanes of a warp (``__shfl_xor_sync``), and strides of 32E
and more only in the transposed layout, whose slot order swaps the
index's top wb bits (the warp bits) with its bottom wb bits: one
exchange through shared memory (one block barrier) into it, the stage's
large strides as register / lane strides there, one exchange back."""

import numpy as np
import pytest
import torch

from ia_spgemm_tpu_torch.ops import bitonic_kernels as K

SENT = K.SENTINEL
WIDTHS = [128, 256, 512, 1024, 2048, 4096, 8192, 16384]
WIDTHS = [w for w in WIDTHS if K.MIN_WIDTH <= w <= K.MAX_WIDTH]


def elems_per_thread(width):
    return 16 if width == 16384 else 8


def _bits(x):
    return int(x).bit_length() - 1


def transposed_slot(p, width, E=None):
    """The row slot held at position p of the transposed layout: p's top
    wb bits and bottom wb bits swapped (an involution); rows of one warp
    or less (wb <= 0) have none. E: slots a thread (elems_per_thread by
    default; K7a may take 16 at any width)."""
    n, e = _bits(width), _bits(E or elems_per_thread(width))
    wb = max(0, n - e - 5)
    lo_mask = (1 << wb) - 1
    lo = p & lo_mask
    hi = p >> (n - wb)
    mid = p & ((1 << (n - wb)) - 1) & ~lo_mask
    return (lo << (n - wb)) | mid | hi


def network_schedule(width, start_kk, E=None):
    """K4's steps: ("exchange", layout) or ("compare", layout, j, dirbit):
    every position p with bit j clear meets p + j, ascending where
    p & dirbit == 0, positions counted in the named layout."""
    E = E or elems_per_thread(width)
    n, e = _bits(width), _bits(E)
    big = 32 * E
    steps = []
    kk = start_kk
    while kk <= width:
        j = kk // 2
        if j >= big:
            wb = n - e - 5
            kt = kk >> (n - wb)
            steps.append(("exchange", "transposed"))
            jt = kt // 2
            while jt >= 1:
                steps.append(("compare", "transposed", jt,
                              kt if kk < width else 0))
                jt //= 2
            steps.append(("exchange", "normal"))
            j = big // 2
        while j >= 1:
            steps.append(("compare", "normal", j, kk))
            j //= 2
        kk *= 2
    return steps


def step_kind(width, j, E=None):
    """Where a compare of stride j (in its layout's positions) runs:
    inside a thread, or between lanes of one warp."""
    E = E or elems_per_thread(width)
    assert 1 <= j < 32 * E, (width, j)
    return "register" if j < E else "lane"


def run_network(keys, vals, start_kk, E=None):
    """Apply the schedule to rows (m, W) of keys and values; returns them
    in the normal layout."""
    k, v = keys.copy(), vals.copy()
    m, width = k.shape
    p = np.arange(width)
    P = transposed_slot(p, width, E)
    for step in network_schedule(width, start_kk, E):
        if step[0] == "exchange":
            k, v = k[:, P], v[:, P]     # P is its own inverse
            continue
        _, _, j, dirbit = step
        lo = p[(p & j) == 0]
        hi = lo + j
        asc = (lo & dirbit) == 0
        a, b = k[:, lo], k[:, hi]
        sw = np.where(asc, a > b, a < b)
        k[:, lo], k[:, hi] = np.where(sw, b, a), np.where(sw, a, b)
        va, vb = v[:, lo], v[:, hi]
        v[:, lo], v[:, hi] = np.where(sw, vb, va), np.where(sw, va, vb)
    return k, v


def _shfl_up(x, d, L):
    """__shfl_up_sync over segments of L lanes (axis 1): lanes below d
    keep their own value."""
    out = x.copy()
    T = x.shape[1]
    lane = np.arange(T) % L
    src = np.arange(T) - d
    ok = lane >= d
    out[:, ok] = x[:, src[ok]]
    return out


def scan_model(k, v):
    """The compress's scan of sorted rows as the kernel does it in
    registers (sort_common.cuh row_net_scan): per-thread segmented sums,
    a lane scan of (head seen, trailing run sum, survivor count) by
    shuffles, warp aggregates scanned through shared memory. Returns
    (keys, emit, sums, rank) per (row, thread, register) and each row's
    survivors: emit marks a run's last slot, sums holds its run's sum
    there, rank the survivor's place in the compacted row."""
    m, width = k.shape
    E = elems_per_thread(width)
    T = width // E
    L = min(T, 32)
    NW = T // L
    kt = k.reshape(m, T, E)
    vt = v.reshape(m, T, E).astype(np.float64)
    # neighbours across the thread boundary (shuffle within the warp,
    # shared memory across warps: the whole row is visible here)
    prev = np.concatenate([np.full((m, 1), 0), kt[:, :-1, -1]], axis=1)
    has_prev = np.arange(T) > 0
    nxt = np.concatenate([kt[:, 1:, 0], np.full((m, 1), 0)], axis=1)
    has_next = np.arange(T) < T - 1
    head = np.empty_like(kt, dtype=bool)
    head[:, :, 0] = ~has_prev | (kt[:, :, 0] != prev)
    head[:, :, 1:] = kt[:, :, 1:] != kt[:, :, :-1]
    last = np.empty_like(head)
    last[:, :, -1] = ~has_next | (kt[:, :, -1] != nxt)
    last[:, :, :-1] = kt[:, :, :-1] != kt[:, :, 1:]
    emit = last & (kt != SENT)
    s = vt.copy()
    for r in range(1, E):
        s[:, :, r] = np.where(head[:, :, r], vt[:, :, r],
                              s[:, :, r - 1] + vt[:, :, r])
    f = head.any(axis=2)
    a = s[:, :, -1]
    c = emit.sum(axis=2)
    # lane scan (Hillis-Steele by shuffles, width L)
    fi, ai, ci = f.copy(), a.copy(), c.copy()
    lane = np.arange(T) % L
    d = 1
    while d < L:
        fo, ao, co = _shfl_up(fi, d, L), _shfl_up(ai, d, L), \
            _shfl_up(ci, d, L)
        act = lane >= d
        ai = np.where(act, np.where(fi, ai, ao + ai), ai)
        fi = np.where(act, fi | fo, fi)
        ci = np.where(act, ci + co, ci)
        d *= 2
    fx = np.where(lane == 0, False, _shfl_up(fi, 1, L))
    ax = np.where(lane == 0, 0.0, _shfl_up(ai, 1, L))
    cx = np.where(lane == 0, 0, _shfl_up(ci, 1, L))
    # warp aggregates (lane L - 1), scanned; each warp's exclusive prefix
    wf = fi[:, L - 1::L]
    wa = ai[:, L - 1::L]
    wc = ci[:, L - 1::L]
    pf = np.zeros((m, NW), bool)
    pa = np.zeros((m, NW))
    pc = np.zeros((m, NW), np.int64)
    for w in range(1, NW):
        pa[:, w] = np.where(wf[:, w - 1], wa[:, w - 1], pa[:, w - 1]
                            + wa[:, w - 1])
        pf[:, w] = pf[:, w - 1] | wf[:, w - 1]
        pc[:, w] = pc[:, w - 1] + wc[:, w - 1]
    warp = np.arange(T) // L
    carry = np.where(fx, ax, pa[:, warp] + ax)
    base = pc[:, warp] + cx
    total = pc[:, -1] + wc[:, -1]
    seen = np.cumsum(head, axis=2) > 0
    sums = np.where(seen, s, carry[:, :, None] + s)
    rank = base[:, :, None] + np.cumsum(emit, axis=2) - emit
    return kt, emit, sums, rank, total


def compress_model(k, v):
    """The compress of sorted rows (sort_common.cuh row_net_compress):
    the scan, then each survivor at its rank. Returns (col, val, nnz)."""
    m, width = k.shape
    kt, emit, sums, rank, total = scan_model(k, v)
    col = np.full((m, width), -1, np.int64)
    val = np.zeros((m, width))
    rows = np.broadcast_to(np.arange(m)[:, None, None], emit.shape)
    col[rows[emit], rank[emit]] = kt[emit]
    val[rows[emit], rank[emit]] = sums[emit]
    return col, val, total


def _rows(width, start_kk, m=3, seed=0, key_range=None):
    """Random rows in K4's input layout for start_kk: sorted runs of
    start_kk / 2 slots, ascending and descending in turn (any row for
    start_kk = 2), with duplicates and SENTINEL slots."""
    rng = np.random.default_rng(seed * 131 + width + start_kk)
    hi = key_range or max(4, width // 3)
    k = rng.integers(0, hi, (m, width)).astype(np.int64)
    k[rng.random((m, width)) < 0.1] = SENT
    k[0, :] = 7                               # a row of one key
    v = rng.standard_normal((m, width))
    half = max(1, start_kk // 2)
    if half > 1:
        kr = k.reshape(m, width // half, half)
        order = np.argsort(kr, axis=2, kind="stable")
        order[:, 1::2] = order[:, 1::2, ::-1]
        k = np.take_along_axis(kr, order, 2).reshape(m, width)
        v = np.take_along_axis(v.reshape(m, width // half, half), order,
                               2).reshape(m, width)
    return k, v


def _start_kks(width):
    return [1 << i for i in range(1, _bits(width) + 1)]


@pytest.mark.parametrize("width,start_kk", [
    (w, s) for w in WIDTHS for s in _start_kks(w)])
def test_network_sorts_from_every_start(width, start_kk):
    k, v = _rows(width, start_kk)
    sk, sv = run_network(k, v, start_kk)
    assert (np.diff(sk, axis=1) >= 0).all()
    # a permutation of each row's (key, value) pairs
    for r in range(k.shape[0]):
        assert sorted(zip(sk[r], sv[r])) == sorted(zip(k[r], v[r]))


@pytest.mark.parametrize("width", WIDTHS)
def test_barriers_only_for_strides_of_32E(width):
    """Compares stay inside a warp (lane strides below 32E, in the row's
    own lane segment for rows under a warp); exchanges come in pairs
    around a stage's strides of 32E and more, none for rows of at most
    32E slots. Ring shard (1024, start_kk 64): 4 exchanges, not the 40
    barriered passes of the shared-memory network; 2048 from 2: 6."""
    E = elems_per_thread(width)
    T = width // E
    L = min(T, 32)
    steps = network_schedule(width, 2)
    for st in steps:
        if st[0] != "compare":
            continue
        j = st[2]
        if step_kind(width, j) == "lane":
            t = np.arange(T)
            partner = t ^ (j // E)
            assert (partner // L == t // L).all()
    ex = [st for st in steps if st[0] == "exchange"]
    assert len(ex) == 2 * sum(1 for i in range(1, _bits(width) + 1)
                              if (1 << i) // 2 >= 32 * E)
    if width <= 32 * E:
        assert not ex
    if width == 1024:
        assert sum(st[0] == "exchange"
                   for st in network_schedule(1024, 64)) == 4
    if width == 2048:
        assert len(ex) == 6


@pytest.mark.parametrize("width", WIDTHS)
def test_transposed_layout_is_an_involution(width):
    p = np.arange(width)
    P = transposed_slot(p, width)
    assert sorted(P) == list(p)
    assert (transposed_slot(P, width) == p).all()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("keys", ["random", "one_key", "sentinel",
                                  "straddling_runs"])
def test_register_compress_matches_plain(width, keys):
    """Sort + compress through the model against the port's plain K4,
    with rows of one key, of SENTINEL only, and with duplicate runs that
    straddle register, lane and warp boundaries."""
    m = 3
    rng = np.random.default_rng(width)
    E = elems_per_thread(width)
    if keys == "random":
        k, v = _rows(width, 2, m=m)
    else:
        v = rng.standard_normal((m, width))
        if keys == "one_key":
            k = np.full((m, width), 5, np.int64)
        elif keys == "sentinel":
            k = np.full((m, width), SENT, np.int64)
        else:
            # runs of E + 3, 32E + 5 and E // 2 slots, then SENTINEL
            lens = [E + 3, E // 2, 32 * E + 5, 1, E - 1]
            ks = np.concatenate([np.full(n, i) for i, n in
                                 enumerate(lens * width)])[:width]
            k = np.tile(ks, (m, 1))
            k[:, width - width // 5:] = SENT
            k = k[:, rng.permutation(width)]
    sk, sv = run_network(k, v, 2)
    col, val, nnz = compress_model(sk, sv)
    kt = torch.from_numpy(k.astype(np.int32))
    vt = torch.from_numpy(v.astype(np.float64))
    pc, pv, pn = K.sort_compress_rows_plain(kt, vt, width=width, start_kk=2)
    np.testing.assert_array_equal(nnz, pn[:, 0].numpy())
    np.testing.assert_array_equal(col, pc.numpy())
    scale = max(1.0, float(np.abs(pv.numpy()).max()))
    assert np.abs(val - pv.numpy()).max() <= 1e-9 * scale
