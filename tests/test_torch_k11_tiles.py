"""K11's row-tile schedule (csrc/dense_row.cu), modelled in numpy: which
slots a tile holds in each pass, the bitonic network that sorts their
(column, tile index) keys, the segments (one per distinct column, each B
row segment read once per tile and pass), and the order in which each
row receives its products. The .cu follows this schedule step for step;
here it must give ``dense_row_plain`` bit for bit on ELL built from
canonical CSR, and agree within the values' rounding on rows with
unsorted or repeated columns (float32: 1e-5 * max(1, max|C|), float64:
1e-12 * max(1, max|C|), the tolerances of tests/torch_parity.py: the two
add such a row's products in another order). Also the float64 kernel's
plain version against the JAX package.

Tile: R consecutive output rows (8 in the .cu) and a chunk of W columns
(128 threads x 2 vectors of 16 bytes: 1024 float32 or 512 float64
columns). A pass takes kcp slots of each row (kcp = min(K, 32) rounded
up to a power of two; K > 32 in several passes); its R * kcp keys are
(column << 32 | r * kcp + slot), empty slots ~0 (last).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ia_spgemm_tpu.formats import convert as jconvert
from ia_spgemm_tpu.formats.types import CSR as JCSR
from ia_spgemm_tpu.ops import dense_row as jdr
from ia_spgemm_tpu_torch.bench.kernels import k11_segment_bytes
from ia_spgemm_tpu_torch.formats import convert as tconvert
from ia_spgemm_tpu_torch.formats.types import CSR as TCSR
from ia_spgemm_tpu_torch.ops import dense_row as tdr
from ia_spgemm_tpu_torch.ops import dense_row_kernels as DK
from tests import fixtures
from tests.torch_parity import (F64_RTOL, VALUE_RTOL, assert_values_close,
                                jell, tell)

ROWS = 8           # kRows
SLOTS = 32         # kSlots
THREADS = 128      # kThreads
VECS = 2           # kVecs
EMPTY = (1 << 64) - 1


def chunk_width(dtype):
    """W: 128 threads x 2 vectors of 16 bytes of the value type."""
    return THREADS * VECS * (16 // np.dtype(dtype).itemsize)


def pass_slots(K):
    """kcp: the slots of a row in one pass."""
    kcp = 1
    while kcp < K and kcp < SLOTS:
        kcp *= 2
    return kcp


def bitonic_sort(keys):
    """The block's network over a power-of-two list: stage kk, stride j,
    position i (bit j clear) meets i + j, ascending where i & kk == 0."""
    k = list(keys)
    n = len(k)
    kk = 2
    while kk <= n:
        j = kk // 2
        while j:
            for t in range(n // 2):
                i = ((t & ~(j - 1)) << 1) | (t & (j - 1))
                if (k[i] > k[i + j]) == ((i & kk) == 0):
                    k[i], k[i + j] = k[i + j], k[i]
            j //= 2
        kk *= 2
    return k


def tile_passes(a_col, row0, rows=ROWS):
    """One tile's passes: for each, (kcp, sorted keys, segments), a
    segment (column, first entry, end) per distinct column."""
    m, K = a_col.shape
    kcp = pass_slots(K)
    out = []
    for k0 in range(0, K, kcp):
        keys = []
        for i in range(rows * kcp):
            row, kk = row0 + i // kcp, k0 + i % kcp
            c = a_col[row, kk] if row < m and kk < K else -1
            keys.append((int(c) << 32) | i if c >= 0 else EMPTY)
        keys = bitonic_sort(keys)
        live = [x for x in keys if x != EMPTY]
        segs = []
        for e, x in enumerate(live):
            if e == 0 or x >> 32 != live[e - 1] >> 32:
                segs.append([x >> 32, e, e])
            segs[-1][2] = e + 1
        out.append((kcp, live, segs))
    return out


def dense_row_model(a_col, a_val, b, rows=ROWS, width=None):
    """C as K11 computes it: per tile and column chunk, the segments in
    column order, each applied to its entries' rows in entry order,
    multiply and add rounded separately in b's type; columns past n and
    rows past m never stored."""
    m, K = a_col.shape
    n = b.shape[1]
    dt = b.dtype
    W = width or chunk_width(dt)
    c = np.zeros((m, n), dt)
    for row0 in range(0, m, rows):
        passes = tile_passes(a_col, row0, rows)
        for c0 in range(0, n, W):
            cols = slice(c0, min(c0 + W, n))
            acc = np.zeros((rows, W), dt)
            for p, (kcp, live, segs) in enumerate(passes):
                for col, e0, e1 in segs:
                    seg = np.zeros(W, dt)
                    seg[:cols.stop - c0] = b[col, cols]
                    for x in live[e0:e1]:
                        r, kk = divmod(x & 0xFFFFFFFF, kcp)
                        v = dt.type(a_val[row0 + r, p * kcp + kk])
                        acc[r] = acc[r] + v * seg
            hi = min(rows, m - row0)
            c[row0:row0 + hi, cols] = acc[:hi, :cols.stop - c0]
    return c


def _canonical(m, k, density, seed, dtype=np.float32, empty_rows=()):
    rng = np.random.default_rng(seed)
    a = sp.random(m, k, density=density, format="csr", random_state=rng,
                  dtype=np.float64)
    a.data = rng.standard_normal(a.nnz)
    a = a.tolil()
    for r in empty_rows:
        a[r, :] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    a.sort_indices()
    E = tell(a, dtype=dtype)
    return E.col_ind.numpy(), E.values.numpy()


def _dense_b(k, n, seed, dtype):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(dtype)


def _plain(a_col, a_val, b):
    return DK.dense_row_plain(torch.from_numpy(a_col),
                              torch.from_numpy(a_val),
                              torch.from_numpy(b)).numpy()


@pytest.mark.parametrize("rows,width", [(ROWS, None), (16, 128), (4, 96),
                                        (8, 40)])
@pytest.mark.parametrize("m,k,n,density", [(37, 30, 50, 0.2),
                                           (16, 64, 17, 0.5),
                                           (45, 90, 130, 0.4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_model_matches_plain_bit_for_bit(rows, width, m, k, n, density,
                                         dtype):
    """Canonical ELL (rows ascending), m and n not multiples of the tile,
    K above and below one pass of 32 slots (density 0.4-0.5: rows of up
    to ~50 entries)."""
    a_col, a_val = _canonical(m, k, density, seed=m + k, dtype=dtype,
                              empty_rows=(0, m - 1))
    b = _dense_b(k, n, seed=n, dtype=dtype)
    got = dense_row_model(a_col, a_val, b, rows=rows, width=width)
    want = _plain(a_col, a_val, b)
    np.testing.assert_array_equal(got, want)
    assert not got[0].any() and not got[-1].any()


@pytest.mark.parametrize("m,k,density", [(37, 30, 0.2), (40, 64, 0.5)])
def test_segments_are_the_distinct_columns(m, k, density):
    """Each pass's segments are its distinct columns in ascending order,
    each once, and every live slot is one entry; the tile's B segment
    reads count them, fewer than its live slots where rows share
    columns."""
    a_col, _ = _canonical(m, k, density, seed=3)
    K = a_col.shape[1]
    kcp = pass_slots(K)
    total_reads, total_live = 0, 0
    for row0 in range(0, m, ROWS):
        for p, (kc, live, segs) in enumerate(tile_passes(a_col, row0)):
            assert kc == kcp
            blk = a_col[row0:row0 + ROWS, p * kcp:(p + 1) * kcp]
            distinct = np.unique(blk[blk >= 0])
            assert [s[0] for s in segs] == distinct.tolist()
            assert len(live) == int((blk >= 0).sum())
            assert segs[-1][2] == len(live) if segs else not live
            for col, e0, e1 in segs:
                assert all(x >> 32 == col for x in live[e0:e1])
            total_reads += len(segs)
            total_live += len(live)
    assert total_reads < total_live


@pytest.mark.parametrize("K", [0, 1, 3, 29, 32, 33, 70, 100])
def test_passes_cover_every_slot_once(K):
    """A tile's passes take every slot of its rows once, in slot order:
    ceil(K / kcp) passes of R x kcp keys, each pass's live entries in its
    shared-memory lists (at most R x kcp) and at most as many segments."""
    kcp = pass_slots(K)
    rng = np.random.default_rng(K)
    a_col = rng.integers(-3, 40, (2 * ROWS + 3, K)).astype(np.int32)
    for row0 in range(0, a_col.shape[0], ROWS):
        passes = tile_passes(a_col, row0)
        assert len(passes) == -(-K // kcp)
        seen = []
        for p, (_, live, segs) in enumerate(passes):
            assert len(segs) <= len(live) <= ROWS * kcp
            seen += [(row0 + (x & 0xFFFFFFFF) // kcp,
                      p * kcp + (x & 0xFFFFFFFF) % kcp) for x in live]
        blk = a_col[row0:row0 + ROWS]
        want = [(row0 + r, kk) for r, kk in zip(*np.nonzero(blk >= 0))]
        assert sorted(seen) == sorted(want)


@pytest.mark.parametrize("K", [1, 3, 29, 32, 33, 70])
def test_pass_slots_and_network(K):
    """kcp is a power of two covering min(K, 32); the network sorts any
    list of unique keys (the tile index makes every key unique)."""
    kcp = pass_slots(K)
    assert kcp & (kcp - 1) == 0 and min(K, SLOTS) <= kcp <= SLOTS
    rng = np.random.default_rng(K)
    keys = [int(x) for x in rng.permutation(ROWS * kcp)]
    keys[::3] = [EMPTY] * len(keys[::3])
    assert bitonic_sort(keys) == sorted(keys)


@pytest.mark.parametrize("m,k,density", [(37, 30, 0.2), (40, 120, 0.4)])
def test_segment_bytes_count_the_model_segments(m, k, density):
    """bench/kernels.py's count of the B bytes K11 reads is the model's
    segments x n x the value size; at one row a tile, one per live slot."""
    a_col, _ = _canonical(m, k, density, seed=5)
    n = 70
    segs = sum(len(segs) for row0 in range(0, m, ROWS)
               for _, _, segs in tile_passes(a_col, row0))
    assert k11_segment_bytes(a_col, n, 4) == segs * n * 4
    assert k11_segment_bytes(a_col, n, 8, rows=1) == (a_col >= 0).sum() * n * 8


def _unsorted(m, k, seed, dtype):
    """ELL rows with shuffled slots, repeated columns and an empty slot
    between live ones: rows the .mtx reader can give unsorted."""
    a_col, a_val = _canonical(m, k, 0.3, seed=seed, dtype=dtype)
    rng = np.random.default_rng(seed)
    K = a_col.shape[1]
    a_col = np.concatenate([a_col, a_col[:, :4]], axis=1)  # repeats
    a_val = np.concatenate([a_val, (a_val[:, :4] * 0.5).astype(dtype)],
                           axis=1)
    a_col[::3, K // 2] = -1
    for r in range(m):
        p = rng.permutation(a_col.shape[1])
        a_col[r], a_val[r] = a_col[r, p], a_val[r, p]
    return np.ascontiguousarray(a_col), np.ascontiguousarray(a_val)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, VALUE_RTOL),
                                        (np.float64, F64_RTOL)])
@pytest.mark.parametrize("m,k,n", [(33, 40, 70), (20, 120, 33)])
def test_unsorted_rows_within_tolerance(dtype, rtol, m, k, n):
    """Shuffled, repeated and interleaved-empty slots: the model adds a
    row's products in (column, slot) order, the plain version in slot
    order; within the stated tolerance of max(1, max|C|)."""
    a_col, a_val = _unsorted(m, k, seed=m, dtype=dtype)
    b = _dense_b(k, n, seed=k, dtype=dtype)
    got = dense_row_model(a_col, a_val, b)
    assert_values_close(got, _plain(a_col, a_val, b), rtol=rtol)


def test_zero_coefficient_against_inf_stays_nan_free_elsewhere():
    """A stored 0 against a B row with inf gives NaN in its own row, as
    the plain version's multiply does; rows that do not reference the
    segment stay finite (no multiply by a zero coefficient)."""
    a = sp.csr_matrix((np.float32([0.0, 2.0, 1.0]), ([0, 1, 2], [3, 3, 1])),
                      shape=(3, 5))
    E = tell(a)
    b = _dense_b(5, 9, seed=1, dtype=np.float32)
    b[3, 2] = np.inf
    with np.errstate(invalid="ignore"):
        got = dense_row_model(E.col_ind.numpy(), E.values.numpy(), b)
    want = _plain(E.col_ind.numpy(), E.values.numpy(), b)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0, 2]) and np.isinf(got[1, 2])
    assert np.isfinite(got[2]).all()


@pytest.mark.parametrize("name,m,k,n,da,db", [
    ("small", 16, 16, 16, 0.3, 0.3),
    ("uneven_tile", 13, 13, 13, 0.3, 0.3),
    ("rect", 40, 24, 70, 0.25, 0.4),
])
def test_dense_row_float64_matches_jax(name, m, k, n, da, db):
    """The float64 route (the harness's dense_row row on a float64 CSR):
    the port's spgemm_dense_row against the JAX package's (interpret
    mode, x64), both computing in B's type."""
    a = fixtures.random_csr(m, k, density=da, seed=80).astype(np.float64)
    b = fixtures.random_csr(k, n, density=db, seed=81).astype(np.float64)
    J = jdr.spgemm_dense_row(jell(a, np.float64), jconvert.csr_to_dense(
        JCSR.from_scipy(b)))
    T = tdr.spgemm_dense_row(tell(a, dtype=np.float64),
                             tconvert.csr_to_dense(
                                 TCSR.from_scipy(b, device="cpu")))
    assert T.values.dtype == torch.float64
    assert np.asarray(J.values).dtype == np.float64
    assert_values_close(T.values, np.asarray(J.values), rtol=F64_RTOL)
    np.testing.assert_allclose(T.values.numpy(), (a @ b).toarray(),
                               rtol=1e-12, atol=1e-12)
