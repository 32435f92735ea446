"""K1 and K3 on the register network (csrc/bitonic.cu ``row_net_rows``,
csrc/sort_common.cuh building block 4), modelled in numpy: which
fragment, packed row and lanes each thread and register of K1 reads
(the expand into registers), K3's compress of sorted rows from memory
(compacted to out_w slots, or in place with holes), and which slots each
thread stores. The sort and the compress's scan are
tests/test_torch_k4_network.py's models, which the .cu follows step for
step; here the whole of K1 (gather -> network from start_kk = 2 * run ->
compress -> the first out_w slots) and of K3 must give the plain
versions' structure exactly at every width 128-16384, every run 1-32 and
lane packing 1, 2 and 4, with values within VALUE_RTOL (1e-5) of
max(1, max|C|) in float32 and F64_RTOL (1e-12) in float64: the network
is not stable, so duplicates are summed in another order. A few cases
also go through the JAX package's launchers (Pallas in interpret mode).

Layout: a row of W slots is held E per thread (E = 8, 16 at W = 16384),
thread t holding slots t*E .. t*E + E - 1. K1's slot p is position
p % run of fragment e = p / run, in packed row e / pack of g at lane
offset (e % pack) * 4 * run + (2 * run for odd e) + p % run, its value
bits run lanes further, its A value avT[e]; a column < 0 and every slot
past ka * run are SENTINEL / 0, by a select."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ia_spgemm_tpu.ops import bitonic as jbt
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
from tests.test_torch_k4_network import (WIDTHS, compress_model,
                                         elems_per_thread, run_network,
                                         scan_model)
from tests.torch_parity import (F64_RTOL, GATHER_RUNS, RUN, VALUE_RTOL,
                                assert_kernel_outputs_match, fragment_gather,
                                gather_inputs, pack_fragments)

SENT = K.SENTINEL
PACKS = [1, 2, 4]


def slot_map(width, run, pack, ka):
    """K1's expand, per (thread, register): the fragment e, the packed
    row e // pack, the column's lane and whether the slot holds a product
    (e < ka). Arrays of shape (T, E)."""
    E = elems_per_thread(width)
    p = np.arange(width).reshape(width // E, E)
    e = p // run
    lane = (e % pack) * 4 * run + (e & 1) * 2 * run + p % run
    return e, e // pack, lane, e < ka


def gather_model(g, avT, width, run, pack, ka):
    """The expand into registers (bitonic.cu load_slots for GatherIn):
    each thread's E slots from its packed rows and lanes, the product
    rounded once in float32. Returns (key, val) (m, width) in the normal
    layout."""
    g, avT = g.numpy(), avT.numpy()
    m = g.shape[1]
    e, ep, lane, live = slot_map(width, run, pack, ka)
    e, ep, lane, live = (x.reshape(-1) for x in (e, ep, lane, live))
    es, eps, lanes = (np.where(live, x, 0) for x in (e, ep, lane))
    rows = np.arange(m)[:, None]
    c = g[eps[None, :], rows, lanes[None, :]]
    bits = g[eps[None, :], rows, lanes[None, :] + run]
    ok = live[None, :] & (c >= 0)
    prod = avT[es[None, :], rows] * bits.view(np.float32)
    key = np.where(ok, c, SENT).astype(np.int64)
    val = np.where(ok, prod, np.float32(0))
    return key, val


def k1_model(g, avT, *, width, run, pack, ka, out_w):
    """K1 as the kernel runs it: gather, the register network from
    start_kk = 2 * run, the register compress, the first out_w slots."""
    key, val = gather_model(g, avT, width, run, pack, ka)
    sk, sv = run_network(key, val.astype(np.float64), 2 * run)
    col, v, nnz = compress_model(sk, sv)
    return col[:, :out_w], v[:, :out_w], nnz


def k3_model(key, val, *, width, out_w, compact):
    """K3 as the kernel runs it: each thread's E slots of the sorted row
    (no sort), the scan; compacted (the first out_w slots) or each
    survivor at its sorted slot with -1 / 0 holes (compact=False)."""
    k = key.numpy().astype(np.int64)
    v = val.numpy().astype(np.float64)
    if compact:
        col, out, nnz = compress_model(k, v)
        return col[:, :out_w], out[:, :out_w], nnz
    kt, emit, sums, _, nnz = scan_model(k, v)
    m = k.shape[0]
    col = np.where(emit, kt, -1).reshape(m, width)
    out = np.where(emit, sums, 0.0).reshape(m, width)
    return col, out, nnz


def assert_model_matches(got, want, rtol):
    """Model (numpy) against the plain version (torch): structure exact,
    values within rtol of max(1, max|C|)."""
    col, val, nnz = got
    pc, pv, pn = (x.numpy() for x in want)
    np.testing.assert_array_equal(nnz, pn[:, 0])
    np.testing.assert_array_equal(col, pc)
    if pv.size:
        scale = max(1.0, float(np.abs(pv).max()))
        assert np.abs(val - pv).max() <= rtol * scale


def _ka(width, run, short):
    return max(1, width // run - (3 if short else 0))


# ---------------------------------------------------------------- K1 expand

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("run", GATHER_RUNS)
def test_k1_slot_map(width, run):
    """Every slot of the row is one (thread, register); where run is a
    multiple of E (the vector gather), a thread's E slots are E
    neighbouring lanes of one fragment, starting on a multiple of 4 (a
    16-byte load from a row of g on the 16-byte grid), and its value bits
    too; below that the thread spans run-slot fragments, each its own
    packed row and lane block."""
    E = elems_per_thread(width)
    for pack in PACKS:
        e, ep, lane, live = slot_map(width, run, pack, width // run)
        assert live.all()
        assert e.shape == (width // E, E)
        if run % E == 0:
            assert (e == e[:, :1]).all()
            assert (np.diff(lane, axis=1) == 1).all()
            assert (lane[:, 0] % 4 == 0).all()
            assert ((lane[:, 0] + run) % 4 == 0).all()
        else:
            assert run < E
            assert len(np.unique(e[0])) == E // run
        # lanes stay within the pack * 4 * run lanes of the packed row
        assert lane.max() + run < pack * 4 * run
        # each (packed row, lane) holds one slot's column
        assert len(set(zip(ep.ravel(), lane.ravel()))) == width


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("run", GATHER_RUNS)
@pytest.mark.parametrize("pack", PACKS)
def test_k1_gather_matches_expand_plain(width, run, pack):
    """The expand into registers gives K._expand_plain's products bit for
    bit, classes full and a few fragments short (padding past ka * run),
    with NaN A values on the empty fragments kept out by the select."""
    for short in (False, True):
        ka = _ka(width, run, short)
        g, avT = fragment_gather(3, ka, run, pack, kind="mixed",
                                 seed=width + run + pack)
        assert np.isnan(avT.numpy()).any()
        key, val = gather_model(g, avT, width, run, pack, ka)
        pk, pv = K._expand_plain(g, avT, ka, run, width, pack)
        np.testing.assert_array_equal(key, pk.numpy())
        assert np.isfinite(val).all()
        np.testing.assert_array_equal(val.view(np.int32),
                                      pv.numpy().view(np.int32))
        if short:
            assert (key[:, ka * run:] == SENT).all()


# ------------------------------------------------------------- K1 whole

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("run", GATHER_RUNS)
def test_k1_model_matches_plain(width, run):
    """Gather -> network from 2 * run -> compress against
    K.expand_sort_compress_plain, the packing cycling 1, 2, 4 with the
    run, classes full and short, out_w the width and off the
    multiple-of-4 grid."""
    pack = PACKS[GATHER_RUNS.index(run) % 3]
    for short, out_w in ((False, width), (True, min(width, 130)),
                         (False, 100)):
        ka = _ka(width, run, short)
        g, avT = fragment_gather(3, ka, run, pack, seed=width * run)
        kw = dict(width=width, run=run, pack=pack, ka=ka, out_w=out_w)
        assert_model_matches(
            k1_model(g, avT, **kw),
            K.expand_sort_compress_plain(g, avT, start_kk=2 * run, **kw),
            VALUE_RTOL)


@pytest.mark.parametrize("width", [128, 512, 2048, 16384])
@pytest.mark.parametrize("kind", ["one_key", "sentinel", "mixed"])
def test_k1_model_adversarial_rows(width, kind):
    """Rows of one duplicate run over every product, rows of SENTINEL only
    (every A value NaN), and a mix."""
    for run in (2, 8):
        ka = width // run
        g, avT = fragment_gather(3, ka, run, 1, kind=kind, seed=run)
        kw = dict(width=width, run=run, pack=1, ka=ka, out_w=width)
        got = k1_model(g, avT, **kw)
        assert_model_matches(
            got, K.expand_sort_compress_plain(g, avT, start_kk=2 * run,
                                              **kw), VALUE_RTOL)
        if kind == "sentinel":
            assert (got[2] == 0).all()
        if kind == "one_key":
            assert (got[2] == 1).all()


# --------------------------------------------------------------------- K3

def _sorted(width, dtype, m=3, seed=0, kind="random"):
    """Sorted rows (K3's input): duplicates, SENTINEL tails, or one key."""
    rng = np.random.default_rng(seed + width)
    k = rng.integers(0, max(4, width // 3), (m, width))
    k[rng.random((m, width)) < 0.1] = SENT
    if kind == "one_key":
        k[:] = 5
    elif kind == "sentinel":
        k[:] = SENT
    v = rng.standard_normal((m, width)).astype(dtype)
    key, val = K.sort_only_plain(torch.from_numpy(k.astype(np.int32)),
                                 torch.from_numpy(v), width=width,
                                 start_kk=2)
    return key, val


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", ["compact", "out_w_100", "out_w_130",
                                  "sparse"])
def test_k3_model_matches_plain(width, dtype, mode):
    """The register compress of sorted rows from memory against
    K.compress_plain: compacted to the width, to out_w = 100 or 130 (off
    the multiple-of-4 grid), and in place (compact=False)."""
    compact = mode != "sparse"
    out_w = (width if mode in ("compact", "sparse")
             else min(width, int(mode.rsplit("_", 1)[1])))
    rtol = F64_RTOL if dtype == np.float64 else VALUE_RTOL
    for kind in ("random", "one_key", "sentinel"):
        key, val = _sorted(width, dtype, kind=kind)
        kw = dict(width=width, out_w=out_w, compact=compact)
        assert_model_matches(k3_model(key, val, **kw),
                             K.compress_plain(key, val, **kw), rtol)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("out_w", [1, 64, 100, 130, 1000, "width"])
def test_stores_cover_exactly_out_w(width, out_w):
    """bitonic.cu store_slots: thread t stores its slots t*E .. t*E + E - 1
    that lie below out_w, by whole quads (16-byte stores) where out_w is
    a multiple of 4 and the row pointers on the 16-byte grid, one by one
    otherwise; either way slots 0 .. out_w - 1 are written once each and
    nothing past them."""
    out_w = width if out_w == "width" else min(out_w, width)
    E = elems_per_thread(width)
    written = np.zeros(width, np.int64)
    vec = out_w % 4 == 0
    for t in range(width // E):
        base = t * E
        if vec:
            for q in range(E // 4):
                if base + 4 * q < out_w:
                    assert base + 4 * q + 4 <= out_w
                    written[base + 4 * q:base + 4 * q + 4] += 1
        else:
            for r in range(E):
                if base + r < out_w:
                    written[base + r] += 1
    assert (written[:out_w] == 1).all() and not written[out_w:].any()


# ------------------------------------------------------- against the JAX

def _jax(fn, *arrays, **kw):
    out = fn(*(jnp.asarray(x.numpy()) for x in arrays), interpret=True,
             **kw)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("ka,pack", [(16, 1), (16, 4), (32, 4)])
def test_k1_model_matches_jax(ka, pack):
    """The K1 model on the flat route's fragment gather (NaN A values on
    empty rows, lanes packed as the pregather packs them) against the
    JAX package's fused kernel (_sort_compress_from_gather)."""
    g, avT, width = gather_inputs(ka)
    gp = pack_fragments(g, pack)
    assert width <= jbt.FUSED_MAX_WIDTH
    want = _jax(jbt._sort_compress_from_gather, gp, avT, width=width,
                run=RUN, ka=ka, start_kk=2 * RUN, pack=pack)
    col, val, nnz = k1_model(gp, avT, width=width, run=RUN, pack=pack,
                             ka=ka, out_w=width)
    assert_kernel_outputs_match(
        (col.astype(np.int32), val.astype(np.float32),
         nnz[:, None].astype(np.int32)), want)


@pytest.mark.parametrize("compact", [True, False])
def test_k3_model_matches_jax(compact):
    """The K3 model on the split route's sorted rows (width 1024, K2's
    output) against the JAX package's K2 + K3, compacted and in place."""
    g, avT, width = gather_inputs(128, seed=3)
    assert width > jbt.FUSED_MAX_WIDTH
    want = _jax(jbt._sort_compress_from_gather, g, avT, width=width,
                run=RUN, ka=128, start_kk=2 * RUN, compact=compact)
    key, val = K.expand_sort_plain(g, avT, ka=128, run=RUN, width=width,
                                   start_kk=2 * RUN)
    col, out, nnz = k3_model(key, val, width=width, out_w=width,
                             compact=compact)
    assert_kernel_outputs_match(
        (col.astype(np.int32), out.astype(np.float32),
         nnz[:, None].astype(np.int32)), want)


def test_k3_model_float64_matches_jax():
    """The K3 model in float64 on sorted rows against the JAX package's
    cols layout (K6 + K3 at width 1024), within F64_RTOL."""
    from tests.torch_parity import cols_inputs
    key, val, width = cols_inputs(128, np.float64, m=40, seed=5)
    assert width > jbt.FUSED_MAX_WIDTH
    want = _jax(jbt._sort_compress_cols, key, val, width=width,
                start_kk=2 * RUN)
    sk, sv = K.sort_only_plain(key, val, width=width, start_kk=2 * RUN)
    col, out, nnz = k3_model(sk, sv, width=width, out_w=width, compact=True)
    assert_kernel_outputs_match(
        (col.astype(np.int32), out, nnz[:, None].astype(np.int32)), want,
        rtol=F64_RTOL)


# ------------------------------------------------- the bound and the cases

@pytest.mark.parametrize("run", GATHER_RUNS)
@pytest.mark.parametrize("pack", PACKS)
def test_gather_bytes_counts_the_lanes_k1_reads(run, pack):
    """bench.kernels.gather_bytes (the bytes K1's bound counts) is what
    the expand reads: every lane of g outside each fragment's 2 * run
    read lanes (the other half, the unused packed slots, the padding to
    128 lanes) may be overwritten without changing K._expand_plain's
    products; overwriting the read lanes changes them; and the read
    lanes of every row plus avT are gather_bytes."""
    from ia_spgemm_tpu_torch.bench.kernels import gather_bytes
    width, m = 512, 3
    ka = width // run - 1
    g, avT = fragment_gather(m, ka, run, pack, seed=run + pack)
    read = np.zeros(g.shape[::2], bool)           # (packed row, lane)
    for e in range(ka):
        off = (e % pack) * 4 * run + (e & 1) * 2 * run
        read[e // pack, off:off + 2 * run] = True
    assert read.sum() == ka * 2 * run
    assert gather_bytes(run, avT) == (read.sum() * m * 4
                                      + avT.numel() * 4)
    want = K._expand_plain(g, avT, ka, run, width, pack)
    rng = np.random.default_rng(run * pack)
    noise = torch.from_numpy(rng.integers(0, 2**31 - 1, g.shape,
                                          dtype=np.int32))
    mask = torch.from_numpy(read)[:, None, :]
    got = K._expand_plain(torch.where(mask, g, noise), avT, ka, run, width,
                          pack)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    got = K._expand_plain(torch.where(mask, noise, g), avT, ka, run, width,
                          pack)
    assert not torch.equal(got[0], want[0])


def test_k1_k3_cases_rehearse_on_cpu():
    """bench.kernels.network_cases (the shapes at which chip_smoke.py
    phase 3 and bench/kernels.py hold K1-K3, K4t, K5, K7a, K7b, K8 and
    K9) at m = 1024 on the CPU: every source gives its cases, and each
    case's wrapper call (the plain version on the CPU) equals its plain
    call: (col, val, nnz) for K1, K3, K4t, K5 and K7b, the sorted (key,
    val) for K2, K8 and K9, the sorted packed keys for K7a."""
    from ia_spgemm_tpu_torch.bench import kernels as KB
    sources = {}
    for c in KB.network_cases(torch.device("cpu"), m=1024):
        sources.setdefault(c.source.split(" run=")[0], set()).add(c.kernel)
        got, want = c.call(), c.plain()
        if c.kernel == "K7a":
            assert torch.equal(got, want)
        else:
            assert len(got) == (2 if c.kernel in KB.SORTED_CASES else 3)
            assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert c.read_bytes > 0
    assert sources == {"headline": {"K1", "K2", "K3"},
                       "skew": {"K1", "K2", "K3", "K4t"},
                       "cant": {"K4t"},
                       "headline flat": {"K2", "K3", "K7a", "K7b"},
                       "headline slabs": {"K3", "K8", "K9"},
                       "headline f64": {"K3"},
                       "skew x band f64": {"K3", "K5"},
                       "headline f64 flat": {"K3"},
                       "wide x band f32 flat": {"K3"}}
