"""K5 and K7b on the register network (csrc/bitonic.cu
``k5_sort_compress`` and ``k7b_compress_packed``, both ``row_net_rows``
of csrc/sort_common.cuh), modelled in numpy.

K5 is K4's network on the cols layout's pre-expanded rows with the first
out_w survivors kept: tests/test_torch_k4_network.py's schedule from
start_kk, its register compress, then the stores of the first out_w
slots. K7b is K3's compress (no sort) of K7a's sorted packed keys, each
key unpacked in registers as it is loaded (``PackedRowsIn``): the column
is the logical x >> 16, the value the bf16 bits (x & 0xFFFF) << 16
widened to float32 exactly, SENTINEL stays SENTINEL with value 0.

Here K5 must give ``sort_compress_plain``'s structure exactly (row
layout, ascending columns, nnz) at widths 128 to FUSED_MAX_WIDTH and
1024, float32 and float64, out_w equal to and below the width; K7b
``compress_packed_plain``'s, compacted and in place, at widths 128-16384;
values within VALUE_RTOL (1e-5) of max(1, max|C|) in float32 and F64_RTOL
(1e-12) in float64, as the network sums duplicates in another order. The
unpack must match ``_unpack_colval`` (the port's and the JAX package's)
bit for bit on negative products, bf16 subnormals, the 0xFFFE cap, column
32767 and all-SENTINEL rows. A few cases also go through the JAX
package's launchers (Pallas in interpret mode) on the same numpy inputs,
pinned to the dtype they compare (tests/conftest.py turns on x64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ia_spgemm_tpu.ops import bitonic as jbt
from ia_spgemm_tpu_torch.bench import kernels as KB
from ia_spgemm_tpu_torch.ops import bitonic as bt
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
from tests.test_torch_k1_k3_network import assert_model_matches, k3_model
from tests.test_torch_k2_k7a_network import pack_model
from tests.test_torch_k4_network import (WIDTHS, _rows, compress_model,
                                         elems_per_thread, run_network)
from tests.torch_parity import (CAP_BITS, F64_RTOL, MAX_COL, RUN,
                                VALUE_RTOL, assert_kernel_outputs_match,
                                cols_inputs, packed_rows, table_inputs)

SENT = K.SENTINEL
# K5's widths: 128 up to the fused boundary (the tests' 256, the
# benchmark's tuned 512) and 1024, where chip_smoke.py holds it beside
# K6 + K3
K5_WIDTHS = sorted({128, 256, 512, bt.FUSED_MAX_WIDTH, 1024})
DTYPES = {"float32": np.float32, "float64": np.float64}


def rtol_of(dtype):
    return F64_RTOL if dtype == np.float64 else VALUE_RTOL


# ------------------------------------------------------------- the models

def k5_model(key, val, *, start_kk, out_w):
    """K5 as the kernel runs it: the network from start_kk, the register
    compress, the first out_w slots. (col, val, nnz)."""
    sk, sv = run_network(np.asarray(key, np.int64),
                         np.asarray(val, np.float64), start_kk)
    col, v, nnz = compress_model(sk, sv)
    return col[:, :out_w], v[:, :out_w], nnz


def unpack_model(p):
    """PackedRowsIn's load_slots: each thread's E keys (one 16-byte load
    per 4), each unpacked in registers on uint32. Returns (key int64,
    val float32), (m, width), in the normal layout."""
    p = np.asarray(p, np.int32)
    m, width = p.shape
    E = elems_per_thread(width)
    x = p.reshape(m, width // E, E).view(np.uint32).astype(np.uint64)
    sent = p.reshape(x.shape) == SENT
    key = np.where(sent, SENT, x >> 16).astype(np.int64)
    bits = np.where(sent, 0, (x & 0xFFFF) << 16).astype(np.uint32)
    return key.reshape(m, width), bits.view(np.float32).reshape(m, width)


def k7b_model(p, *, width, out_w, compact):
    """K7b as the kernel runs it: the unpacking source, then K3's
    compress (the scan, compacted to out_w or each survivor in place)."""
    key, val = unpack_model(p)
    return k3_model(torch.from_numpy(key.astype(np.int32)),
                    torch.from_numpy(val), width=width, out_w=out_w,
                    compact=compact)


# ------------------------------------------------------------- the inputs

def unpack_cases(kind):
    """(col, float32 value) pairs of one kind, as K7a packs them."""
    rng = np.random.default_rng(len(kind))
    n = 64
    cols = rng.integers(0, MAX_COL, n)
    if kind == "negative":
        vals = -np.abs(rng.standard_normal(n)).astype(np.float32) - 1e-3
    elif kind == "subnormal":
        # float32 subnormals: bf16 shares float32's exponent range, so
        # they stay subnormal, rounded to 7 bits of mantissa
        vals = (rng.standard_normal(n) * 1e-39).astype(np.float32)
        vals[:2] = [1e-45, -1e-38]
    elif kind == "cap":
        # bits that round past 0xFFFE (negative NaNs) take the cap
        vals = np.resize(np.array(CAP_BITS, np.uint32), n).view(np.float32)
    elif kind == "max_col":
        cols[:] = MAX_COL
        vals = rng.standard_normal(n).astype(np.float32)
    else:
        vals = rng.standard_normal(n).astype(np.float32) * 1e3
    return cols, vals


# ------------------------------------------------------------------- K5

@pytest.mark.parametrize("width", K5_WIDTHS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("out_w", ["width", "half", 100])
@pytest.mark.parametrize("start_kk", [2, 2 * RUN, 64])
def test_k5_model_matches_plain(width, dtype, out_w, start_kk):
    """The network from start_kk (a full sort, the rows' runs of 8, runs
    of 32) and the compress cut to out_w (the width, half of it, and 100,
    off the multiple-of-4 grid) against sort_compress_plain."""
    dt = DTYPES[dtype]
    out_w = {"width": width, "half": width // 2}.get(out_w, out_w)
    k, v = _rows(width, start_kk, seed=out_w)
    key, val = torch.from_numpy(k.astype(np.int32)), torch.from_numpy(
        v.astype(dt))
    got = k5_model(key.numpy(), val.numpy(), start_kk=start_kk, out_w=out_w)
    want = K.sort_compress_plain(key, val, width=width, start_kk=start_kk,
                                 out_w=out_w)
    assert_model_matches(got, want, rtol_of(dt))
    assert got[0].shape == (3, out_w)
    for row, nnz in zip(got[0], got[2]):
        # the first min(nnz, out_w) survivors in ascending columns, then -1
        n = min(nnz, out_w)
        assert (np.diff(row[:n]) > 0).all() and (row[:n] >= 0).all()
        assert (row[n:] == -1).all()


@pytest.mark.parametrize("ka", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("out_width", [None, 100])
def test_k5_model_on_the_torch_expand(ka, dtype, out_width):
    """The cols layout's own rows (the torch _expand_ell, runs of 8, four
    padded class rows with NaN A values that must come out empty), widths
    128-1024, against the plain version."""
    dt = DTYPES[dtype]
    key, val, width = cols_inputs(ka, dt, m=40, seed=ka)
    out_w = width if out_width is None else min(out_width, width)
    got = k5_model(key.numpy(), val.numpy(), start_kk=2 * RUN, out_w=out_w)
    want = K.sort_compress_plain(key, val, width=width, start_kk=2 * RUN,
                                 out_w=out_w)
    assert_model_matches(got, want, rtol_of(dt))
    assert (got[2][-4:] == 0).all() and (got[0][-4:] == -1).all()


@pytest.mark.parametrize("width", K5_WIDTHS)
@pytest.mark.parametrize("kind", ["one_key", "sentinel", "few_keys"])
@pytest.mark.parametrize("out_w", [1, "width"])
def test_k5_model_adversarial_rows(width, kind, out_w):
    """Rows of one key (one run over the whole row), of SENTINEL only,
    and of three keys (runs straddling every register, lane and warp
    boundary), cut to one slot and to the width."""
    out_w = width if out_w == "width" else out_w
    k, v = _rows(width, 2, key_range=3)
    if kind == "one_key":
        k[:] = 5
    elif kind == "sentinel":
        k[:] = SENT
    key, val = torch.from_numpy(k.astype(np.int32)), torch.from_numpy(v)
    got = k5_model(k, v, start_kk=2, out_w=out_w)
    assert_model_matches(got, K.sort_compress_plain(
        key, val, width=width, start_kk=2, out_w=out_w), F64_RTOL)
    want_nnz = {"one_key": 1, "sentinel": 0}.get(kind)
    if want_nnz is not None:
        assert (got[2] == want_nnz).all()


# ------------------------------------------------------------------ K7b

@pytest.mark.parametrize("kind", ["negative", "subnormal", "cap", "max_col",
                                  "random"])
def test_unpack_matches_unpack_colval(kind):
    """PackedRowsIn's unpack of K7a's packed keys against the port's and
    the JAX package's _unpack_colval, bit for bit, with a row of
    SENTINEL only beside them (column SENTINEL, value +0)."""
    cols, vals = unpack_cases(kind)
    p = np.stack([pack_model(cols, vals).astype(np.int32),
                  np.full(cols.size, SENT, np.int32)])
    assert not (p[0] == SENT).any()
    key, val = unpack_model(p)
    tk, tv = K._unpack_colval(torch.from_numpy(p))
    jk, jv = jbt._unpack_colval(jnp.asarray(p, dtype=jnp.int32))
    for k2, v2 in ((tk.numpy(), tv.numpy()), (np.asarray(jk),
                                              np.asarray(jv))):
        np.testing.assert_array_equal(key, k2)
        np.testing.assert_array_equal(val.view(np.int32),
                                      np.asarray(v2).view(np.int32))
    assert (key[1] == SENT).all() and (val[1].view(np.int32) == 0).all()
    np.testing.assert_array_equal(key[0], cols)
    bits = val[0].view(np.uint32)
    if kind == "negative":
        assert (bits >> 31 == 1).all()
    elif kind == "subnormal":
        mag = np.abs(val[0])
        assert ((mag < np.float32(2.0**-126)) & (bits & 0x7FFFFFFF > 0)).any()
        assert (mag < np.float32(2.0**-126)).all()
    elif kind == "cap":
        assert ((bits >> 16) == 0xFFFE).any()
        assert ((bits >> 16) <= 0xFFFE).all()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mode", ["compact", "out_w_100", "in_place"])
@pytest.mark.parametrize("kind", ["random", "cancel", "sentinel"])
def test_k7b_model_matches_plain(width, mode, kind):
    """The unpacking source into K3's compress against
    compress_packed_plain: compacted to the width and to 100 slots (off
    the multiple-of-4 grid), and in place (compact=False); duplicate
    columns whose bf16 values cancel come out as survivors of value 0."""
    compact = mode != "in_place"
    out_w = 100 if mode == "out_w_100" else width
    p = packed_rows(width, kind=kind)
    kw = dict(width=width, out_w=out_w, compact=compact)
    got = k7b_model(p.numpy(), **kw)
    assert_model_matches(got, K.compress_packed_plain(p, **kw), VALUE_RTOL)
    if kind == "cancel":
        assert (got[2] == width // 2).all()
        assert not got[1].any()
    if kind == "sentinel":
        assert (got[2] == 0).all() and (got[0] == -1).all()


# ------------------------------------------------- the bench's cases

def test_k5_k7b_cases_count_their_bytes():
    """bench.kernels' K5 and K7b cases: K5 on pre-expanded rows up to
    FUSED_MAX_WIDTH (rows read once, torch.sort beside it), none above;
    K7b on sorted packed keys, in place and compacted (the keys read
    once); each call equals its plain version on the CPU."""
    key, val, width = cols_inputs(16, np.float64, m=20)
    assert width <= bt.FUSED_MAX_WIDTH
    (c,) = KB._cols_cases("src", key, val, width=width, start_kk=2 * RUN,
                          out_w=width)
    assert c.kernel == "K5" and c.read_bytes == key.numel() * 12
    got, want = c.call(), c.plain()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(c.library()[0], torch.sort(key, dim=1).values)
    k2, v2, w2 = cols_inputs(128, np.float64, m=20)
    assert w2 > bt.FUSED_MAX_WIDTH
    assert {c.kernel for c in KB._cols_cases(
        "src", k2, v2, width=w2, start_kk=2 * RUN, out_w=w2)} == {"K3"}
    p = packed_rows(1024)
    cases = list(KB._k7b_cases("src", "shape", p, 1024))
    assert [c.shape for c in cases] == ["shape compact=False",
                                        "shape compact=True"]
    for c in cases:
        assert c.kernel == "K7b" and c.read_bytes == p.numel() * 4
        got, want = c.call(), c.plain()
        assert all(torch.equal(x, y) for x, y in zip(got, want))


# ----------------------------------------------------- against the JAX

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("out_width", [None, 100])
def test_k5_model_matches_jax(dtype, out_width):
    """The K5 model on the torch expand's rows (width 256, runs of 8)
    against the JAX package's fused kernel (_sort_compress_cols below
    FUSED_MAX_WIDTH, _fused_kernel_t), the JAX arrays in the dtype
    compared."""
    dt = DTYPES[dtype]
    key, val, width = cols_inputs(32, dt, m=60, seed=3)
    assert width <= jbt.FUSED_MAX_WIDTH
    want = jbt._sort_compress_cols(
        jnp.asarray(key.numpy(), dtype=jnp.int32),
        jnp.asarray(val.numpy(), dtype=jnp.dtype(dtype)), width=width,
        start_kk=2 * RUN, interpret=True, out_width=out_width)
    assert np.asarray(want[1]).dtype == dt
    out_w = width if out_width is None else out_width
    col, out, nnz = k5_model(key.numpy(), val.numpy(), start_kk=2 * RUN,
                             out_w=out_w)
    assert_kernel_outputs_match(
        (col.astype(np.int32), out.astype(dt), nnz[:, None].astype(np.int32)),
        tuple(np.asarray(x) for x in want), rtol=rtol_of(dt))


@pytest.mark.parametrize("ka,compact", [(16, True), (32, False),
                                        (128, True), (128, False)])
def test_k7b_model_matches_jax(ka, compact):
    """The K7b model on K7a's sorted keys (the port's plain K7a, bit for
    bit the JAX package's) against the JAX packed pipeline
    (_sort_compress_from_gather_packed: K7a then _compress_kernel_packed),
    compacted and in place, widths 128-1024."""
    table, rT, avT, width = table_inputs(ka, m=150, seed=ka)
    g = K.table_gather(table, rT)
    want = jbt._sort_compress_from_gather_packed(
        jnp.asarray(g.numpy(), dtype=jnp.int32),
        jnp.asarray(avT.numpy(), dtype=jnp.float32), width=width, run=RUN,
        ka=ka, start_kk=2 * RUN, interpret=True, compact=compact)
    p = K.expand_sort_packed_plain(table, rT, avT, ka=ka, run=RUN,
                                   width=width, start_kk=2 * RUN)
    col, out, nnz = k7b_model(p.numpy(), width=width, out_w=width,
                              compact=compact)
    assert_kernel_outputs_match(
        (col.astype(np.int32), out.astype(np.float32),
         nnz[:, None].astype(np.int32)),
        tuple(np.asarray(x) for x in want))
