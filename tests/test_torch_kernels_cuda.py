"""PyTorch port, the CUDA kernels K1-K13 (K3-K6 and K11 in float32 and
float64) against their plain PyTorch versions on the card, and the ring
through K13, in one process and across two worker processes sharing the
card (marked `cuda`; they skip without a GPU; the several-card K13 test
also skips with one card).

This file imports no jax, so it runs on the GPU machine, where jax is
not installed and tests/conftest.py (which imports jax) must be left out:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest \\
        -o addopts="" -m cuda -q
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ia_spgemm_tpu_torch.bench.headline import build_matrix
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
from ia_spgemm_tpu_torch.ops import dense_row_kernels as DK
from ia_spgemm_tpu_torch.ops import hash_kernels as HK
from ia_spgemm_tpu_torch.ops import slab_kernels as SK
from ia_spgemm_tpu_torch.parallel import rdma_ring as RR
from tests.torch_parity import (GATHER_CASES, GATHER_RUNS, RUN,
                                assert_dd_outputs_match,
                                assert_kernel_outputs_match,
                                assert_tables_match, assert_values_close,
                                cols_inputs, ell_pair, fragment_gather,
                                gather_inputs, ill_conditioned,
                                pack_fragments, packed_rows,
                                slab_fragments, slab_operands,
                                table_fragments,
                                table_inputs, tell, value_rtol)


def _planned(make, **over):
    """The port's slab plan of make() @ make(): ((table, mt, avT, lrT),
    kw) on the host."""
    def get():
        _, ops, kw = slab_operands(make(), **over)
        return ops, kw
    return get


def _synthetic(width, run, short=False):
    """tests.torch_parity.slab_fragments at (width, run): 257 slabs, the
    last two padding, fill-row slots with NaN A values and junk local
    rows, keys up to within 64 of 2^31 - 1; `short`: three fragment
    slots fewer than width / run (slots past ka * run)."""
    def get():
        ka = width // run - (3 if short else 0)
        table, mt, avT, lrT, n = slab_fragments(257, ka, run,
                                                seed=width + run + short)
        return (table, mt, avT, lrT), dict(ka=ka, run=run, width=width,
                                           n=n, start_kk=2 * run)
    return get


# slab-kernel inputs: the planner's (the headline plans width 1024, the
# others 512), and synthetic slabs at both slab widths and runs 8 and 32,
# a short one, and widths 128 / 256 (several slabs share a block)
SLAB_CASES = {"headline2048": _planned(lambda: build_matrix(m=2048)),
              "headline2048_run16": _planned(lambda: build_matrix(m=2048),
                                             run=16),
              "ill_conditioned": _planned(ill_conditioned),
              **{f"near_max_w{w}_r{r}": _synthetic(w, r)
                 for w in (512, 1024) for r in (8, 32)},
              "near_max_w1024_r8_short": _synthetic(1024, 8, short=True),
              "near_max_w256_r8": _synthetic(256, 8),
              "near_max_w128_r32": _synthetic(128, 32)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ka,pack,out_width", GATHER_CASES)
def test_k1_k2_k3_kernels_match_plain(cuda_device, ka, pack, out_width):
    g, avT, width = gather_inputs(ka)
    gp = pack_fragments(g, pack).to(cuda_device)
    avT = avT.to(cuda_device)
    out_w = width if out_width is None else min(out_width, width)
    kw = dict(ka=ka, run=RUN, width=width, start_kk=2 * RUN, pack=pack)
    n1 = K.expand_sort_compress.launches
    assert_kernel_outputs_match(
        K.expand_sort_compress(gp, avT, out_w=out_w, **kw),
        K.expand_sort_compress_plain(gp, avT, out_w=out_w, **kw))
    assert K.expand_sort_compress.launches == n1 + 1
    key, val = K.expand_sort(gp, avT, **kw)
    pkey, pval = K.expand_sort_plain(gp, avT, **kw)
    assert torch.equal(key, pkey)
    for compact in (True, False):
        ow = out_w if compact else width
        assert_kernel_outputs_match(
            K.compress(key, val, width=width, out_w=ow, compact=compact),
            K.compress_plain(pkey, pval, width=width, out_w=ow,
                             compact=compact))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2048, 8192, 16384])
def test_k4_kernel_matches_plain(cuda_device, width):
    """Full sort (start_kk=2) of random keys with SENTINEL tails; 16384
    needs 128 KB of dynamic shared memory."""
    gen = torch.Generator(device=cuda_device).manual_seed(width)
    key = torch.randint(0, 4000, (48, width), dtype=torch.int32,
                        device=cuda_device, generator=gen)
    key[::5, width // 3:] = K.SENTINEL
    val = torch.randn((48, width), device=cuda_device, generator=gen)
    assert_kernel_outputs_match(
        K.sort_compress_rows(key, val, width=width, start_kk=2),
        K.sort_compress_rows_plain(key, val, width=width, start_kk=2))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2048, 16384])
def test_k4_k3_float64_kernels_match_plain(cuda_device, width):
    """K4's float64 instance (16384 needs 192 KB of shared memory), then
    K3's on the plain-sorted rows, compacted and not."""
    gen = torch.Generator(device=cuda_device).manual_seed(width)
    key = torch.randint(0, 4000, (48, width), dtype=torch.int32,
                        device=cuda_device, generator=gen)
    key[::5, width // 3:] = K.SENTINEL
    val = torch.randn((48, width), device=cuda_device, generator=gen,
                      dtype=torch.float64)
    n4 = K.sort_compress_rows.launches
    got = K.sort_compress_rows(key, val, width=width, start_kk=2)
    assert K.sort_compress_rows.launches == n4 + 1
    assert got[1].dtype == torch.float64
    assert_kernel_outputs_match(
        got, K.sort_compress_rows_plain(key, val, width=width, start_kk=2),
        rtol=value_rtol(val))
    sk, sv = K.sort_only_plain(key, val, width=width, start_kk=2)
    for compact in (True, False):
        assert_kernel_outputs_match(
            K.compress(sk, sv, width=width, out_w=width, compact=compact),
            K.compress_plain(sk, sv, width=width, out_w=width,
                             compact=compact), rtol=value_rtol(val))


K4_WIDTHS = [128, 256, 512, 1024, 2048, 4096, 8192, 16384]


def _k4_rows(m, width, start_kk, dtype, seed=0, kind="random"):
    """Rows in the register network's input layout for start_kk (sorted
    runs of start_kk / 2 slots, ascending and descending in turn), built
    with numpy: random keys with duplicates and SENTINEL slots, or one
    key, or SENTINEL only, or duplicate runs that straddle register (8 /
    16 slots), warp (256 / 512) and block boundaries, or a row already
    sorted."""
    rng = np.random.default_rng(seed + width)
    v = rng.standard_normal((m, width)).astype(dtype)
    if kind == "one_key":
        k = np.full((m, width), 5, np.int64)
    elif kind == "sentinel":
        k = np.full((m, width), K.SENTINEL, np.int64)
    elif kind == "straddling":
        lens = [11, 4, 261, 1, 7, 517, 3]
        ks = np.concatenate([np.full(n, i) for i, n in
                             enumerate(lens * width)])[:width]
        k = np.tile(ks, (m, 1))
        k[:, width - width // 5:] = K.SENTINEL
        k = np.ascontiguousarray(k[:, rng.permutation(width)])
    elif kind == "sorted":
        k = np.sort(rng.integers(0, max(4, width // 3), (m, width)), axis=1)
    else:
        k = rng.integers(0, max(4, width // 3), (m, width))
        k[rng.random((m, width)) < 0.1] = K.SENTINEL
    half = start_kk // 2
    if half > 1:
        kr = k.reshape(m, width // half, half)
        order = np.argsort(kr, axis=2, kind="stable")
        order[:, 1::2] = order[:, 1::2, ::-1]
        k = np.take_along_axis(kr, order, 2).reshape(m, width)
        v = np.take_along_axis(v.reshape(m, width // half, half), order,
                               2).reshape(m, width)
    return torch.from_numpy(k.astype(np.int32)), torch.from_numpy(v)


def _check_k4(key, val, width, start_kk):
    n4 = K.sort_compress_rows.launches
    got = K.sort_compress_rows(key, val, width=width, start_kk=start_kk)
    assert K.sort_compress_rows.launches == n4 + 1
    assert got[1].dtype == val.dtype
    assert_kernel_outputs_match(
        got, K.sort_compress_rows_plain(key, val, width=width,
                                        start_kk=start_kk),
        rtol=value_rtol(val))


def _check_k6(key, val, width, start_kk):
    """K6: the sorted keys equal the plain version's; values within a
    duplicate run may sit in another order, so the run sums (the plain
    compress of each) are compared."""
    n6 = K.sort_only.launches
    sk, sv = K.sort_only(key, val, width=width, start_kk=start_kk)
    assert K.sort_only.launches == n6 + 1
    assert sv.dtype == val.dtype
    pk, pv = K.sort_only_plain(key, val, width=width, start_kk=start_kk)
    assert torch.equal(sk, pk)
    assert_kernel_outputs_match(
        K.compress_plain(sk, sv, width=width, out_w=width),
        K.compress_plain(pk, pv, width=width, out_w=width),
        rtol=value_rtol(val))


def _check_k5(key, val, width, start_kk, out_w=None):
    """K5 (K4's network under its own symbol) with its output cut to
    out_w slots: three quarters of the row plus one (off the 4-slot
    grid, so the stores go slot by slot) unless given."""
    out_w = width * 3 // 4 + 1 if out_w is None else out_w
    n5 = K.sort_compress.launches
    got = K.sort_compress(key, val, width=width, start_kk=start_kk,
                          out_w=out_w)
    assert K.sort_compress.launches == n5 + 1
    assert got[1].dtype == val.dtype and got[0].shape[1] == out_w
    assert_kernel_outputs_match(
        got, K.sort_compress_plain(key, val, width=width, start_kk=start_kk,
                                   out_w=out_w), rtol=value_rtol(val))


NET_CHECKS = {"K4": _check_k4, "K5": _check_k5, "K6": _check_k6}


@pytest.mark.cuda
@pytest.mark.parametrize("width", K4_WIDTHS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("start", ["full", "runs"])
def test_k4_network_every_width(cuda_device, width, dtype, start):
    """The register network at every width, both value types, from
    start_kk 2 (a full sort) and 2 * run (alternating runs of 8)."""
    start_kk = 2 if start == "full" else 2 * RUN
    key, val = _k4_rows(48, width, start_kk, dtype)
    _check_k4(key.to(cuda_device), val.to(cuda_device), width, start_kk)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(NET_CHECKS))
@pytest.mark.parametrize("width", [128, 512, 1024, 8192])
@pytest.mark.parametrize("m", [1, 20, 131, 133, 300])
def test_k4_row_counts(cuda_device, width, m, kernel):
    """K4 and K6 (the register network with and without the compress):
    row counts below and above the card's 132 SMs, and the last block's
    padding rows where rows share a block (width 128: 8 a block)."""
    key, val = _k4_rows(m, width, 2, np.float32, seed=m)
    NET_CHECKS[kernel](key.to(cuda_device), val.to(cuda_device), width, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(NET_CHECKS))
@pytest.mark.parametrize("width", [128, 512, 1024, 16384])
@pytest.mark.parametrize("kind", ["one_key", "sentinel", "straddling",
                                  "sorted"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k4_adversarial_rows(cuda_device, width, kind, dtype, kernel):
    key, val = _k4_rows(5, width, 2, dtype, kind=kind)
    NET_CHECKS[kernel](key.to(cuda_device), val.to(cuda_device), width, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(NET_CHECKS))
@pytest.mark.parametrize("width", [1024, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_rows_off_the_vector_grid(cuda_device, dtype, width, kernel):
    """Rows starting 4 (keys) or 8 (values) bytes past a 16-byte boundary
    take the scalar loads (K4 and K6)."""
    m = 7
    key0, val0 = _k4_rows(m, width, 2, np.float64)
    kbuf = torch.empty(m * width + 1, dtype=torch.int32, device=cuda_device)
    vbuf = torch.empty(m * width + 1, dtype=dtype, device=cuda_device)
    key = kbuf[1:].view(m, width)
    val = vbuf[1:].view(m, width)
    key.copy_(key0)
    val.copy_(val0)
    assert key.data_ptr() % 16 and val.data_ptr() % 16
    NET_CHECKS[kernel](key, val, width, 2)


# ---- K1 and K3 on the register network

def _check_k1(g, avT, *, ka, run, width, pack, out_w):
    kw = dict(ka=ka, run=run, width=width, start_kk=2 * run, out_w=out_w,
              pack=pack)
    n1 = K.expand_sort_compress.launches
    got = K.expand_sort_compress(g, avT, **kw)
    assert K.expand_sort_compress.launches == n1 + 1
    assert_kernel_outputs_match(got,
                                K.expand_sort_compress_plain(g, avT, **kw))


def _k1_case(dev, m, width, run, pack, *, short=False, kind="random",
             seed=0, lanes=None):
    """A K1 input on the card: ka = width / run fragments, or a few fewer
    (slots past ka * run are padding)."""
    ka = max(1, width // run - (3 if short else 0))
    g, avT = fragment_gather(m, ka, run, pack, kind=kind, seed=seed,
                             lanes=lanes)
    return g.to(dev), avT.to(dev), ka


@pytest.mark.cuda
@pytest.mark.parametrize("width", K4_WIDTHS)
@pytest.mark.parametrize("run", GATHER_RUNS)
@pytest.mark.parametrize("short", [False, True])
def test_k1_network_every_width_and_run(cuda_device, width, run, short):
    """K1 at every width and every fragment run: run 8 and 32 take the
    vector gather (E slots of one fragment), runs below E (and run 8 at
    16384, E = 16) slot by slot; classes full or a few fragments short;
    lane packing 1, 2 and 4; NaN A values on empty fragments."""
    pack = 4 if width >= 4096 else (1, 2, 4)[GATHER_RUNS.index(run) % 3]
    m = 37 if width <= 2048 else 3
    g, avT, ka = _k1_case(cuda_device, m, width, run, pack, short=short,
                          seed=width + run)
    _check_k1(g, avT, ka=ka, run=run, width=width, pack=pack, out_w=width)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 512, 1024])
@pytest.mark.parametrize("m", [1, 13, 133])
@pytest.mark.parametrize("out_w", ["width", 100, 130, 64])
def test_k1_out_w_and_row_counts(cuda_device, width, m, out_w):
    """out_w caps off the multiple-of-4 grid (scalar stores of rows that
    start off the 16-byte grid) and on it, and row counts that leave
    padding rows in the last block (8 rows a block at 128, 4 at 256)."""
    out_w = width if out_w == "width" else min(out_w, width)
    g, avT, ka = _k1_case(cuda_device, m, width, 8, 4, seed=m)
    _check_k1(g, avT, ka=ka, run=8, width=width, pack=4, out_w=out_w)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 512, 2048, 16384])
@pytest.mark.parametrize("kind", ["one_key", "sentinel", "mixed"])
@pytest.mark.parametrize("run", [4, 8, 32])
def test_k1_adversarial_rows(cuda_device, width, kind, run):
    """Rows of one long duplicate run (every product column 5), rows of
    SENTINEL only (every A value NaN), and a mix."""
    m = 9 if width <= 2048 else 3
    g, avT, ka = _k1_case(cuda_device, m, width, run, 1, kind=kind)
    _check_k1(g, avT, ka=ka, run=run, width=width, pack=1, out_w=width)


@pytest.mark.cuda
@pytest.mark.parametrize("run", [8, 32])
def test_k1_gather_off_the_vector_grid(cuda_device, run):
    """g starting 4 bytes past a 16-byte boundary, and 130 lanes a row
    (not a multiple of 4): the scalar gather."""
    width, m = 512, 11
    for lanes, offset in ((128, 1), (130, 0)):
        g0, avT, ka = _k1_case(cuda_device, m, width, run, 1, lanes=lanes)
        buf = torch.empty(g0.numel() + offset, dtype=torch.int32,
                          device=cuda_device)
        g = buf[offset:].view(g0.shape)
        g.copy_(g0)
        assert (g.data_ptr() % 16 != 0) == (offset == 1)
        _check_k1(g, avT, ka=ka, run=run, width=width, pack=1, out_w=width)


def _check_k3(key, val, width, out_w, compact):
    n3 = K.compress.launches
    got = K.compress(key, val, width=width, out_w=out_w, compact=compact)
    assert K.compress.launches == n3 + 1
    assert got[1].dtype == val.dtype
    assert_kernel_outputs_match(
        got, K.compress_plain(key, val, width=width, out_w=out_w,
                              compact=compact), rtol=value_rtol(val))


def _sorted_rows(dev, m, width, dtype, kind="random", seed=0):
    key, val = _k4_rows(m, width, 2, dtype, seed=seed, kind=kind)
    key, val = K.sort_only_plain(key, val, width=width, start_kk=2)
    return key.to(dev), val.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("width", K4_WIDTHS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("compact", [True, False])
def test_k3_network_every_width(cuda_device, width, dtype, compact):
    """K3 (the register compress without a sort) at every width, both
    value types, compacted and in place (compact=False)."""
    key, val = _sorted_rows(cuda_device, 37 if width <= 2048 else 5, width,
                            dtype, seed=width)
    _check_k3(key, val, width, width, compact)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 1024, 4096])
@pytest.mark.parametrize("out_w", [100, 130, 64, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k3_out_w_off_the_grid(cuda_device, width, out_w, dtype):
    """Compacted rows cut to out_w slots, out_w off the multiple-of-4
    grid (rows start off the 16-byte grid) or on it."""
    key, val = _sorted_rows(cuda_device, 21, width, dtype, seed=out_w)
    _check_k3(key, val, width, min(out_w, width), True)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 1024])
@pytest.mark.parametrize("m", [1, 13, 131, 133])
@pytest.mark.parametrize("compact", [True, False])
def test_k3_row_counts(cuda_device, width, m, compact):
    key, val = _sorted_rows(cuda_device, m, width, np.float32, seed=m)
    _check_k3(key, val, width, width, compact)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 512, 1024, 16384])
@pytest.mark.parametrize("kind", ["one_key", "sentinel", "straddling",
                                  "sorted"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("compact", [True, False])
def test_k3_adversarial_rows(cuda_device, width, kind, dtype, compact):
    """Rows of one key (one long duplicate run), of SENTINEL only, with
    runs straddling register, warp and block boundaries, and sorted
    rows with many short runs."""
    key, val = _sorted_rows(cuda_device, 5, width, dtype, kind=kind)
    _check_k3(key, val, width, width, compact)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("compact", [True, False])
def test_k3_rows_off_the_vector_grid(cuda_device, dtype, compact):
    """Rows starting 4 (keys) or 8 (values) bytes past a 16-byte
    boundary take the scalar loads."""
    m, width = 7, 1024
    key0, val0 = _sorted_rows(cuda_device, m, width, np.float64)
    kbuf = torch.empty(m * width + 1, dtype=torch.int32, device=cuda_device)
    vbuf = torch.empty(m * width + 1, dtype=dtype, device=cuda_device)
    key = kbuf[1:].view(m, width)
    val = vbuf[1:].view(m, width)
    key.copy_(key0)
    val.copy_(val0)
    assert key.data_ptr() % 16 and val.data_ptr() % 16
    _check_k3(key, val, width, width, compact)


def _in_runs(key, val, start_kk):
    """Rows re-laid into sorted runs of start_kk / 2 slots, ascending and
    descending in turn (any row is valid input for start_kk = 2)."""
    if start_kk <= 2 * RUN:
        return key, val
    m, width = key.shape
    half = start_kk // 2
    kr = key.reshape(m, width // half, half)
    order = torch.sort(kr, dim=2, stable=True).indices
    order[:, 1::2] = order[:, 1::2].flip(2)
    return (torch.gather(kr, 2, order).reshape(m, width).contiguous(),
            torch.gather(val.reshape(m, width // half, half), 2, order)
            .reshape(m, width).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("start_kk", [2, 2 * RUN, 64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ka,out_width", [(32, None), (32, 128),
                                          (64, None), (128, None),
                                          (128, 300)])
def test_k5_k6_k3_kernels_match_plain(cuda_device, dtype, ka, out_width,
                                      start_kk):
    """The cols layout on the torch expand's rows (padded class rows
    included): K5 and K6 at width 256 (ka 32), 512 (ka 64) and 1024 (ka
    128), from start_kk 2 (a full sort), 16 (the rows' runs of 8) and 64
    (re-laid into runs of 32); K5 with and without an out_w cap; K6's
    sorted keys equal the plain version's, its run sums and K3 on them
    within the values' tolerance."""
    key, val, width = cols_inputs(ka, dtype)
    key, val = _in_runs(key.to(cuda_device), val.to(cuda_device), start_kk)
    out_w = width if out_width is None else min(out_width, width)
    kw = dict(width=width, start_kk=start_kk)
    rtol = value_rtol(val)
    n5 = K.sort_compress.launches
    got = K.sort_compress(key, val, out_w=out_w, **kw)
    assert K.sort_compress.launches == n5 + 1
    assert got[1].dtype == val.dtype and got[0].shape[1] == out_w
    assert_kernel_outputs_match(
        got, K.sort_compress_plain(key, val, out_w=out_w, **kw), rtol=rtol)
    _check_k6(key, val, width, start_kk)
    sk, sv = K.sort_only(key, val, **kw)
    pk, pv = K.sort_only_plain(key, val, **kw)
    assert_kernel_outputs_match(
        K.compress(sk, sv, width=width, out_w=out_w),
        K.compress_plain(pk, pv, width=width, out_w=out_w), rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("ka", [16, 64])
@pytest.mark.parametrize("out_w", [1, 100, "half"])
def test_k5_float64_capped(cuda_device, ka, out_w):
    """K5 in float64 on the torch expand's rows at widths 128 (ka 16;
    8 rows a 128-thread block) and 512 (ka 64; a block a row), its output
    cut below the width."""
    key, val, width = cols_inputs(ka, np.float64, m=300, seed=ka)
    out_w = width // 2 if out_w == "half" else out_w
    _check_k5(key.to(cuda_device), val.to(cuda_device), width, 2 * RUN,
              out_w)


@pytest.mark.cuda
@pytest.mark.parametrize("width", K4_WIDTHS)
@pytest.mark.parametrize("kind", ["random", "cancel", "sentinel"])
@pytest.mark.parametrize("compact", [True, False])
def test_k7b_every_width(cuda_device, width, kind, compact):
    """K7b on sorted packed keys at every width, compacted and in place:
    random rows, rows of duplicate columns whose bf16 values cancel (each
    column a survivor of value 0), and SENTINEL-only rows."""
    p = packed_rows(width, m=37 if width <= 2048 else 5, kind=kind,
                    seed=width).to(cuda_device)
    got = _check_k7b(p, width, width, compact)
    if kind == "cancel":
        assert (got[2] == width // 2).all() and not got[1].any()


def _check_k7b(p, width, out_w, compact):
    n7 = K.compress_packed.launches
    got = K.compress_packed(p, width=width, out_w=out_w, compact=compact)
    assert K.compress_packed.launches == n7 + 1
    assert_kernel_outputs_match(
        got, K.compress_packed_plain(p, width=width, out_w=out_w,
                                     compact=compact))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 1024])
@pytest.mark.parametrize("m", [1, 13, 131, 133])
@pytest.mark.parametrize("compact", [True, False])
def test_k7b_row_counts(cuda_device, width, m, compact):
    """Row counts below and above the card's SMs, and the last block's
    padding rows where rows share a block."""
    _check_k7b(packed_rows(width, m=m, seed=m).to(cuda_device), width,
               width, compact)


@pytest.mark.cuda
@pytest.mark.parametrize("out_w", [1, 100, 512])
def test_k7b_out_w_and_off_the_grid(cuda_device, out_w):
    """Compacted rows cut to out_w, from keys on the 16-byte grid and 4
    bytes past it (the slot-by-slot loads)."""
    m, width = 7, 1024
    p0 = packed_rows(width, m=m, seed=out_w).to(cuda_device)
    buf = torch.empty(m * width + 1, dtype=torch.int32, device=cuda_device)
    p1 = buf[1:].view(m, width)
    p1.copy_(p0)
    assert p1.data_ptr() % 16
    for p in (p0, p1):
        _check_k7b(p, width, out_w, True)


@pytest.mark.cuda
def test_k5_k7b_profiler_names(cuda_device):
    """torch.profiler sees K5's and K7b's launches under their own
    symbols (bench.kernels.PROFILE_NAMES), K5's apart from K4's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ia_spgemm_tpu_torch.bench.kernels import PROFILE_NAMES
    key, val, width = cols_inputs(32, np.float64)
    key, val = key.to(cuda_device), val.to(cuda_device)
    p = packed_rows(1024).to(cuda_device)
    calls = {"K5": lambda: K.sort_compress(key, val, width=width,
                                           start_kk=2 * RUN, out_w=width),
             "K7b": lambda: K.compress_packed(p, width=1024, out_w=1024,
                                              compact=False)}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA}
        assert any(PROFILE_NAMES[name] in n for n in names), names
        assert not any("k4_sort_compress_rows" in n for n in names), names


def _slab_inputs(name, device, unaligned=False):
    """A slab case's (table, mt, avT, lrT) on `device`; `unaligned` puts
    the table 4 bytes off the 16-byte grid (K8 / K9 then load it slot by
    slot)."""
    ops, kw = SLAB_CASES[name]()
    table, *rest = (t.to(device) for t in ops)
    if unaligned:
        buf = torch.empty(table.numel() + 1, dtype=table.dtype,
                          device=device)
        buf[1:] = table.reshape(-1)
        table = buf[1:].view(table.shape)
        assert table.data_ptr() % 16 == 4
    return (table, *rest), kw


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SLAB_CASES))
def test_k8_k3_slab_kernels_match_plain(cuda_device, name):
    """K8 sorts every slab's keys exactly as the plain version; values
    within a duplicate run may sit in another order, so the run sums
    (K3 against its plain version) are compared."""
    args, kw = _slab_inputs(name, cuda_device)
    _check_k8(args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["near_max_w1024_r32", "near_max_w512_r8",
                                  "near_max_w128_r32"])
def test_k8_k9_table_off_the_grid(cuda_device, name):
    """A table 4 bytes off the 16-byte grid: K8 and K9 load it slot by
    slot and still match their plain versions."""
    args, kw = _slab_inputs(name, cuda_device, unaligned=True)
    _check_k8(args, kw)
    _check_k9(args, kw)


def _check_k8(args, kw):
    w = kw["width"]
    n8 = SK.expand_sort_lr.launches
    key, val = SK.expand_sort_lr(*args, **kw)
    pkey, pval = SK.expand_sort_lr_plain(*args, **kw)
    assert SK.expand_sort_lr.launches == n8 + 1
    assert torch.equal(key, pkey)
    assert_kernel_outputs_match(K.compress(key, val, width=w, out_w=w),
                                K.compress_plain(pkey, pval, width=w,
                                                 out_w=w))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SLAB_CASES))
def test_k9_k10_slab_kernels_match_plain(cuda_device, name):
    _check_k9(*_slab_inputs(name, cuda_device))


def _check_k9(args, kw):
    key, val = SK.expand_sort_lr_dd(*args, **kw)
    pkey, pval = SK.expand_sort_lr_dd_plain(*args, **kw)
    assert val.dtype == torch.float64
    assert torch.equal(key, pkey)
    n10 = SK.compress_dd.launches
    got = SK.compress_dd(key, val, width=kw["width"])
    assert SK.compress_dd.launches == n10 + 1
    assert_dd_outputs_match(got, SK.compress_dd_plain(pkey, pval,
                                                      width=kw["width"]))


@pytest.mark.cuda
@pytest.mark.parametrize("ka", [16, 128])
def test_k7_kernels_match_plain(cuda_device, ka):
    """K7a's sorted packed keys equal the plain version's exactly (equal
    multisets sort to equal arrays); K7b's sums within tolerance, with
    and without compaction. Widths 128 and 1024."""
    *ops, width = table_inputs(ka)
    ops = [x.to(cuda_device) for x in ops]
    kw = dict(ka=ka, run=RUN, width=width, start_kk=2 * RUN)
    n7 = K.expand_sort_packed.launches
    p = K.expand_sort_packed(*ops, **kw)
    assert K.expand_sort_packed.launches == n7 + 1
    assert torch.equal(p, K.expand_sort_packed_plain(*ops, **kw))
    for compact, out_w in ((True, width), (True, 128), (False, width)):
        assert_kernel_outputs_match(
            K.compress_packed(p, width=width, out_w=out_w, compact=compact),
            K.compress_packed_plain(p, width=width, out_w=out_w,
                                    compact=compact))


def _table_case(dev, m, width, run, *, kind="random", short=False,
                unaligned=False, seed=0, pad_rows=2):
    """K2's and K7a's table-source operands (tests.torch_parity.
    table_fragments) on the card: ((table, rT, avT), kw); `unaligned`:
    the table 4 bytes past a 16-byte boundary (the slot-by-slot loads)."""
    ka = width // run - (3 if short else 0)
    table, rT, avT = table_fragments(m, ka, run, kind=kind,
                                     pad_rows=pad_rows,
                                     seed=seed + width + run)
    table = table.to(dev)
    if unaligned:
        buf = torch.empty(table.numel() + 1, dtype=torch.int32, device=dev)
        t = buf[1:].view(table.shape)
        t.copy_(table)
        table = t
        assert table.data_ptr() % 16 != 0
    return (table, rT.to(dev), avT.to(dev)), dict(ka=ka, run=run,
                                                  width=width,
                                                  start_kk=2 * run)


def _check_k2_sources(ops, kw):
    """K2 from the table through rT, and from g = table[rT] (the gather
    source), against the plain version: sorted keys exactly, run sums
    within tolerance."""
    table, rT, avT = ops
    w = kw["width"]
    pkey, pval = K.expand_sort_plain(table, avT, rT=rT, **kw)
    want = K.compress_plain(pkey, pval, width=w, out_w=w)
    for src, extra in ((table, dict(rT=rT)),
                       (K.table_gather(table, rT), {})):
        n2 = K.expand_sort.launches
        key, val = K.expand_sort(src, avT, **kw, **extra)
        assert K.expand_sort.launches == n2 + 1
        assert torch.equal(key, pkey)
        assert_kernel_outputs_match(
            K.compress_plain(key, val, width=w, out_w=w), want)


def _check_k7a(ops, kw):
    n7 = K.expand_sort_packed.launches
    p = K.expand_sort_packed(*ops, **kw)
    assert K.expand_sort_packed.launches == n7 + 1
    assert torch.equal(p, K.expand_sort_packed_plain(*ops, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 512, 1024])
@pytest.mark.parametrize("run", [8, 32])
@pytest.mark.parametrize("kind", ["random", "one_key"])
@pytest.mark.parametrize("short", [False, True])
def test_k2_both_sources_every_width(cuda_device, width, run, kind, short):
    """K2 from the table and from the gather at the widths up to
    TRANSPOSED_MAX_WIDTH, runs 8 and 32, fragments all used or a few
    short; columns up to 32767, sentinel-row fragments under NaN A
    values, padding rows; 37 rows (several share a block below 512)."""
    _check_k2_sources(*_table_case(cuda_device, 37, width, run, kind=kind,
                                   short=short))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 512, 1024, 2048, 16384])
@pytest.mark.parametrize("run", [8, 32])
@pytest.mark.parametrize("kind", ["random", "one_key"])
def test_k7a_every_width_and_run(cuda_device, width, run, kind):
    """K7a's sorted packed keys bit for bit at widths 128-1024 (and 2048
    and 16384, its other launch bounds' instances), runs 8 (a thread of
    16 slots spans two fragments, slot by slot) and 32; one key (column
    32767) over whole rows."""
    m = 37 if width <= 2048 else 3
    ops, kw = _table_case(cuda_device, m, width, run, kind=kind)
    _check_k7a(ops, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 512])
@pytest.mark.parametrize("m", [1, 13, 133])
def test_k2_k7a_rows_sharing_a_block(cuda_device, width, m):
    """Rows of one warp or less share a 128-thread block (K2 up to 256
    slots, K7a up to 512): row counts below, not a multiple of and above
    one block's rows."""
    ops, kw = _table_case(cuda_device, m, width, 8, seed=m,
                          pad_rows=min(2, m - 1))
    _check_k2_sources(ops, kw)
    _check_k7a(ops, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 1024])
@pytest.mark.parametrize("run", [8, 32])
def test_k2_k7a_table_off_the_grid(cuda_device, width, run):
    """A table 4 bytes off the 16-byte grid: K2 and K7a read it slot by
    slot and still match their plain versions."""
    ops, kw = _table_case(cuda_device, 37, width, run, unaligned=True)
    _check_k2_sources(ops, kw)
    _check_k7a(ops, kw)


def _k11_inputs(case, device):
    """(a_col, a_val, b, exact) for K11: ELL from canonical CSR (rows
    ascending) unless the case says otherwise; exact: bit for bit against
    the plain version, else within the values' tolerance."""
    m, k, n, density, dtype = K11_CASES[case]
    rng = np.random.default_rng(m + k + n)
    a = sp.random(m, k, density=density, format="csr", random_state=rng)
    a.data = rng.standard_normal(a.nnz)
    if case == "empty_rows":
        a = a.tolil()
        a[:6, :] = 0
        a[m - 1, :] = 0
        a = a.tocsr()
        a.eliminate_zeros()
    a.sort_indices()
    E = tell(a, dtype=dtype)
    a_col, a_val = E.col_ind, E.values
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(dtype))
    if case == "inf_row":
        # a stored 0 against the inf (NaN, as the plain multiply gives),
        # the other rows referencing that B row get +-inf
        r = int((a_col[:, 0] >= 0).nonzero()[0, 0])
        b[int(a_col[r, 0]), ::7] = float("inf")
        a_val[r, 0] = 0.0
    exact = not case.endswith("unsorted")
    if not exact:    # shuffled slots, an empty slot between live ones
        p = torch.from_numpy(np.argsort(rng.random(a_col.shape), axis=1))
        a_col[::3, 1] = -1
        a_col = torch.gather(a_col, 1, p).contiguous()
        a_val = torch.gather(a_val, 1, p).contiguous()
    return a_col.to(device), a_val.to(device), b.to(device), exact


# (m, k, n, density, value type): n not a multiple of the 1024- (float32)
# or 512-column (float64) chunk and m not one of the 8-row tile; n below
# one chunk; n odd (scalar segments and stores); rows of up to ~100
# entries (K > 32: several passes); empty rows; a B row of inf; float64
K11_CASES = {"rect": (300, 200, 2500, 0.05, np.float32),
             "wide_b": (64, 4096, 16384, 0.004, np.float32),
             "n_below_chunk": (37, 50, 100, 0.1, np.float32),
             "n_odd": (45, 60, 517, 0.1, np.float32),
             "long_rows": (50, 300, 600, 0.3, np.float32),
             "empty_rows": (33, 80, 1000, 0.1, np.float32),
             "inf_row": (40, 30, 700, 0.2, np.float32),
             "unsorted": (70, 120, 530, 0.1, np.float32),
             "f64": (300, 200, 1100, 0.05, np.float64),
             "f64_n_odd": (41, 90, 257, 0.4, np.float64),
             "f64_unsorted": (70, 120, 530, 0.1, np.float64)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K11_CASES))
def test_k11_kernel_matches_plain(cuda_device, case):
    """Bit for bit on canonical ELL (NaN where the plain version has
    NaN), within the values' tolerance on unsorted rows."""
    a_col, a_val, b, exact = _k11_inputs(case, cuda_device)
    n11 = DK.dense_row.launches
    got = DK.dense_row(a_col, a_val, b)
    assert DK.dense_row.launches == n11 + 1
    assert got.dtype == b.dtype
    want = DK.dense_row_plain(a_col, a_val, b)
    if exact:
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan], want[~nan])
    else:
        assert_values_close(got, want, rtol=value_rtol(want))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,density,table_size",
                         [(500, 400, 300, 0.02, None), (64, 64, 64, 0.2, 64)])
def test_k12_kernel_matches_plain(cuda_device, m, k, n, density, table_size):
    """The default table, and a full table (H = n) with long probe
    chains; compared after compact_ell, as sets per row."""
    from ia_spgemm_tpu_torch.ops import hash_spgemm
    A, B, _, _ = ell_pair(m, k, n, density, seed=k, device=cuda_device)
    H = table_size or min(hash_spgemm._next_pow2(
        2 * A.max_nnz_per_row * B.max_nnz_per_row),
        hash_spgemm._next_pow2(2 * n))
    args = (A.col_ind, A.values, B.col_ind, B.values)
    n12 = HK.hash_accumulate.launches
    got = HK.hash_accumulate(*args, table_size=H)
    assert HK.hash_accumulate.launches == n12 + 1
    assert_tables_match(got, HK.hash_accumulate_plain(*args, table_size=H),
                        (m, n))


def _assert_hops_equal(got, want, sources):
    """K13's output against the plain version's, bit for bit, and never
    the storage of a source block (empty blocks have no storage)."""
    torch.cuda.synchronize()
    ptrs = {b.data_ptr() for arr in sources for b in arr if b.numel()}
    for g_arr, w_arr in zip(got, want):
        for g, w in zip(g_arr, w_arr):
            assert g.dtype == w.dtype and g.device == w.device
            assert torch.equal(g, w)
            assert not g.numel() or g.data_ptr() not in ptrs


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 4, 8])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.float64])
def test_k13_ring_hop_matches_plain(cuda_device, D, dtype):
    """A ring step's two arrays (the ring's column and value blocks) in
    one launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    cols = [torch.randint(-1, 8192, (37, 29), generator=gen,
                          device=cuda_device, dtype=torch.int32)
            for _ in range(D)]
    vals = [(torch.randn((37, 29), generator=gen, device=cuda_device)
             * 100).to(dtype) for _ in range(D)]
    n13 = RR.ring_hop_rdma.launches
    got = RR.ring_hop_rdma(cols, vals)
    assert RR.ring_hop_rdma.launches == n13 + 1
    _assert_hops_equal(got, RR.ring_hop_plain(cols, vals), (cols, vals))


@pytest.mark.cuda
def test_k13_odd_bytes_unaligned_and_large_blocks(cuda_device):
    """An odd byte count, blocks off the 16-byte grid (the narrow tail
    path), and blocks past the grid's stride (9.6 MB each)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    raw = torch.randint(0, 256, (4, 1004), generator=gen, device=cuda_device,
                        dtype=torch.uint8)
    odd = [raw[d, 3:] for d in range(4)]              # 1001 bytes each
    flat = torch.randint(-9, 9, (4 * 1000 + 1,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    unaligned = [flat[1 + 1000 * d:1 + 1000 * (d + 1)] for d in range(4)]
    big = [torch.randn((300000, 8), generator=gen, device=cuda_device)
           for _ in range(4)]
    for arrays in ((odd, unaligned), (big,)):
        n13 = RR.ring_hop_rdma.launches
        got = RR.ring_hop_rdma(*arrays)
        assert RR.ring_hop_rdma.launches == n13 + 1
        _assert_hops_equal(got, RR.ring_hop_plain(*arrays), arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4, 8])
def test_k13_reused_receivers(cuda_device, D):
    """The ring's way: two sets of receivers made once, alternated over
    D - 1 hops, each hop's blocks the previous hop's receivers; bit for
    bit the plain hop's result at every step, in place, one launch each."""
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    cols = [torch.randint(-1, 8192, (4096 // D, 29), generator=gen,
                          device=cuda_device, dtype=torch.int32)
            for _ in range(D)]
    vals = [torch.randn((4096 // D, 29), generator=gen, device=cuda_device)
            for _ in range(D)]
    recv = [RR.alloc_receivers(cols, vals) for _ in range(2)]
    ptrs = [[[t.data_ptr() for t in arr] for arr in r] for r in recv]
    bc, bv = cols, vals
    for s in range(D - 1):
        want = RR.ring_hop_plain(bc, bv)
        n13 = RR.ring_hop_rdma.launches
        got = RR.ring_hop_rdma(bc, bv, out=recv[s % 2])
        assert RR.ring_hop_rdma.launches == n13 + 1
        assert [[t.data_ptr() for t in arr] for arr in got] == ptrs[s % 2]
        _assert_hops_equal(got, want, (bc, bv) if s == 0 else ())
        bc, bv = got


@pytest.mark.cuda
def test_k13_more_copies_than_one_launch(cuda_device):
    """150 copies (3 arrays x 50 shards) go out as two launches (the
    kernel's parameter struct holds 128)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    arrays = [[torch.randint(0, 99, (n, 3), generator=gen,
                             device=cuda_device, dtype=torch.int32)
               for _ in range(50)] for n in (1, 17, 64)]
    n13 = RR.ring_hop_rdma.launches
    got = RR.ring_hop_rdma(*arrays)
    assert RR.ring_hop_rdma.launches == n13 + 2
    _assert_hops_equal(got, RR.ring_hop_plain(*arrays), arrays)


@pytest.mark.cuda
def test_k13_zero_size_and_unaligned_blocks(cuda_device):
    """Zero-size blocks are left out of the launch (and a hop of only
    empty blocks launches nothing); blocks off the 16-byte grid, of odd
    byte counts, beside aligned ones in one launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    empty = [torch.zeros((0, 29), device=cuda_device) for _ in range(4)]
    n13 = RR.ring_hop_rdma.launches
    got = RR.ring_hop_rdma(empty)
    assert RR.ring_hop_rdma.launches == n13
    assert [tuple(t.shape) for t in got[0]] == [(0, 29)] * 4
    flat = torch.randint(-9, 9, (4 * 333 + 3,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    unaligned = [flat[3 + 333 * d:3 + 333 * (d + 1)] for d in range(4)]
    raw = torch.randint(0, 256, (4, 40), generator=gen, device=cuda_device,
                        dtype=torch.uint8)
    odd = [raw[d, 1:] for d in range(4)]                  # 39 bytes each
    # zero-size blocks beside 1.4 MB ones: receivers of both shapes
    mixed = [torch.randn((n, 5), generator=gen, device=cuda_device)
             for n in (0, 70000, 70000, 0)]
    for arrays in ((unaligned, odd), (mixed,)):
        n13 = RR.ring_hop_rdma.launches
        got = RR.ring_hop_rdma(*arrays)
        assert RR.ring_hop_rdma.launches == n13 + 1
        _assert_hops_equal(got, RR.ring_hop_plain(*arrays), arrays)


@pytest.mark.cuda
def test_k13_across_cards(cuda_device):
    """Several cards in one process: each source card's launch stores
    into its neighbour's memory (peer access). Skips with one card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards in one process")
    from ia_spgemm_tpu_torch.parallel.mesh import make_mesh
    devs = [torch.device("cuda", d % n) for d in range(2 * n)]
    assert RR.rdma_available(make_mesh(devices=devs))
    blocks = [torch.full((5000, 29), float(d), device=dv)
              for d, dv in enumerate(devs)]
    n13 = RR.ring_hop_rdma.launches
    got = RR.ring_hop_rdma(blocks)
    assert RR.ring_hop_rdma.launches == n13 + n      # one per source card
    _assert_hops_equal(got, RR.ring_hop_plain(blocks), (blocks,))


@pytest.mark.cuda
def test_ring_on_the_card_launches_k13_and_k4(cuda_device):
    """The ring on 4 shards of one card: through K13 it gives the plain
    hop's result bit for bit, D - 1 K13 launches and one K4 per shard."""
    from ia_spgemm_tpu_torch.parallel import ring
    from ia_spgemm_tpu_torch.parallel.mesh import make_mesh
    a = build_matrix(m=1024).astype(np.float32)
    A = tell(a, cuda_device)
    mesh = make_mesh(devices=[cuda_device] * 4)
    S = ring.partition_rows_ell(A, 4, mesh=mesh)
    plan = ring.plan_ring(A, A, 4)
    n13, n4 = RR.ring_hop_rdma.launches, K.sort_compress_rows.launches
    C1 = ring.gather_result_ell(ring.ring_spgemm(S, S, mesh, plan))
    assert RR.ring_hop_rdma.launches == n13 + 3
    assert K.sort_compress_rows.launches == n4 + 4
    C0 = ring.gather_result_ell(ring.ring_spgemm(S, S, mesh, plan,
                                                 use_rdma=False))
    assert RR.ring_hop_rdma.launches == n13 + 3
    for f in ("col_ind", "values", "nnz_row"):
        assert torch.equal(getattr(C1, f), getattr(C0, f)), f
    want = (a.astype(np.float64) @ a.astype(np.float64)).tocsr()
    got = C1.to_scipy()
    assert got.nnz == want.nnz
    assert abs(got - want).max() < 1e-4 * abs(want).max()


# one worker of the K13-across-processes tests: 2 processes x 2 shards of
# card 0 over gloo (layout "card0"), x 1 card each over NCCL, or over gloo
# x 2 cards each ("pair": cards 2p, 2p + 1 modulo the count) or x every
# card ("every"). "hop": three hops of random blocks through K13 into
# the alternated shared receivers, each bit for bit against the plain hop
# of torch.distributed, one launch each; the ring on build_matrix(m=1024)
# through K13 (D - 1 launches) bit for bit against the plain hop; and
# use_rdma=True on a mesh of host shards spanning the processes raises.
# "lost": process 1 never hops; process 0's hop must time out within the
# 1 s spin limit, raise, and keep raising.
XPROC_WORKER = """
import sys, time
sys.modules["jax"] = None
import numpy as np, torch, torch.distributed as dist
from ia_spgemm_tpu_torch.bench.headline import build_matrix
from ia_spgemm_tpu_torch.formats import convert
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.parallel import multihost, ring
from ia_spgemm_tpu_torch.parallel import rdma_ring as RR
from ia_spgemm_tpu_torch.parallel.mesh import make_mesh
pid, port, mode, backend, layout = (int(sys.argv[1]), sys.argv[2],
                                    sys.argv[3], sys.argv[4], sys.argv[5])
multihost.initialize(f"127.0.0.1:{port}", 2, pid, backend=backend)
n = torch.cuda.device_count()
devices = {"card0": ["cuda:0"] * 2,
           "pair": [f"cuda:{(2 * pid + i) % n}" for i in range(2)],
           "every": [f"cuda:{i}" for i in range(n)]}[layout]
mesh = (make_mesh(devices=devices) if backend == "gloo"
        else make_mesh(device_type="cuda"))
D, dev = mesh.num_shards, mesh.devices[0]
assert RR.rdma_available(mesh)
g = torch.Generator().manual_seed(pid)
cols = [torch.randint(-1, 8192, (3001, 29), generator=g,
                      dtype=torch.int32).to(d) for d in mesh.devices]
vals = [torch.randn((3001, 29), generator=g).to(d) for d in mesh.devices]
sets = RR.shared_receivers(mesh, cols, vals)
assert sets[0].home == mesh.devices[RR.home_slot(mesh.devices, pid)]
if mode == "hop":
    x = (cols, vals)
    for s in range(3):
        want = RR.ring_hop_processes_plain(mesh, *x)
        n13 = RR.ring_hop_rdma.launches
        got = RR.ring_hop_xproc(mesh, *x, out=sets[s % 2])
        assert RR.ring_hop_rdma.launches == n13 + 1
        RR.check_hops(sets[s % 2])
        assert all(torch.equal(a, b) for ga, wa in zip(got, want)
                   for a, b in zip(ga, wa)), s
        x = got
    a = build_matrix(m=1024).astype(np.float32)
    A = convert.csr_to_ell(CSR.from_scipy(a, device=dev),
                           check_guard=False)
    S = ring.partition_rows_ell(A, D, mesh=mesh)
    plan = ring.plan_ring(A, A, D)
    n13 = RR.ring_hop_rdma.launches
    C1 = ring.ring_spgemm(S, S, mesh, plan)
    assert RR.ring_hop_rdma.launches == n13 + D - 1
    C0 = ring.ring_spgemm(S, S, mesh, plan, use_rdma=False)
    assert RR.ring_hop_rdma.launches == n13 + D - 1
    for f in ("col_ind", "values", "nnz_row"):
        assert all(torch.equal(p, q) for p, q in zip(getattr(C1, f),
                                                     getattr(C0, f))), f
    assert all(c.device == d for c, d in zip(C1.col_ind, mesh.devices))
    multihost._rows_against_scipy(C1, a.astype(np.float64))
    host = make_mesh(devices=["cpu", "cpu"])
    assert host.spans_processes and not RR.rdma_available(host)
    Ah = convert.csr_to_ell(CSR.from_scipy(a, device="cpu"),
                            check_guard=False)
    Sh = ring.partition_rows_ell(Ah, host.num_shards, mesh=host)
    try:
        ring.ring_spgemm(Sh, Sh, host, plan, use_rdma=True)
    except ValueError as e:
        assert "use_rdma=True" in str(e)
    else:
        raise AssertionError("use_rdma=True ran on host shards")
    print("HOP_OK", flush=True)
else:
    RR.SPIN_LIMIT_S = 1.0
    if pid == 0:
        t0 = time.perf_counter()
        RR.ring_hop_xproc(mesh, cols, vals, out=sets[0])
        try:
            RR.check_hops(sets[0])
        except RuntimeError as e:
            took = time.perf_counter() - t0
            assert "did not arrive" in str(e) and took < 8, (str(e), took)
        else:
            raise AssertionError("a lost neighbour did not raise")
        try:
            RR.ring_hop_xproc(mesh, cols, vals, out=sets[1])
        except RuntimeError as e:
            assert "did not arrive" in str(e)
        else:
            raise AssertionError("a failed ring hopped again")
        print(f"TIMEOUT_OK {took}", flush=True)
    dist.barrier()
RR.release_shared()
dist.destroy_process_group()
"""


def _xproc_workers(mode, backend="gloo", layout="card0"):
    """Runs XPROC_WORKER's two processes in `mode`; their outputs."""
    import os
    import socket
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, IA_SPGEMM_SHARDS_PER_DEVICE="1")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-c", XPROC_WORKER, str(pid), str(port),
         mode, backend, layout], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} rc {p.returncode}:\n{out}"
    return outs


@pytest.mark.cuda
def test_k13_across_processes_matches_plain(cuda_device):
    """Two processes x 2 shards of the card: K13 across processes (CUDA
    IPC receivers, the in-kernel barrier) bit for bit against the plain
    hop of torch.distributed, its launches counted, the ring through it;
    use_rdma=True on host shards across the processes raises."""
    outs = _xproc_workers("hop")
    assert all("HOP_OK" in out for out in outs), outs


@pytest.mark.cuda
def test_k13_across_processes_on_two_cards(cuda_device):
    """The same over NCCL with a card per process: K13 stores into the
    other card's IPC-mapped receivers over NVLink. Skips with one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    outs = _xproc_workers("hop", backend="nccl")
    assert all("HOP_OK" in out for out in outs), outs


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["pair", "every"])
def test_k13_across_processes_over_several_cards(cuda_device, layout):
    """Two processes over gloo whose shards lie on several cards: 2 cards
    each, and every card each. The launch on each process's home card
    reads and stores its other cards' blocks and receivers by peer
    access: three hops bit for bit against the plain hop, one launch
    each; the ring on build_matrix(m=1024) through K13 (D - 1 launches)
    bit for bit against the plain hop, its rows against scipy. Skips
    with one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    outs = _xproc_workers("hop", layout=layout)
    assert all("HOP_OK" in out for out in outs), outs


@pytest.mark.cuda
def test_k13_across_processes_lost_neighbour_raises(cuda_device):
    """A worker whose neighbour never hops raises within the spin limit
    (1 s here), and its next hop raises at once; nothing hangs (each
    worker is bounded by communicate's timeout)."""
    outs = _xproc_workers("lost")
    assert "TIMEOUT_OK" in outs[0], outs


@pytest.mark.cuda
def test_training_step_on_the_card_matches_the_cpu(cuda_device):
    """One MatNet training step (TF32 off) on the card against the same
    step on the CPU: loss within 1e-5 relative, each gradient within
    1e-4 of its tensor's max |g|. (The stepped weights are not compared:
    Adam's first step moves each by about lr * sign(g), which a
    rounding difference can flip where g is near 0.)"""
    from ia_spgemm_tpu_torch.models import matnet, train
    cfg = train.TrainConfig(batch_size=16)
    batch = next(train.synthetic_dataset(cfg, 3))
    params = matnet.init_params(0)
    out = {}
    for dev in ("cpu", cuda_device):
        model, opt = train.make_model(cfg, params, device=dev)
        loss, _ = train.make_train_step(model, opt)(batch)
        out[str(dev)] = (float(loss), matnet.params_from_state_dict(
            {n: p.grad for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = out.values()
    assert l1 == pytest.approx(l0, rel=1e-5)
    for path, x0, x1 in _tree_pairs(g0, g1):
        d = float(np.abs(x1 - x0).max())
        assert d <= 1e-4 * float(np.abs(x0).max()), (path, d)


def _tree_pairs(a, b, path=()):
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _tree_pairs(v, b[k], path + (k,))
        else:
            yield path + (k,), v, b[k]


@pytest.mark.cuda
def test_device_time_ms_matches_the_profilers_k3_time(cuda_device):
    """profiling.device_time_ms (four calls between two CUDA events) of
    one K3 call at the f32 wide flat shape (32768 x 1024) within 20% of
    torch.profiler's device time of its kernel."""
    from ia_spgemm_tpu_torch.bench.kernels import PROFILE_NAMES, kernel_us
    from ia_spgemm_tpu_torch.bench.profiling import device_time_ms
    m, width = 32768, 1024
    g = torch.Generator(device=cuda_device).manual_seed(0)
    key = torch.randint(0, 4096, (m, width), dtype=torch.int32,
                        device=cuda_device, generator=g)
    key = torch.sort(key, dim=1).values
    val = torch.rand((m, width), device=cuda_device, generator=g)

    def call():
        return K.compress(key, val, width=width, out_w=width)

    dev_ms = device_time_ms(call, chain=4, reps=3)["device_ms"]
    kern_ms = kernel_us(call, PROFILE_NAMES["K3"]) / 1e3
    assert abs(dev_ms - kern_ms) <= 0.2 * kern_ms, (dev_ms, kern_ms)
