"""PyTorch port, the four kernels K1-K4 (ops/bitonic_kernels.py): each
kernel's plain PyTorch version against the JAX package's launcher
(Pallas in interpret mode) on the same fragment gather g/avT or
pre-expanded keys/vals, at the route's widths. The CUDA kernels against
their plain versions: tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ia_spgemm_tpu.ops import bitonic as jbt
from ia_spgemm_tpu_torch.ops import bitonic as tbt
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
from tests.torch_parity import (GATHER_CASES, RUN,
                                assert_kernel_outputs_match, gather_inputs,
                                kernel_operands, pack_fragments)


def _jax(fn, *arrays, **kw):
    out = fn(*(jnp.asarray(x.numpy()) for x in arrays), interpret=True,
             **kw)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("ka,pack,out_width", GATHER_CASES)
@pytest.mark.parametrize("route", ["K1", "K2+K3"])
def test_gather_kernels_plain_match_jax(ka, pack, out_width, route):
    g, avT, width = gather_inputs(ka)
    gp = pack_fragments(g, pack)
    if pack > 1 and width > jbt.FUSED_MAX_WIDTH:
        pytest.skip("the JAX launcher packs only fused-width classes")
    want = _jax(jbt._sort_compress_from_gather, gp, avT, width=width,
                run=RUN, ka=ka, start_kk=2 * RUN, out_width=out_width,
                pack=pack)
    out_w = width if out_width is None else min(out_width, width)
    kw = dict(ka=ka, run=RUN, width=width, start_kk=2 * RUN, pack=pack)
    if route == "K1":
        got = K.expand_sort_compress_plain(gp, avT, out_w=out_w, **kw)
    else:
        key, val = K.expand_sort_plain(gp, avT, **kw)
        got = K.compress_plain(key, val, width=width, out_w=out_w)
    assert_kernel_outputs_match(got, want)
    # the wrappers take the plain versions for CPU tensors, uncounted
    before = K.launch_counts()
    again = K.expand_sort_compress(gp, avT, out_w=out_w, **kw)
    assert_kernel_outputs_match(again, want)
    assert K.launch_counts() == before


def test_compress_sparse_mode_matches_jax():
    """K3 with compact=False: survivors stay at their sorted slots."""
    g, avT, width = gather_inputs(128, seed=3)
    assert width == 1024 > jbt.FUSED_MAX_WIDTH
    want = _jax(jbt._sort_compress_from_gather, g, avT, width=width,
                run=RUN, ka=128, start_kk=2 * RUN, compact=False)
    key, val = K.expand_sort_plain(g, avT, ka=128, run=RUN, width=width,
                                   start_kk=2 * RUN)
    got = K.compress(key, val, width=width, out_w=width, compact=False)
    assert_kernel_outputs_match(got, want)
    assert ((got[0] >= 0).sum(1, keepdim=True) == got[2]).all()


@pytest.mark.parametrize("ka", [128, 256])
def test_rows_kernel_plain_matches_jax(ka):
    """K4 (rows layout) on pre-expanded keys/vals of widths 1024, 2048."""
    A, B = kernel_operands(ka, 64, seed=ka)
    width = tbt.plan_bitonic(A, B).width
    table, kt = tbt._build_wide_table(B.col_ind, B.values, run=RUN,
                                      chunks=1)
    key, val = tbt._expand_rows(table, tbt._table_rows(A.col_ind, kt),
                                A.values, run=RUN, width=width)
    want = _jax(jbt._sort_compress_rows, key, val, width=width,
                start_kk=2 * RUN, tile_rows=max(8, 32768 // width))
    got = K.sort_compress_rows(key, val, width=width, start_kk=2 * RUN)
    assert_kernel_outputs_match(got, want)


def test_wrappers_validate_operands():
    g, avT, width = gather_inputs(16, m=16)
    kw = dict(ka=16, run=RUN, width=width, start_kk=2 * RUN, out_w=width)
    with pytest.raises(TypeError):
        K.expand_sort_compress(g.float(), avT, **kw)
    with pytest.raises(ValueError, match="avT rows"):
        K.expand_sort_compress(g, avT[:8], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        K.expand_sort_compress(g, avT.T.contiguous().T, **kw)
    with pytest.raises(ValueError, match="power of two"):
        K.expand_sort_compress(g, avT, **dict(kw, width=200))
    with pytest.raises(ValueError, match="out_w"):
        K.compress(torch.zeros((2, 128), dtype=torch.int32),
                   torch.zeros((2, 128)), width=128, out_w=64,
                   compact=False)
    meta = torch.empty((2, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.sort_compress_rows(meta, torch.empty((2, 128), device="meta"),
                             width=128, start_kk=2)
    # K5 / K6: float32 or float64 values only, out_w within the width
    key = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or float64"):
        K.sort_only(key, torch.zeros((2, 128), dtype=torch.float16),
                    width=128, start_kk=2)
    with pytest.raises(ValueError, match="out_w"):
        K.sort_compress(key, torch.zeros((2, 128), dtype=torch.float64),
                        width=128, start_kk=2, out_w=256)
    for fn in (K.sort_only, K.sort_compress):
        extra = {"out_w": 128} if fn is K.sort_compress else {}
        with pytest.raises(ValueError, match="no kernel"):
            fn(meta, torch.empty((2, 128), dtype=torch.float64,
                                 device="meta"),
               width=128, start_kk=2, **extra)
