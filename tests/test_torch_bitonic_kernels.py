"""PyTorch port, the kernels K1-K4 and K4t (ops/bitonic_kernels.py): each
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
                                kernel_operands, pack_fragments,
                                table_fragments)


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
    key, val = K.expand_rows_plain(table, tbt._table_rows(A.col_ind, kt),
                                   A.values, run=RUN, width=width)
    want = _jax(jbt._sort_compress_rows, key, val, width=width,
                start_kk=2 * RUN, tile_rows=max(8, 32768 // width))
    got = K.sort_compress_rows(key, val, width=width, start_kk=2 * RUN)
    assert_kernel_outputs_match(got, want)


@pytest.mark.parametrize("width,run", [(2048, 32), (2048, 8), (4096, 32)])
def test_k4t_plain_matches_k1_plain_and_jax(width, run):
    """K4t's plain path (the torch expand of the rows, then K4's plain
    sort + compress) on table-source operands with fill-row fragments
    under NaN A values, two padding rows, rows short of ka fragments and
    odd fragments read reversed: bit for bit K1's plain path on the same
    fragments gathered (another expand of the same slots), and the JAX
    package's K4 launcher on the expanded rows. The wrapper takes the
    plain path for CPU tensors, uncounted."""
    ka = width // run - 3
    table, rT, avT = table_fragments(16, ka, run, seed=width + run)
    kw = dict(ka=ka, run=run, width=width, start_kk=2 * run)
    before = K.launch_counts()
    got = K.expand_sort_compress_rows(table, rT, avT, **kw)
    assert K.launch_counts() == before
    for x, y in zip(got, K.expand_sort_compress_rows_plain(table, rT, avT,
                                                           **kw)):
        assert torch.equal(x, y)
    k1 = K.expand_sort_compress_plain(K.table_gather(table, rT), avT,
                                      out_w=width, **kw)
    for x, y in zip(got, k1):
        assert torch.equal(x, y)
    assert int(got[2][-2:].sum()) == 0
    key, val = K.expand_rows_plain(table, rT.T, avT.T, run=run, width=width)
    want = _jax(jbt._sort_compress_rows, key, val, width=width,
                start_kk=2 * run, tile_rows=8)
    assert_kernel_outputs_match(got, want)


def test_k4t_wrapper_validates_operands():
    table, rT, avT = table_fragments(4, 61, 32, seed=1)
    kw = dict(ka=61, run=32, width=2048, start_kk=64)
    with pytest.raises(TypeError):
        K.expand_sort_compress_rows(table, rT.long(), avT, **kw)
    with pytest.raises(ValueError, match="must both be"):
        K.expand_sort_compress_rows(table, rT[:8], avT[:8], **kw)
    with pytest.raises(ValueError, match="ka\\*run"):
        K.expand_sort_compress_rows(table, rT, avT, **dict(kw, width=1024))
    meta = torch.empty(table.shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.expand_sort_compress_rows(meta, rT.to("meta"), avT.to("meta"),
                                    **kw)


@pytest.mark.parametrize("name", ["hex_mesh", "hex_mesh_plan_device",
                                  "headline"])
def test_tiled_route_takes_k4t_for_the_wide_ragged_classes_only(
        monkeypatch, name):
    """The tiled route's call: on a 3 x 3 x 20 node hex mesh (the
    benchmark's cant family; ragged classes 4096 and 8192, run 8) each
    class above TRANSPOSED_MAX_WIDTH calls K4t's wrapper once and K4's
    never, with the host plan (plan_csr_auto) and with the fragment
    index built in every call (plan_device); on the headline matrix
    (classes up to 1024, as cage12's) neither. C is scipy's product."""
    from ia_spgemm_tpu_torch.bench.headline import build_matrix
    from ia_spgemm_tpu_torch.bench.kernels import cant_matrix
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.ops import esc
    from tests.torch_parity import check_oracle
    a = (build_matrix(m=512).astype(np.float32) if name == "headline"
         else cant_matrix((3, 3, 20), seed=3))
    A = CSR.from_scipy(a, device="cpu")
    if name.endswith("plan_device"):
        E = convert.csr_to_ell(A, check_guard=False)
        call = tbt.multiclass_planned(E, E, assemble="bcsr",
                                      plan_device=True)
    else:
        route, call = esc.plan_csr_auto(A, A)
        assert route == "tiled"
    assert call.ragged
    calls = {}
    for fn in ("expand_sort_compress_rows", "sort_compress_rows"):
        def spy(*args, _fn=getattr(K, fn), _name=fn, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)
        monkeypatch.setattr(K, fn, spy)
    C = call()
    wide = sum(w > tbt.TRANSPOSED_MAX_WIDTH for w in call.widths)
    assert wide == (0 if name == "headline" else 2)
    assert calls == ({"expand_sort_compress_rows": wide} if wide else {})
    check_oracle(a, a, C)


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
