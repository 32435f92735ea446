"""PyTorch port, the CUDA kernels K1-K12 (K3-K6 in float32 and float64)
against their plain PyTorch versions on the card (marked `cuda`; they
skip without a GPU).

This file imports no jax, so it runs on the GPU machine, where jax is
not installed and tests/conftest.py (which imports jax) must be left out:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest \\
        -o addopts="" -m cuda -q
"""

import numpy as np
import pytest
import torch

from ia_spgemm_tpu_torch.bench.headline import build_matrix
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
from ia_spgemm_tpu_torch.ops import dense_row_kernels as DK
from ia_spgemm_tpu_torch.ops import hash_kernels as HK
from ia_spgemm_tpu_torch.ops import slab_kernels as SK
from tests.torch_parity import (GATHER_CASES, RUN, assert_dd_outputs_match,
                                assert_kernel_outputs_match,
                                assert_tables_match, assert_values_close,
                                cols_inputs, ell_pair, gather_inputs,
                                ill_conditioned, pack_fragments,
                                slab_operands, value_rtol)

# slab-kernel inputs: (matrix, planner overrides); the headline plans
# width 1024, the others 512
SLAB_CASES = {"headline2048": (lambda: build_matrix(m=2048), {}),
              "headline2048_run16": (lambda: build_matrix(m=2048),
                                     {"run": 16}),
              "ill_conditioned": (ill_conditioned, {})}


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ka,out_width", [(32, None), (32, 128),
                                          (128, None), (128, 300)])
def test_k5_k6_k3_kernels_match_plain(cuda_device, dtype, ka, out_width):
    """The cols layout on the torch expand's rows (padded class rows
    included): K5 at width 256 (ka 32) and 1024 (ka 128), with and
    without an out_w cap; K6's sorted keys equal the plain version's, K3
    on them within the values' tolerance."""
    key, val, width = cols_inputs(ka, dtype)
    key, val = key.to(cuda_device), val.to(cuda_device)
    out_w = width if out_width is None else min(out_width, width)
    kw = dict(width=width, start_kk=2 * RUN)
    rtol = value_rtol(val)
    n5 = K.sort_compress.launches
    got = K.sort_compress(key, val, out_w=out_w, **kw)
    assert K.sort_compress.launches == n5 + 1
    assert got[1].dtype == val.dtype and got[0].shape[1] == out_w
    assert_kernel_outputs_match(
        got, K.sort_compress_plain(key, val, out_w=out_w, **kw), rtol=rtol)
    n6 = K.sort_only.launches
    sk, sv = K.sort_only(key, val, **kw)
    assert K.sort_only.launches == n6 + 1
    pk, pv = K.sort_only_plain(key, val, **kw)
    assert torch.equal(sk, pk)
    assert_kernel_outputs_match(
        K.compress(sk, sv, width=width, out_w=out_w),
        K.compress_plain(pk, pv, width=width, out_w=out_w), rtol=rtol)


def _slab_inputs(name, device):
    make, over = SLAB_CASES[name]
    p, g, avT, lrT, kw = slab_operands(make(), **over)
    return (g.to(device), avT.to(device), lrT.to(device)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SLAB_CASES))
def test_k8_k3_slab_kernels_match_plain(cuda_device, name):
    """K8 sorts every slab's keys exactly as the plain version; values
    within a duplicate run may sit in another order, so the run sums
    (K3 against its plain version) are compared."""
    args, kw = _slab_inputs(name, cuda_device)
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
    args, kw = _slab_inputs(name, cuda_device)
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
    g, avT, width = gather_inputs(ka)
    g, avT = g.to(cuda_device), avT.to(cuda_device)
    kw = dict(ka=ka, run=RUN, width=width, start_kk=2 * RUN)
    n7 = K.expand_sort_packed.launches
    p = K.expand_sort_packed(g, avT, **kw)
    assert K.expand_sort_packed.launches == n7 + 1
    assert torch.equal(p, K.expand_sort_packed_plain(g, avT, **kw))
    for compact, out_w in ((True, width), (True, 128), (False, width)):
        assert_kernel_outputs_match(
            K.compress_packed(p, width=width, out_w=out_w, compact=compact),
            K.compress_packed_plain(p, width=width, out_w=out_w,
                                    compact=compact))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,density", [(300, 200, 2500, 0.05),
                                           (64, 4096, 16384, 0.004)])
def test_k11_kernel_matches_plain(cuda_device, m, k, n, density):
    """n not a multiple of the 1024-column chunk, and a wide B."""
    A, _, a, _ = ell_pair(m, k, 8, density, seed=m, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    b = torch.randn((k, n), device=cuda_device, generator=gen)
    n11 = DK.dense_row.launches
    got = DK.dense_row(A.col_ind, A.values, b)
    assert DK.dense_row.launches == n11 + 1
    assert_values_close(got, DK.dense_row_plain(A.col_ind, A.values, b))


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
