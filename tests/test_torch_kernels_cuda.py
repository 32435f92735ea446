"""PyTorch port, the CUDA kernels K1-K4 and K8-K10 against their plain
PyTorch versions on the card (marked `cuda`; they skip without a GPU).

This file imports no jax, so it runs on the GPU machine, where jax is
not installed and tests/conftest.py (which imports jax) must be left out:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest \\
        -o addopts="" -m cuda -q
"""

import pytest
import torch

from ia_spgemm_tpu_torch.bench.headline import build_matrix
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
from ia_spgemm_tpu_torch.ops import slab_kernels as SK
from tests.torch_parity import (GATHER_CASES, RUN, assert_dd_outputs_match,
                                assert_kernel_outputs_match, gather_inputs,
                                ill_conditioned, pack_fragments,
                                slab_operands)

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
