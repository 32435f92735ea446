"""The slab engine's kernels: wrappers, plain versions, counts.

=====  ====================  ===========================================
 K8    expand_sort_lr        ops/slab.py:99  _expand_sort_kernel_lr
 K9    expand_sort_lr_dd     ops/slab.py:306 _expand_sort_kernel_lr_dd
 K10   compress_dd           ops/slab.py:369 _compress_kernel_t_dd
=====  ====================  ===========================================

(file:line of the JAX package.) The slab route's compress of float32
sums is K3 (``bitonic_kernels.compress``) on the slab rows. Each wrapper
checks its operands, then: on CUDA tensors it launches the hand-written
kernel of ``csrc/slab.cu`` on the current stream and adds one to its
launch counter; on CPU tensors it runs the plain PyTorch version
beside it. There is no fallback: a failed build or launch raises.

Layouts (row-major, one slab per row):

- ``table`` (F_B + 1, lanes) int32: the packed B fragment table, one row
  [col_f | val_bits_f | col_rev | val_bits_rev] per B sub-run of length
  ``run`` (col -1 = empty; lanes >= 4*run, a multiple of 4), the last
  row all -1 (the fill row of empty and padding slots). ``mt`` (ka, S)
  int32: the table row of fragment slot e of slab s; ``avT`` (ka, S)
  float32 its A value; ``lrT`` (ka, S) int32 its slab-local row. K8 and
  K9 read the table through ``mt`` themselves (no gathered copy of its
  rows); the wrappers do not check that mt's values lie in the table,
  which would need a device sync. Slot e's products occupy slots
  [e*run, (e+1)*run) of the slab, the reversed half for odd e, so a slab
  arrives as alternating ascending / descending runs and the sort starts
  merging at ``start_kk = 2*run``.
- keys are ``lr * n + col`` (the planner keeps them below 2^31 - 1),
  SENTINEL for empty slots.
- K8 returns sorted (key (S, width) int32, val float32); K9 the same with
  exact float64 products (two float32 factors fit a float64 mantissa);
  K10 sums each duplicate run in float64 and returns (col (S, width)
  int32 compacted left, -1 pad; hi, lo float32 with hi = f32(s),
  lo = f32(s - hi), 0 pad; nnz (S, 1) int32).

The plain versions sort stably and sum duplicates in slot order; the
kernels' network is not stable, so float32 sums agree to rounding and
structure exactly.
"""

from __future__ import annotations

import torch

from ia_spgemm_tpu_torch import tracing
from ia_spgemm_tpu_torch.ops import bitonic_kernels as BK
from ia_spgemm_tpu_torch.ops.bitonic_kernels import SENTINEL

MIN_WIDTH = 128
MAX_WIDTH = 1024   # the slab width cap; keeps a slab in 48 KB of smem


# ---------------------------------------------------------------- checks

def _check_width(width: int, start_kk: int | None = None):
    if not (BK._is_pow2(width) and MIN_WIDTH <= width <= MAX_WIDTH):
        raise ValueError(f"width {width} must be a power of two in "
                         f"[{MIN_WIDTH}, {MAX_WIDTH}]")
    if start_kk is not None and not (BK._is_pow2(start_kk)
                                     and start_kk >= 2):
        raise ValueError(f"start_kk {start_kk} must be a power of two >= 2")


def _check_slab_gather(table, mt, avT, lrT, ka, run, width, n):
    BK._check_table(table, mt, avT, ka, run, width, index="mt")
    BK._check_tensor("lrT", lrT, torch.int32, 2, avT.device)
    if lrT.shape != avT.shape:
        raise ValueError(f"lrT {tuple(lrT.shape)} / avT {tuple(avT.shape)} "
                         f"must both be ({ka}, S)")
    if not 1 <= n < 2**31:
        raise ValueError(f"n {n} out of range")


# ---------------------------------------------------- plain PyTorch versions

def _expand_lr_plain(table, mt, avT, lrT, ka, run, width, n, dtype):
    """Products (S, width) from table[mt]: key lr*n + col, value avT * b
    formed in `dtype`; SENTINEL / 0 where the column is empty (a
    select)."""
    dev = avT.device
    e = torch.arange(ka, device=dev)
    lanes = (((e & 1) * 2 * run)[:, None]
             + torch.arange(run, device=dev))[:, None, :]     # (ka, 1, run)
    rows = mt.long()[:, :, None]                              # (ka, S, 1)
    c = table[rows, lanes]                                    # (ka, S, run)
    vb = table[rows, lanes + run].view(torch.float32)
    valid = c >= 0
    key = torch.where(valid, lrT[:, :, None] * n + c, SENTINEL)
    val = torch.where(valid, avT[:, :, None].to(dtype) * vb.to(dtype),
                      torch.zeros((), dtype=dtype, device=dev))
    S = avT.shape[1]
    key = key.permute(1, 0, 2).reshape(S, ka * run)
    val = val.permute(1, 0, 2).reshape(S, ka * run)
    pad = width - ka * run
    if pad:
        key = torch.nn.functional.pad(key, (0, pad), value=SENTINEL)
        val = torch.nn.functional.pad(val, (0, pad))
    return key.to(torch.int32).contiguous(), val.contiguous()


def expand_sort_lr_plain(table, mt, avT, lrT, *, ka, run, width, n,
                         start_kk):
    return BK._sort_plain(*_expand_lr_plain(table, mt, avT, lrT, ka, run,
                                            width, n, torch.float32))


def expand_sort_lr_dd_plain(table, mt, avT, lrT, *, ka, run, width, n,
                            start_kk):
    return BK._sort_plain(*_expand_lr_plain(table, mt, avT, lrT, ka, run,
                                            width, n, torch.float64))


def compress_dd_plain(key, val, *, width):
    col, s, nnz = BK._compress_plain(key, val, width, True)
    hi = s.float()
    return col, hi, (s - hi.double()).float(), nnz


# ------------------------------------------------------------------ wrappers

def _expand_sort(kernel, plain, name, val_dtype, table, mt, avT, lrT, ka,
                 run, width, n, start_kk):
    _check_width(width, start_kk)
    _check_slab_gather(table, mt, avT, lrT, ka, run, width, n)
    dev = avT.device
    if dev.type == "cpu":
        return plain(table, mt, avT, lrT, ka=ka, run=run, width=width, n=n,
                     start_kk=start_kk)
    BK._cuda_or_raise(avT)
    S = avT.shape[1]
    key = torch.empty((S, width), dtype=torch.int32, device=dev)
    val = torch.empty((S, width), dtype=val_dtype, device=dev)
    if S:
        BK._launch(name, table, mt, avT, lrT, key, val, S, ka,
                   table.shape[1], run, width, n, start_kk, device=dev)
        tracing.count("launch." + kernel)
    return key, val


def expand_sort_lr(table, mt, avT, lrT, *, ka: int, run: int, width: int,
                   n: int, start_kk: int):
    """K8: expand from the table through mt, with slab-local row keys, +
    one sort per slab. Returns sorted (key (S, width) int32, val (S,
    width) float32)."""
    return _expand_sort("K8", expand_sort_lr_plain,
                        "ia_k8_expand_sort_lr", torch.float32, table, mt,
                        avT, lrT, ka, run, width, n, start_kk)


def expand_sort_lr_dd(table, mt, avT, lrT, *, ka: int, run: int, width: int,
                      n: int, start_kk: int):
    """K9: K8 with exact float64 products. Returns sorted (key (S, width)
    int32, val (S, width) float64)."""
    return _expand_sort("K9", expand_sort_lr_dd_plain,
                        "ia_k9_expand_sort_lr_dd", torch.float64, table, mt,
                        avT, lrT, ka, run, width, n, start_kk)


def compress_dd(key, val, *, width: int):
    """K10: float64 duplicate-run sums, nnz and compaction of sorted slab
    rows. Returns (col, hi, lo, nnz (S, 1))."""
    _check_width(width)
    dev = key.device
    BK._check_tensor("key", key, torch.int32, 2, dev)
    BK._check_tensor("val", val, torch.float64, 2, dev)
    if key.shape != val.shape or key.shape[1] != width:
        raise ValueError(f"key {tuple(key.shape)} / val {tuple(val.shape)} "
                         f"must both be (S, {width})")
    if dev.type == "cpu":
        return compress_dd_plain(key, val, width=width)
    BK._cuda_or_raise(key)
    S = key.shape[0]
    col = torch.empty((S, width), dtype=torch.int32, device=dev)
    hi = torch.empty((S, width), dtype=torch.float32, device=dev)
    lo = torch.empty((S, width), dtype=torch.float32, device=dev)
    nnz = torch.empty((S, 1), dtype=torch.int32, device=dev)
    if S:
        BK._launch("ia_k10_compress_dd", key, val, col, hi, lo, nnz, S,
                   width, device=dev)
        tracing.count("launch.K10")
    return col, hi, lo, nnz


KERNELS = {"K8": expand_sort_lr, "K9": expand_sort_lr_dd,
           "K10": compress_dd}


def reset_launch_counts():
    tracing.reset_launches(KERNELS)


def launch_counts() -> dict:
    return tracing.launches(KERNELS)
