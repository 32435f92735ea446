"""The hash route's kernel: wrapper, plain version, count.

=====  ==============  =============================================
 K12   hash_accumulate ops/hash_spgemm.py:58 _kernel
=====  ==============  =============================================

(file:line of the JAX package.) ``hash_accumulate(a_col, a_val, b_col,
b_val, table_size=H)`` returns the per-row tables (col (m, H) int32,
-1 = empty; val (m, H) float32) and nnz (m, 1) int32, the number of
distinct columns inserted per row, numeric zeros included. On CUDA
tensors it launches the kernel of ``csrc/hash.cu`` on the current stream
and counts the launch; on CPU tensors it runs the plain PyTorch version
beside it. There is no fallback: a failed build or launch raises.

Which slot holds which column is the kernel's business (hash order with
parallel probing); the plain version sorts each row's products by
column, sums duplicates in product order (the JAX kernel's sequential
order) and writes them left-justified. Compare after ``compact_ell``, as
sets of (column, sum) per row.
"""

from __future__ import annotations

import torch

from ia_spgemm_tpu_torch import tracing
from ia_spgemm_tpu_torch.ops import bitonic_kernels as BK
from ia_spgemm_tpu_torch.ops.bitonic_kernels import (SENTINEL, _check_tensor,
                                                     _cuda_or_raise, _launch)

# shared memory a block may use (227 KB on Hopper), for the 8*H-byte table
MAX_TABLE_BYTES = 227 * 1024


def hash_accumulate_plain(a_col, a_val, b_col, b_val, *, table_size: int):
    m, Ka = a_col.shape
    Kb = b_col.shape[1]
    arow = a_col.clamp(0, b_col.shape[0] - 1).long()
    j = b_col[arow]                                       # (m, Ka, Kb)
    ok = (a_col >= 0)[:, :, None] & (j >= 0)
    key = torch.where(ok, j, SENTINEL).reshape(m, Ka * Kb)
    val = torch.where(ok, a_val[:, :, None] * b_val[arow],
                      torch.zeros((), dtype=b_val.dtype, device=b_val.device)
                      ).reshape(m, Ka * Kb)
    key, order = torch.sort(key, dim=1, stable=True)
    return BK.compress_plain(key, torch.gather(val, 1, order),
                             width=Ka * Kb, out_w=table_size)


def hash_accumulate(a_col, a_val, b_col, b_val, *, table_size: int):
    """K12: per-row hash tables of C = A @ B, A (m, Ka) and B (k, Kb) as
    ELL, float32. The caller guarantees table_size >= each row's distinct
    columns (spgemm_hash checks H >= min(ncols, Ka*Kb))."""
    dev = a_col.device
    _check_tensor("a_col", a_col, torch.int32, 2, dev)
    _check_tensor("a_val", a_val, torch.float32, 2, dev)
    _check_tensor("b_col", b_col, torch.int32, 2, dev)
    _check_tensor("b_val", b_val, torch.float32, 2, dev)
    if a_val.shape != a_col.shape or b_val.shape != b_col.shape:
        raise ValueError("values must match their column arrays")
    if not (1 <= table_size and table_size * 8 + 4 <= MAX_TABLE_BYTES):
        raise ValueError(f"table_size {table_size} outside [1, "
                         f"{(MAX_TABLE_BYTES - 4) // 8}]")
    if dev.type == "cpu":
        return hash_accumulate_plain(a_col, a_val, b_col, b_val,
                                     table_size=table_size)
    _cuda_or_raise(a_col)
    m, Ka = a_col.shape
    col = torch.empty((m, table_size), dtype=torch.int32, device=dev)
    val = torch.empty((m, table_size), dtype=torch.float32, device=dev)
    nnz = torch.empty((m, 1), dtype=torch.int32, device=dev)
    if m:
        _launch("ia_k12_hash", a_col, a_val, b_col, b_val, col, val, nnz, m,
                Ka, b_col.shape[1], table_size, device=dev)
        tracing.count("launch.K12")
    return col, val, nnz


KERNELS = {"K12": hash_accumulate}


def reset_launch_counts():
    tracing.reset_launches(KERNELS)


def launch_counts() -> dict:
    return tracing.launches(KERNELS)
