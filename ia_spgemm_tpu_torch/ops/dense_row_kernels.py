"""The dense-row route's kernel: wrapper, plain version, count.

=====  ==============  =============================================
 K11   dense_row       ops/dense_row.py:35 _kernel
=====  ==============  =============================================

(file:line of the JAX package.) ``dense_row(a_col, a_val, b)`` returns
C (m, n) in b's type (float32 or float64) with C[r, :] = sum over kk of
a_val[r, kk] * b[a_col[r, kk], :], empty slots (a_col < 0) skipped. On
CUDA tensors it launches the kernel of ``csrc/dense_row.cu`` on the
current stream (its ``_f64`` instance for float64) and counts the launch;
on CPU tensors it runs the plain PyTorch version beside it. There is no
fallback: a failed build or launch raises. Kernel and plain version round
the same way (multiply, then add, per slot). The plain version adds a
row's products in slot order, the kernel in ascending column order (in
passes of 32 slots): on an ELL built from canonical CSR the two orders
are one and they agree bit for bit; rows with unsorted columns agree
within the values' rounding (tests/test_torch_k11_tiles.py).
"""

from __future__ import annotations

import torch

from ia_spgemm_tpu_torch.ops.bitonic_kernels import (_VALUE_TYPES,
                                                     _check_tensor,
                                                     _cuda_or_raise, _entry,
                                                     _launch)


def dense_row_plain(a_col, a_val, b):
    """One (m, n) gather-multiply-add per ELL slot, so the temporaries stay
    at m x n (one gather of every slot would need m x K x n)."""
    m, K = a_col.shape
    acc = torch.zeros((m, b.shape[1]), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for kk in range(K):
        c = a_col[:, kk]
        rows = b[c.clamp(min=0).long()]
        acc += torch.where((c >= 0)[:, None],
                           a_val[:, kk, None].to(b.dtype) * rows, zero)
    return acc


def dense_row(a_col, a_val, b):
    """K11: dense accumulator rows of C = A @ B, A as ELL (a_col, a_val)
    (m, K), B dense (k, n). On the card a_val and b are both float32 or
    both float64."""
    dev = b.device
    _check_tensor("a_col", a_col, torch.int32, 2, dev)
    if a_val.shape != a_col.shape or b.dim() != 2:
        raise ValueError(f"a_val {tuple(a_val.shape)} must match a_col "
                         f"{tuple(a_col.shape)}; b must be 2-d")
    if dev.type == "cpu":
        return dense_row_plain(a_col, a_val, b)
    _cuda_or_raise(b)
    if b.dtype not in _VALUE_TYPES:
        raise TypeError(f"b: want float32 or float64, got {b.dtype}")
    _check_tensor("a_val", a_val, b.dtype, 2, dev)
    _check_tensor("b", b, b.dtype, 2, dev)
    m, K = a_col.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=b.dtype, device=dev)
    if m and n:
        _launch(_entry("ia_k11_dense_row", b), a_col, a_val, b, out, m, K,
                n, device=dev)
        dense_row.launches += 1
    return out


KERNELS = {"K11": dense_row}
dense_row.launches = 0


def reset_launch_counts():
    dense_row.launches = 0


def launch_counts() -> dict:
    return {"K11": dense_row.launches}
