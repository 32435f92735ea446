"""The dense-row route's kernel: wrapper, plain version, count.

=====  ==============  =============================================
 K11   dense_row       ops/dense_row.py:35 _kernel
=====  ==============  =============================================

(file:line of the JAX package.) ``dense_row(a_col, a_val, b)`` returns
C (m, n) float32 with C[r, :] = sum over kk of a_val[r, kk] *
b[a_col[r, kk], :], the slots taken in order and empty slots (a_col < 0)
skipped. On CUDA tensors it launches the kernel of ``csrc/dense_row.cu``
on the current stream and counts the launch; on CPU tensors it runs the
plain PyTorch version beside it. There is no fallback: a failed build
or launch raises. Kernel and plain version round the same way
(multiply, then add, per slot), so they agree bit for bit.
"""

from __future__ import annotations

import torch

from ia_spgemm_tpu_torch.ops.bitonic_kernels import (_check_tensor,
                                                     _cuda_or_raise, _launch)


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
    (m, K), B dense (k, n). float32 on the card."""
    dev = b.device
    _check_tensor("a_col", a_col, torch.int32, 2, dev)
    if a_val.shape != a_col.shape or b.dim() != 2:
        raise ValueError(f"a_val {tuple(a_val.shape)} must match a_col "
                         f"{tuple(a_col.shape)}; b must be 2-d")
    if dev.type == "cpu":
        return dense_row_plain(a_col, a_val, b)
    _cuda_or_raise(b)
    _check_tensor("a_val", a_val, torch.float32, 2, dev)
    _check_tensor("b", b, torch.float32, 2, dev)
    m, K = a_col.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m and n:
        _launch("ia_k11_dense_row", a_col, a_val, b, out, m, K, n,
                device=dev)
        dense_row.launches += 1
    return out


KERNELS = {"K11": dense_row}
dense_row.launches = 0


def reset_launch_counts():
    dense_row.launches = 0


def launch_counts() -> dict:
    return {"K11": dense_row.launches}
