"""Dense reference path (PyTorch port of ``ia_spgemm_tpu.ops.dense``).

Densify and multiply: ``torch.matmul``, as the JAX package left it to
XLA's matmul outside any Pallas kernel. The product runs in full float32
(the JAX package asks for Precision.HIGHEST): TF32 is turned off for
this call, and the caller's setting is restored after it.
"""

from __future__ import annotations

import torch

from ia_spgemm_tpu_torch.formats.convert import csr_to_dense
from ia_spgemm_tpu_torch.formats.types import CSR, Dense


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return torch.matmul(a, b)
    finally:
        torch.set_float32_matmul_precision(prev)


def spgemm_dense(A, B) -> Dense:
    """C = A @ B through a dense matmul. Accepts CSR or Dense operands."""
    a = csr_to_dense(A).values if isinstance(A, CSR) else A.values
    b = csr_to_dense(B).values if isinstance(B, CSR) else B.values
    dt = torch.promote_types(a.dtype, b.dtype)
    return Dense(values=_matmul(a.to(dt), b.to(dt)))
