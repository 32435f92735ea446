"""FLOP counting, the reference's GetFlop (csr/common_csr.h:290-304):
flops = sum over stored a_ij of nnz(B row j) = number of intermediate
products. GFLOPS reporting multiplies by 2 (multiply + add, main.cpp:989).
"""

from __future__ import annotations

import numpy as np
import torch

from ia_spgemm_tpu_torch.formats.types import CSR


def get_flop(A: CSR, B: CSR) -> int:
    """Host-side exact count (numpy, O(nnz))."""
    b_len = np.diff(B.row_ptr.cpu().numpy()).astype(np.int64)
    nnz_a = int(A.nnz)
    if nnz_a == 0:
        return 0
    col_a = A.col_ind[:nnz_a].cpu().numpy()
    return int(b_len[np.clip(col_a, 0, B.nrows - 1)].sum())


def get_flop_jit(a_col_ind: torch.Tensor, a_nnz, b_row_ptr: torch.Tensor
                 ) -> torch.Tensor:
    """The same count on the tensors' device, as a 0-d int64 tensor
    (no host round trip): slots past a_nnz count 0, columns clipped into
    B's rows as the JAX package's traceable variant does."""
    k = b_row_ptr.shape[0] - 1
    col = a_col_ind.long().clamp(0, max(k - 1, 0))
    ln = (b_row_ptr[col + 1] - b_row_ptr[col]).long()
    valid = torch.arange(a_col_ind.shape[0],
                         device=a_col_ind.device) < a_nnz
    return torch.where(valid, ln, 0).sum()
