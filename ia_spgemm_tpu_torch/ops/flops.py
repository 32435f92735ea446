"""FLOP counting, the reference's GetFlop (csr/common_csr.h:290-304):
flops = sum over stored a_ij of nnz(B row j) = number of intermediate
products. GFLOPS reporting multiplies by 2 (multiply + add, main.cpp:989).
"""

from __future__ import annotations

import numpy as np

from ia_spgemm_tpu_torch.formats.types import CSR


def get_flop(A: CSR, B: CSR) -> int:
    """Host-side exact count (numpy, O(nnz))."""
    b_len = np.diff(B.row_ptr.cpu().numpy()).astype(np.int64)
    nnz_a = int(A.nnz)
    if nnz_a == 0:
        return 0
    col_a = A.col_ind[:nnz_a].cpu().numpy()
    return int(b_len[np.clip(col_a, 0, B.nrows - 1)].sum())
