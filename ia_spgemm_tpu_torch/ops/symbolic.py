"""Symbolic pass (PyTorch port of ``ia_spgemm_tpu.ops.symbolic``): per-row
intermediate-product counts reduced on the operands' device; the planner
reads back the (m,) vector.

  row_flops[r]  = sum over stored a_rj of nnz(B row j) (GetFlop of one
                  row, csr/common_csr.h:290-304);
  expansion E   = sum(row_flops);
  nnz_c bound   = sum(min(row_flops, n)).
"""

from __future__ import annotations

import numpy as np
import torch

from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.utils.scans import entry_rows


def row_flops_csr(a_row_ptr, a_col_ind, a_nnz, b_row_ptr) -> torch.Tensor:
    """(m,) int32 per-row intermediate-product counts, on the device."""
    m = a_row_ptr.shape[0] - 1
    cap = a_col_ind.shape[0]
    k = b_row_ptr.shape[0] - 1
    col = a_col_ind.clamp(0, k - 1).long()
    ln = (b_row_ptr[col + 1] - b_row_ptr[col]).to(torch.int32)
    valid = torch.arange(cap, device=ln.device) < a_nnz
    rows = entry_rows(a_row_ptr, cap).clamp(0, m - 1).long()
    out = torch.zeros(m, dtype=torch.int32, device=ln.device)
    return out.index_add_(0, rows, torch.where(valid, ln, 0))


def plan_symbolic(A: CSR, B: CSR, *, return_rows: bool = False):
    """(E, nnz_c_bound, max_row_flops) as Python ints, plus the (m,) int64
    per-row flops when return_rows. The device reduction is int32; when
    max_row_nnz(A) * max_row_nnz(B) could wrap it, the per-row flops are
    computed on the host in int64 instead."""
    a_ptr = A.row_ptr.cpu().numpy().astype(np.int64)
    b_ptr = B.row_ptr.cpu().numpy().astype(np.int64)
    max_a = int(np.max(np.diff(a_ptr), initial=0))
    max_b = int(np.max(np.diff(b_ptr), initial=0))
    if max_a * max_b >= 2**31:
        col = A.col_ind.cpu().numpy().astype(np.int64)[:int(A.nnz)]
        b_len = np.diff(b_ptr)
        ln = b_len[np.clip(col, 0, len(b_len) - 1)]
        rows = np.repeat(np.arange(len(a_ptr) - 1),
                         np.diff(a_ptr).clip(min=0))[:int(A.nnz)]
        rf = np.zeros(len(a_ptr) - 1, dtype=np.int64)
        np.add.at(rf, rows, ln)
    else:
        rf = row_flops_csr(A.row_ptr, A.col_ind, A.nnz,
                           B.row_ptr).cpu().numpy().astype(np.int64)
    if rf.size == 0:
        out = (0, 0, 0)
        return out + (rf,) if return_rows else out
    out = (int(rf.sum()), int(np.minimum(rf, B.ncols).sum()),
           int(rf.max()))
    return out + (rf,) if return_rows else out
