"""ELL x ELL SpGEMM: row-local expand / sort / compress over padded rows
(PyTorch port of ``ia_spgemm_tpu.ops.ell``, which is plain XLA).

Each row's Ka*Kb candidate products are laid out as one padded row,
sorted along the row by column (``torch.sort``), and the duplicate runs
summed into left-justified output slots. Output width Kc = min(ncols,
Ka*Kb) unless given (reference ell/common_ell.h:80-189).
"""

from __future__ import annotations

import torch

from ia_spgemm_tpu_torch.formats.types import ELL


def _ell_core(a_col, a_val, b_col, b_val, *, out_width: int, n: int):
    m, Ka = a_col.shape
    Kb = b_col.shape[1]
    dev = a_col.device
    val_dtype = torch.promote_types(a_val.dtype, b_val.dtype)
    # expand: product (ka, kb) of row i is A[i, ka] * B[a_col[i, ka], kb]
    arow = a_col.clamp(0, b_col.shape[0] - 1).long()
    j = b_col[arow]                                       # (m, Ka, Kb)
    ok = (a_col >= 0)[:, :, None] & (j >= 0)
    j = torch.where(ok, j, n).reshape(m, Ka * Kb)
    v = torch.where(ok, a_val[:, :, None].to(val_dtype)
                    * b_val[arow].to(val_dtype),
                    torch.zeros((), dtype=val_dtype, device=dev)
                    ).reshape(m, Ka * Kb)
    # sort each row by column (invalid = n sorts last), then compress:
    # run heads open output slots, values add into their run's slot
    j_s, order = torch.sort(j, dim=1, stable=True)
    v_s = torch.gather(v, 1, order)
    prev = torch.cat([torch.full((m, 1), -1, dtype=j_s.dtype, device=dev),
                      j_s[:, :-1]], dim=1)
    head = (j_s != prev) & (j_s < n)
    slot = torch.cumsum(head, dim=1) - 1
    slot_c = slot.clamp(0, out_width - 1)
    out_val = torch.zeros((m, out_width), dtype=val_dtype, device=dev)
    out_val.scatter_add_(1, slot_c, torch.where(
        j_s < n, v_s, torch.zeros((), dtype=val_dtype, device=dev)))
    out_col = torch.full((m, out_width), -1, dtype=torch.int32, device=dev)
    out_col.scatter_reduce_(1, slot_c, torch.where(head, j_s, -1).to(
        torch.int32), "amax")
    nnz_row = head.sum(dim=1, dtype=torch.int32)
    return out_col, out_val, nnz_row


def spgemm_ell(A: ELL, B: ELL, out_width: int | None = None) -> ELL:
    """C = A @ B with both operands ELL (reference ell/common_ell.h:80-189)."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    n = B.ncols
    Kc = max(out_width or min(n, A.max_nnz_per_row * B.max_nnz_per_row), 1)
    col, val, nnz_row = _ell_core(A.col_ind, A.values, B.col_ind, B.values,
                                  out_width=Kc, n=n)
    return ELL(col_ind=col, values=val, nnz_row=nnz_row,
               nnz=nnz_row.sum(dtype=torch.int32), shape=(A.nrows, B.ncols))
