"""Format conversions and the reference's size guard (PyTorch port of
``ia_spgemm_tpu.formats.convert``, semantics only).

Size formulas replicate the reference byte for byte (sizeof(int)=4,
VALUE_TYPE=double=8): sizeofcsr (csr/common_csr.h:196-202) and sizeofell
(ell/common_ell.h:21-27). The guard rejects ELL when its size exceeds
ratio x CSR (ell/common_ell.h:71-74).

Every conversion runs on the device its input lives on; only the
planners (ELL width, transposition) read the row pointer on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ia_spgemm_tpu_torch import config as cfg
from ia_spgemm_tpu_torch.formats.types import CSR, ELL, BlockCSR


def sizeof_csr(nrows: int, nnz: int) -> float:
    """csr/common_csr.h:196-202."""
    return cfg.SIZEOF_INDEX * (nrows + 1 + nnz + 3) + cfg.SIZEOF_VALUE * nnz


def sizeof_ell(nrows: int, max_nnz_per_row: int) -> float:
    """ell/common_ell.h:21-27."""
    return (cfg.SIZEOF_INDEX * (nrows + nrows * max_nnz_per_row + 4)
            + cfg.SIZEOF_VALUE * (nrows * max_nnz_per_row))


def ell_viable(nrows, nnz, max_nnz_per_row,
               ratio: float = cfg.SIZE_GUARD_RATIO_CPU) -> bool:
    return sizeof_ell(nrows, max_nnz_per_row) < ratio * sizeof_csr(nrows, nnz)


def plan_ell_width(A: CSR) -> int:
    """Host planner: K = max nnz per row (ell/common_ell.h:33-39)."""
    if A.nrows == 0:
        return 0
    return int(np.max(np.diff(A.row_ptr.cpu().numpy())))


def _entry_rows(row_ptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Row of each of the first nnz CSR entries (int64)."""
    lens = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.arange(lens.shape[0], device=row_ptr.device)
    return torch.repeat_interleave(rows, lens, output_size=nnz)


def csr_to_ell(A: CSR, width: int | None = None,
               check_guard: bool = True,
               ratio: float = cfg.SIZE_GUARD_RATIO_CPU) -> ELL | None:
    """Returns None when the viability guard rejects the format
    (reference sets choice=false, ell/common_ell.h:71-74)."""
    K = plan_ell_width(A) if width is None else width
    if width is not None and width < plan_ell_width(A):
        raise ValueError(
            f"width {width} < max row length {plan_ell_width(A)}; "
            "ELL cannot truncate rows")
    nnz = int(A.nnz)
    if check_guard and not ell_viable(A.nrows, nnz, K, ratio):
        return None
    K = max(K, 1)   # keep shapes non-degenerate
    m, dev = A.nrows, A.device
    rows = _entry_rows(A.row_ptr, nnz)
    slots = (torch.arange(nnz, device=dev)
             - A.row_ptr[:-1].long()[rows])
    col = torch.full((m, K), -1, dtype=torch.int32, device=dev)
    val = torch.zeros((m, K), dtype=A.dtype, device=dev)
    col[rows, slots] = A.col_ind[:nnz]
    val[rows, slots] = A.values[:nnz]
    return ELL(col_ind=col, values=val, nnz_row=A.nnz_row,
               nnz=A.nnz.clone(), shape=A.shape)


def ell_to_csr(A: ELL) -> CSR:
    """Left-justified ELL -> CSR of capacity nrows*K (tail = ncols)."""
    m, K = A.col_ind.shape
    dev = A.device
    row_ptr = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(A.nnz_row, 0, dtype=torch.int32)
    valid = (torch.arange(K, device=dev)[None, :]
             < A.nnz_row[:, None])
    cap = m * K
    col = torch.full((cap,), A.ncols, dtype=torch.int32, device=dev)
    val = torch.zeros(cap, dtype=A.dtype, device=dev)
    n = int(valid.sum())
    col[:n] = A.col_ind[valid]
    val[:n] = A.values[valid]
    return CSR(row_ptr=row_ptr, col_ind=col, values=val,
               nnz=A.nnz.clone(), shape=A.shape)


def bcsr_to_csr(A: BlockCSR) -> CSR:
    """BlockCSR -> exact CSR: drop each span's padding slots (capacity
    nblocks*128, tail = ncols)."""
    nb = A.capacity_blocks
    m = A.nrows
    dev = A.device
    row_ptr = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(A.nnz_row, 0, dtype=torch.int32)
    bp = A.blk_ptr.long()
    used = int(bp[-1])
    row_of = _entry_rows(A.blk_ptr, used)                # (used,)
    inrow = ((torch.arange(used, device=dev) - bp[:-1][row_of])[:, None]
             * 128 + torch.arange(128, device=dev)[None, :])
    valid = inrow < A.nnz_row.long()[row_of][:, None]
    cap = max(nb * 128, 1)
    col = torch.full((cap,), A.ncols, dtype=torch.int32, device=dev)
    val = torch.zeros(cap, dtype=A.dtype, device=dev)
    n = int(valid.sum())
    col[:n] = A.col_blocks[:used][valid]
    val[:n] = A.val_blocks[:used][valid]
    return CSR(row_ptr=row_ptr, col_ind=col, values=val,
               nnz=A.nnz.clone(), shape=A.shape)


def transpose_csr(A: CSR) -> CSR:
    """Host transpose (reference Transpose_CSR, csr/common_csr.h:52-82)."""
    return CSR.from_scipy(A.to_scipy().T.astype(
        A.values.cpu().numpy().dtype), device=A.device)
