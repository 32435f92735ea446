"""Format conversions and the reference's size guards (PyTorch port of
``ia_spgemm_tpu.formats.convert``, semantics only).

Size formulas replicate the reference byte for byte (sizeof(int)=4,
VALUE_TYPE=double=8): sizeofcsr (csr/common_csr.h:196-202), sizeofdia
(dia/common_dia.h:20-26), sizeofell (ell/common_ell.h:21-27) and
sizeofcoo (coo/common_coo.h:20-26). A guard rejects a format when its
size exceeds ratio x CSR (50x on CPU, 20x on GPU; dia/common_dia.h:56).

Every conversion runs on the device its input lives on; only the
planners (ELL width, DIA offsets, transposition) read the row pointer
and columns on the host, and ``dia_to_csr`` / ``dense_to_csr`` compact
through scipy on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ia_spgemm_tpu_torch import config as cfg
from ia_spgemm_tpu_torch.formats.types import (CSR, COO, DIA, ELL, BlockCSR,
                                               Dense)


def sizeof_csr(nrows: int, nnz: int) -> float:
    """csr/common_csr.h:196-202."""
    return cfg.SIZEOF_INDEX * (nrows + 1 + nnz + 3) + cfg.SIZEOF_VALUE * nnz


def sizeof_dia(nrows: int, ncols: int, num_diagonals: int) -> float:
    """dia/common_dia.h:20-26."""
    return (cfg.SIZEOF_INDEX * (nrows + ncols - 1 + num_diagonals + 3)
            + cfg.SIZEOF_VALUE * (nrows * num_diagonals))


def sizeof_ell(nrows: int, max_nnz_per_row: int) -> float:
    """ell/common_ell.h:21-27."""
    return (cfg.SIZEOF_INDEX * (nrows + nrows * max_nnz_per_row + 4)
            + cfg.SIZEOF_VALUE * (nrows * max_nnz_per_row))


def sizeof_coo(nrows: int, nnz: int) -> float:
    """coo/common_coo.h:20-26."""
    return cfg.SIZEOF_INDEX * (nrows + 1 + 2 * nnz + 3) + cfg.SIZEOF_VALUE * nnz


def dia_viable(nrows, ncols, nnz, num_diagonals,
               ratio: float = cfg.SIZE_GUARD_RATIO_CPU) -> bool:
    return sizeof_dia(nrows, ncols, num_diagonals) < ratio * sizeof_csr(
        nrows, nnz)


def ell_viable(nrows, nnz, max_nnz_per_row,
               ratio: float = cfg.SIZE_GUARD_RATIO_CPU) -> bool:
    return sizeof_ell(nrows, max_nnz_per_row) < ratio * sizeof_csr(nrows, nnz)


def coo_viable(nrows, nnz, ratio: float = cfg.SIZE_GUARD_RATIO_CPU) -> bool:
    return sizeof_coo(nrows, nnz) < ratio * sizeof_csr(nrows, nnz)


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


def compact_ell(A: ELL) -> ELL:
    """Left-justify an ELL whose rows carry interior holes (col < 0), as
    the hash route emits, keeping the slots' order: the invariant
    ell_to_csr relies on."""
    m, K = A.col_ind.shape
    dev = A.device
    valid = A.col_ind >= 0
    slot = torch.cumsum(valid, dim=1) - 1
    dst = torch.where(valid, slot, K)
    col = torch.full((m, K + 1), -1, dtype=torch.int32, device=dev)
    val = torch.zeros((m, K + 1), dtype=A.dtype, device=dev)
    col.scatter_(1, dst, A.col_ind)
    val.scatter_(1, dst, A.values)
    return ELL(col_ind=col[:, :K].contiguous(),
               values=val[:, :K].contiguous(), nnz_row=A.nnz_row,
               nnz=A.nnz, shape=A.shape)


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


def csr_to_coo(A: CSR) -> COO:
    """CSR -> COO (coo/common_coo.h:29-66): per-entry rows, tail nrows."""
    nnz = int(A.nnz)
    row_ind = torch.full((A.capacity,), A.nrows, dtype=torch.int32,
                         device=A.device)
    row_ind[:nnz] = _entry_rows(A.row_ptr, nnz).to(torch.int32)
    return COO(row_offset=A.row_ptr, row_ind=row_ind, col_ind=A.col_ind,
               values=A.values, nnz=A.nnz, shape=A.shape)


def coo_to_csr(A: COO) -> CSR:
    return CSR(row_ptr=A.row_offset, col_ind=A.col_ind, values=A.values,
               nnz=A.nnz, shape=A.shape)


def plan_dia_offsets(A: CSR) -> np.ndarray:
    """Host planner: ascending offsets (col - row) of the occupied
    diagonals (dia/common_dia.h:36-71)."""
    nnz = int(A.nnz)
    ci = A.col_ind[:nnz].cpu().numpy().astype(np.int64)
    ri = np.repeat(np.arange(A.nrows, dtype=np.int64),
                   np.diff(A.row_ptr.cpu().numpy()))
    return np.unique(ci - ri).astype(np.int32)


def _diag_index(offsets: torch.Tensor, nrows: int, ncols: int):
    """Dense diagonal index (offset + nrows - 1) -> slot, -1 if absent."""
    diag_ind = torch.full((nrows + ncols - 1,), -1, dtype=torch.int32,
                          device=offsets.device)
    diag_ind[offsets.long() + (nrows - 1)] = torch.arange(
        offsets.shape[0], dtype=torch.int32, device=offsets.device)
    return diag_ind


def csr_to_dia(A: CSR, offsets: np.ndarray | None = None,
               check_guard: bool = True,
               ratio: float = cfg.SIZE_GUARD_RATIO_CPU) -> DIA | None:
    """CSR -> DIA (dia/common_dia.h:29-96); None when the guard rejects
    it. Entries on a diagonal missing from a caller's `offsets` are
    dropped."""
    offs = plan_dia_offsets(A) if offsets is None else np.asarray(offsets)
    nd = len(offs)
    if check_guard and not dia_viable(A.nrows, A.ncols, int(A.nnz), nd,
                                      ratio):
        return None
    if nd == 0:
        offs = np.zeros(1, np.int32)
        nd = 1
    m, n, dev = A.nrows, A.ncols, A.device
    nnz = int(A.nnz)
    offs_d = torch.from_numpy(np.asarray(offs, np.int32)).to(dev)
    diag_ind = _diag_index(offs_d, m, n)
    row = _entry_rows(A.row_ptr, nnz)
    slot = diag_ind[A.col_ind[:nnz].long() - row + (m - 1)].long()
    keep = slot >= 0
    vals = torch.zeros((m, nd), dtype=A.dtype, device=dev)
    vals[row[keep], slot[keep]] = A.values[:nnz][keep]
    return DIA(offsets=offs_d, values=vals, diag_ind=diag_ind, nnz=A.nnz,
               shape=A.shape)


def dia_to_csr(A: DIA, capacity: int | None = None) -> CSR:
    """On the host through scipy (the capacity is data-dependent)."""
    return CSR.from_scipy(A.to_scipy(), capacity=capacity, device=A.device)


def csr_to_dense(A: CSR) -> Dense:
    """CSR -> Dense (dense/common_dense.h:20-40); duplicates add."""
    nnz = int(A.nnz)
    flat = (_entry_rows(A.row_ptr, nnz) * A.ncols
            + A.col_ind[:nnz].long())
    out = torch.zeros(A.nrows * A.ncols, dtype=A.dtype, device=A.device)
    out.index_add_(0, flat, A.values[:nnz])
    return Dense(values=out.reshape(A.nrows, A.ncols))


def dense_to_csr(A: Dense, capacity: int | None = None,
                 tol: float = 0.0) -> CSR:
    """On the host through scipy: the dense matrix's nonzeros (|x| > tol
    when tol > 0)."""
    import scipy.sparse as sp
    arr = A.values.cpu().numpy()
    if tol > 0:
        arr = np.where(np.abs(arr) <= tol, 0, arr)
    return CSR.from_scipy(sp.csr_matrix(arr), capacity=capacity,
                          device=A.device)


def transpose_csr(A: CSR) -> CSR:
    """Host transpose (reference Transpose_CSR, csr/common_csr.h:52-82)."""
    return CSR.from_scipy(A.to_scipy().T.astype(
        A.values.cpu().numpy().dtype), device=A.device)
