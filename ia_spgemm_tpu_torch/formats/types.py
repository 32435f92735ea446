"""Sparse storage formats as dataclasses of torch tensors.

Counterparts of ``ia_spgemm_tpu.formats.types`` with the same fields and
padding conventions, so an array taken from a JAX pytree (``np.asarray``)
drops straight into ``from_numpy``:

- CSR tail entries have ``col_ind == ncols`` and ``values == 0``;
- ELL empty slots have ``col_ind == -1`` and ``values == 0``;
- BlockCSR rows own whole 128-slot blocks ``[blk_ptr[i], blk_ptr[i+1])``,
  the first ``nnz_row[i]`` slots valid with ascending columns, the rest of
  the span (and every block past ``blk_ptr[nrows]``) ``-1`` / ``0``.

``nnz`` is a 0-d int32 tensor on the operands' device, as in the JAX
package, so producing a result never waits on the device. Every tensor
of one value lives on one device; ``.to(device)`` moves them together.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

Shape2 = Tuple[int, int]


def _t(x, dtype, device) -> torch.Tensor:
    """A copy of x (arrays of a JAX pytree are read-only) on device."""
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def _value_dtype(x) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.asarray(x).dtype)).dtype


def _moved(obj, device):
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return type(obj)(**{k: v.to(device) if isinstance(v, torch.Tensor)
                        else v for k, v in kw.items()})


@dataclasses.dataclass
class CSR:
    """Compressed sparse row (reference detail/format.h:29-39)."""

    row_ptr: torch.Tensor   # (nrows+1,) int32, row_ptr[-1] == nnz
    col_ind: torch.Tensor   # (capacity,) int32, tail padded with ncols
    values: torch.Tensor    # (capacity,) float
    nnz: torch.Tensor       # 0-d int32
    shape: Shape2

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def capacity(self) -> int:
        return self.col_ind.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz_row(self) -> torch.Tensor:
        return (self.row_ptr[1:] - self.row_ptr[:-1]).to(torch.int32)

    @classmethod
    def from_numpy(cls, row_ptr, col_ind, values, nnz, shape: Shape2,
                   device="cpu") -> "CSR":
        return cls(row_ptr=_t(row_ptr, torch.int32, device),
                   col_ind=_t(col_ind, torch.int32, device),
                   values=_t(values, _value_dtype(values), device),
                   nnz=_t(nnz, torch.int32, device),
                   shape=(int(shape[0]), int(shape[1])))

    @classmethod
    def from_scipy(cls, mat, capacity: int | None = None,
                   device="cpu") -> "CSR":
        m = mat.tocsr()
        m.sum_duplicates()
        nnz = int(m.nnz)
        cap = capacity or max(nnz, 1)
        col = np.full(cap, m.shape[1], dtype=np.int32)
        val = np.zeros(cap, dtype=m.data.dtype)
        col[:nnz] = m.indices
        val[:nnz] = m.data
        return cls.from_numpy(m.indptr, col, val, nnz, m.shape, device)

    def to(self, device) -> "CSR":
        return _moved(self, device)

    def to_scipy(self):
        import scipy.sparse as sp
        nnz = int(self.nnz)
        return sp.csr_matrix(
            (self.values[:nnz].cpu().numpy().astype(np.float64),
             self.col_ind[:nnz].cpu().numpy(), self.row_ptr.cpu().numpy()),
            shape=self.shape)

    def checksum(self) -> torch.Tensor:
        """Sum of stored values, the reference's `verified_sum`."""
        return self.values.sum()


@dataclasses.dataclass
class ELL:
    """ELLPACK: left-justified padded rows (reference format.h:65-76)."""

    col_ind: torch.Tensor   # (nrows, K) int32, empty slots == -1
    values: torch.Tensor    # (nrows, K) float, empty slots == 0
    nnz_row: torch.Tensor   # (nrows,) int32
    nnz: torch.Tensor       # 0-d int32
    shape: Shape2

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def max_nnz_per_row(self) -> int:
        return self.col_ind.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @classmethod
    def from_numpy(cls, col_ind, values, nnz_row, nnz, shape: Shape2,
                   device="cpu") -> "ELL":
        return cls(col_ind=_t(col_ind, torch.int32, device),
                   values=_t(values, _value_dtype(values), device),
                   nnz_row=_t(nnz_row, torch.int32, device),
                   nnz=_t(nnz, torch.int32, device),
                   shape=(int(shape[0]), int(shape[1])))

    @classmethod
    def from_scipy(cls, mat, device="cpu") -> "ELL":
        from ia_spgemm_tpu_torch.formats.convert import csr_to_ell
        return csr_to_ell(CSR.from_scipy(mat, device=device),
                          check_guard=False)

    def to(self, device) -> "ELL":
        return _moved(self, device)

    def to_scipy(self):
        import scipy.sparse as sp
        col = self.col_ind.cpu().numpy()
        val = self.values.cpu().numpy()
        mask = col >= 0
        rows = np.broadcast_to(
            np.arange(self.nrows)[:, None], col.shape)[mask]
        return sp.coo_matrix((val[mask], (rows, col[mask])),
                             shape=self.shape).tocsr()

    def checksum(self) -> torch.Tensor:
        return self.values.sum()


@dataclasses.dataclass
class BlockCSR:
    """128-aligned padded CSR, the width-class route's output layout.

    Row i's entries occupy whole 128-slot blocks [blk_ptr[i], blk_ptr[i+1])
    of the (capacity_blocks, 128) block arrays; the first nnz_row[i] slots
    are valid, the rest of the span is col -1 / value 0. A producer may fix
    spans at plan time (per width class), so a span may exceed
    ceil(nnz/128) blocks."""

    blk_ptr: torch.Tensor     # (nrows+1,) int32 block offsets
    col_blocks: torch.Tensor  # (capacity_blocks, 128) int32, padding -1
    val_blocks: torch.Tensor  # (capacity_blocks, 128) float, padding 0
    nnz_row: torch.Tensor     # (nrows,) int32
    nnz: torch.Tensor         # 0-d int32
    shape: Shape2

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def capacity_blocks(self) -> int:
        return self.col_blocks.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.val_blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.val_blocks.device

    @classmethod
    def from_numpy(cls, blk_ptr, col_blocks, val_blocks, nnz_row, nnz,
                   shape: Shape2, device="cpu") -> "BlockCSR":
        return cls(blk_ptr=_t(blk_ptr, torch.int32, device),
                   col_blocks=_t(col_blocks, torch.int32, device),
                   val_blocks=_t(val_blocks, _value_dtype(val_blocks),
                                 device),
                   nnz_row=_t(nnz_row, torch.int32, device),
                   nnz=_t(nnz, torch.int32, device),
                   shape=(int(shape[0]), int(shape[1])))

    @classmethod
    def from_scipy(cls, mat, device="cpu") -> "BlockCSR":
        """Tight spans: row i owns ceil(nnz_i / 128) blocks."""
        m = mat.tocsr()
        m.sum_duplicates()
        lens = np.diff(m.indptr).astype(np.int64)
        bpr = -(-lens // 128)
        blk_ptr = np.concatenate([[0], np.cumsum(bpr)])
        nb = max(int(blk_ptr[-1]), 1)
        col = np.full(nb * 128, -1, np.int32)
        val = np.zeros(nb * 128, m.data.dtype)
        dst = (np.repeat(blk_ptr[:-1] * 128, lens)
               + np.arange(m.nnz) - np.repeat(m.indptr[:-1], lens))
        col[dst] = m.indices
        val[dst] = m.data
        return cls.from_numpy(blk_ptr, col.reshape(nb, 128),
                              val.reshape(nb, 128), lens, m.nnz, m.shape,
                              device)

    def to(self, device) -> "BlockCSR":
        return _moved(self, device)

    def padded_bytes(self) -> int:
        """Bytes of C in this format, used blocks with their padding."""
        itemsize = self.val_blocks.element_size()
        return (int(self.blk_ptr[-1]) * 128 * (4 + itemsize)
                + 4 * (self.nrows + 1))

    def to_scipy(self):
        import scipy.sparse as sp
        bp = self.blk_ptr.cpu().numpy().astype(np.int64)
        total = int(bp[-1])
        col = self.col_blocks[:total].cpu().numpy().reshape(-1)
        val = self.val_blocks[:total].cpu().numpy().reshape(-1)
        rows = np.repeat(np.arange(self.nrows), (bp[1:] - bp[:-1]) * 128)
        mask = col >= 0
        return sp.coo_matrix((val[mask], (rows[mask], col[mask])),
                             shape=self.shape).tocsr()

    def checksum(self) -> torch.Tensor:
        return self.val_blocks.sum()
