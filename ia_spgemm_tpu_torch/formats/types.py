"""Sparse storage formats as dataclasses of torch tensors.

Counterparts of ``ia_spgemm_tpu.formats.types`` with the same fields and
padding conventions, so an array taken from a JAX pytree (``np.asarray``)
drops straight into ``from_numpy``:

- CSR / COO tail entries have ``col_ind == ncols`` (COO ``row_ind ==
  nrows``) and ``values == 0``;
- ELL empty slots have ``col_ind == -1`` and ``values == 0``;
- DIA ``values[i, d]`` holds A[i, i + offsets[d]] (0 where the diagonal
  leaves the matrix); ``diag_ind`` maps offset + nrows - 1 to its slot,
  -1 for an absent diagonal;
- BlockCSR rows own whole 128-slot blocks ``[blk_ptr[i], blk_ptr[i+1])``,
  the first ``nnz_row[i]`` slots valid with ascending columns, the rest of
  the span (and every block past ``blk_ptr[nrows]``) ``-1`` / ``0``;
- SlabCSR pad slots have ``keys == -1`` and ``values == 0``.

``nnz`` is a 0-d int32 tensor on the operands' device, as in the JAX
package, so producing a result never waits on the device. Every tensor
of one value lives on one device; ``.to(device)`` moves them together.

Compensated results (``values_lo`` set) carry each value as a float32
pair whose float64 sum ``values + values_lo`` is the value.
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


def _f64(values, values_lo) -> np.ndarray:
    """Host float64 values: hi + lo for compensated results."""
    out = values.cpu().numpy().astype(np.float64)
    if values_lo is not None:
        out += values_lo.cpu().numpy().astype(np.float64)
    return out


def _checksum(values, values_lo) -> torch.Tensor:
    """Sum of the stored values on their device; a compensated pair is
    reduced by ``esc.dd_sum`` and returned as a float64 0-d tensor."""
    if values_lo is None:
        return values.sum()
    from ia_spgemm_tpu_torch.ops.esc import dd_sum
    hi, lo = dd_sum(values.reshape(-1), values_lo.reshape(-1))
    return hi.double() + lo.double()


@dataclasses.dataclass
class CSR:
    """Compressed sparse row (reference detail/format.h:29-39)."""

    row_ptr: torch.Tensor   # (nrows+1,) int32, row_ptr[-1] == nnz
    col_ind: torch.Tensor   # (capacity,) int32, tail padded with ncols
    values: torch.Tensor    # (capacity,) float
    nnz: torch.Tensor       # 0-d int32
    shape: Shape2
    # compensated results: the float32 low halves (values + values_lo is
    # the float64 value); None for plain results
    values_lo: torch.Tensor | None = None

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
                   device="cpu", values_lo=None) -> "CSR":
        return cls(row_ptr=_t(row_ptr, torch.int32, device),
                   col_ind=_t(col_ind, torch.int32, device),
                   values=_t(values, _value_dtype(values), device),
                   nnz=_t(nnz, torch.int32, device),
                   shape=(int(shape[0]), int(shape[1])),
                   values_lo=None if values_lo is None
                   else _t(values_lo, torch.float32, device))

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

    def values_f64(self) -> np.ndarray:
        """Stored values on the host in float64 (hi + lo when
        compensated)."""
        return _f64(self.values, self.values_lo)

    def to_scipy(self):
        import scipy.sparse as sp
        nnz = int(self.nnz)
        return sp.csr_matrix(
            (self.values_f64()[:nnz],
             self.col_ind[:nnz].cpu().numpy(), self.row_ptr.cpu().numpy()),
            shape=self.shape)

    def checksum(self) -> torch.Tensor:
        """Sum of stored values, the reference's `verified_sum`."""
        return _checksum(self.values, self.values_lo)


@dataclasses.dataclass
class COO:
    """Coordinate format with the CSR row pointer kept beside the per-entry
    rows, as the reference's CooMatrix (format.h:16-27)."""

    row_offset: torch.Tensor  # (nrows+1,) int32
    row_ind: torch.Tensor     # (capacity,) int32, tail padded with nrows
    col_ind: torch.Tensor     # (capacity,) int32, tail padded with ncols
    values: torch.Tensor      # (capacity,) float
    nnz: torch.Tensor         # 0-d int32
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

    @classmethod
    def from_scipy(cls, mat, device="cpu") -> "COO":
        from ia_spgemm_tpu_torch.formats.convert import csr_to_coo
        return csr_to_coo(CSR.from_scipy(mat, device=device))

    def to(self, device) -> "COO":
        return _moved(self, device)

    def to_scipy(self):
        import scipy.sparse as sp
        nnz = int(self.nnz)
        return sp.coo_matrix(
            (self.values[:nnz].cpu().numpy(),
             (self.row_ind[:nnz].cpu().numpy(),
              self.col_ind[:nnz].cpu().numpy())), shape=self.shape)

    def checksum(self) -> torch.Tensor:
        return self.values.sum()


@dataclasses.dataclass
class DIA:
    """Diagonal format (reference format.h:53-63): ``offsets[d] = col -
    row`` of occupied diagonal slot d, ascending."""

    offsets: torch.Tensor    # (ndiag,) int32, ascending
    values: torch.Tensor     # (nrows, ndiag) float
    diag_ind: torch.Tensor   # (nrows + ncols - 1,) int32, -1 if absent
    nnz: torch.Tensor        # 0-d int32
    shape: Shape2

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def num_diagonals(self) -> int:
        return self.offsets.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @classmethod
    def from_scipy(cls, mat, device="cpu") -> "DIA":
        from ia_spgemm_tpu_torch.formats.convert import csr_to_dia
        return csr_to_dia(CSR.from_scipy(mat, device=device),
                          check_guard=False)

    def to(self, device) -> "DIA":
        return _moved(self, device)

    def to_scipy(self):
        """Every in-band slot of every stored diagonal, explicit zeros
        included (as the JAX package)."""
        import scipy.sparse as sp
        m, n = self.shape
        offs = self.offsets.cpu().numpy().astype(np.int64)
        vals = self.values.cpu().numpy()
        i = np.arange(m)
        rows, cols, data = [], [], []
        for d, off in enumerate(offs):
            j = i + off
            ok = (j >= 0) & (j < n)
            rows.append(i[ok])
            cols.append(j[ok])
            data.append(vals[ok, d])
        return sp.coo_matrix(
            (np.concatenate(data), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=self.shape).tocsr()

    def checksum(self) -> torch.Tensor:
        return self.values.sum()


@dataclasses.dataclass
class Dense:
    """Dense matrix (reference format.h:7-14)."""

    values: torch.Tensor   # (nrows, ncols)

    @property
    def shape(self) -> Shape2:
        return tuple(self.values.shape)

    @property
    def nrows(self) -> int:
        return self.values.shape[0]

    @property
    def ncols(self) -> int:
        return self.values.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz(self) -> torch.Tensor:
        """Count of nonzero values, a 0-d int32 tensor on the device."""
        return torch.count_nonzero(self.values).to(torch.int32)

    @classmethod
    def from_scipy(cls, mat, device="cpu") -> "Dense":
        return cls(values=torch.from_numpy(np.asarray(mat.toarray())).to(
            device))

    def to(self, device) -> "Dense":
        return Dense(values=self.values.to(device))

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix(self.values.cpu().numpy())

    def checksum(self) -> torch.Tensor:
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


@dataclasses.dataclass
class SlabCSR:
    """Slab-packed CSR, the slab engine's output (``ops/slab.py``): whole
    C rows packed back to back into fixed-width slabs.

    Slab s covers the global rows from ``slab_first_row[s]`` to the next
    slab's first row; its first ``nnz_slab[s]`` slots are valid with
    ascending keys ``(row - slab_first_row[s]) * ncols + col``, the rest
    key -1 / value 0, so ``checksum()`` is one reduction."""

    keys: torch.Tensor            # (S, W) int32
    values: torch.Tensor          # (S, W) float, padding 0
    nnz_slab: torch.Tensor        # (S,) int32 survivors per slab
    slab_first_row: torch.Tensor  # (S,) int32 global row of local row 0
    nnz: torch.Tensor             # 0-d int32
    shape: Shape2
    values_lo: torch.Tensor | None = None   # compensated low halves

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def width(self) -> int:
        return self.keys.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @classmethod
    def from_numpy(cls, keys, values, nnz_slab, slab_first_row, nnz,
                   shape: Shape2, device="cpu", values_lo=None) -> "SlabCSR":
        return cls(keys=_t(keys, torch.int32, device),
                   values=_t(values, _value_dtype(values), device),
                   nnz_slab=_t(nnz_slab, torch.int32, device),
                   slab_first_row=_t(slab_first_row, torch.int32, device),
                   nnz=_t(nnz, torch.int32, device),
                   shape=(int(shape[0]), int(shape[1])),
                   values_lo=None if values_lo is None
                   else _t(values_lo, torch.float32, device))

    def to(self, device) -> "SlabCSR":
        return _moved(self, device)

    def checksum(self) -> torch.Tensor:
        return _checksum(self.values, self.values_lo)

    def to_scipy(self):
        import scipy.sparse as sp
        W = self.keys.shape[1]
        keys = self.keys.cpu().numpy().astype(np.int64)
        vals = (self.values.cpu().numpy() if self.values_lo is None
                else _f64(self.values, self.values_lo))
        nnz_s = self.nnz_slab.cpu().numpy().astype(np.int64)
        sfr = self.slab_first_row.cpu().numpy().astype(np.int64)
        ok = np.arange(W)[None, :] < nnz_s[:, None]
        k = keys[ok]
        lrow = k // self.ncols
        rows = np.repeat(sfr, nnz_s) + lrow
        return sp.coo_matrix((vals[ok], (rows, k - lrow * self.ncols)),
                             shape=self.shape).tocsr()
