"""MatrixMarket I/O — host side.

Replaces the reference's NIST mmio C library + inline .mtx→CSR assembly
(reference: IA-SPGEMM-CPU_release/mmio.{h,c}, main.cpp:143-458) with a
vectorized numpy reader. Semantics preserved exactly:

- real / integer / pattern fields (pattern values become 1.0, integer cast
  to float; main.cpp:213-230); complex is rejected (main.cpp:164-168).
- 1-based indices adjusted to 0-based (main.cpp:232-234).
- symmetric / hermitian matrices are expanded to full storage: each
  off-diagonal entry (i, j, v) also contributes (j, i, v)
  (main.cpp:317-333, 373-401).
- CSR assembly is a counting sort by row: within a row, entries keep file
  order, with a symmetric mirror entry landing at the position of its source
  entry's scan order (main.cpp:335-458). We reproduce this with a stable
  sort over the interleaved (original, mirror) entry list, so the resulting
  CSR is bit-identical in layout to the reference's.

This is the PyTorch port's copy of ia_spgemm_tpu.io.mmio (the JAX
package's __init__ imports jax, so the port cannot import it); the
native C++ parser is not used here.
"""

from __future__ import annotations

import dataclasses
import io as _io
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MatrixMarketHeader:
    object: str          # "matrix"
    format: str          # "coordinate" | "array"
    field: str           # "real" | "integer" | "pattern" | "complex"
    symmetry: str        # "general" | "symmetric" | "hermitian" | "skew-symmetric"
    nrows: int
    ncols: int
    nnz_stored: int      # entries in the file (before symmetric expansion)

    @property
    def is_symmetric(self) -> bool:
        # The reference treats hermitian as symmetric (main.cpp:186).
        return self.symmetry in ("symmetric", "hermitian")

    @property
    def is_skew(self) -> bool:
        return self.symmetry == "skew-symmetric"


class MatrixMarketError(ValueError):
    pass


def _parse_banner(line: str) -> Tuple[str, str, str, str]:
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise MatrixMarketError(f"bad MatrixMarket banner: {line!r}")
    return parts[1].lower(), parts[2].lower(), parts[3].lower(), parts[4].lower()


def _skip_comments(f) -> str:
    """Next non-comment, non-blank line; EOF raises instead of spinning
    (readline() returns '' forever at EOF — a truncated file must not
    hang the loader)."""
    line = f.readline()
    while line and (line.startswith("%") or not line.strip()):
        line = f.readline()
    if not line:
        raise MatrixMarketError("unexpected EOF before the size line")
    return line


def _array_stored_count(nrows: int, ncols: int, sym: str) -> int:
    """Entries stored in an `array` body: full column-major for general,
    lower triangle incl./excl. diagonal for symmetric/skew."""
    if sym in ("symmetric", "hermitian"):
        return sum(max(nrows - j, 0) for j in range(ncols))
    if sym == "skew-symmetric":
        return sum(max(nrows - j - 1, 0) for j in range(ncols))
    return nrows * ncols


def read_header(path: str) -> MatrixMarketHeader:
    with open(path, "r") as f:
        obj, fmt, field, sym = _parse_banner(f.readline())
        dims = _skip_comments(f).split()
    if fmt == "coordinate":
        nrows, ncols, nnz = int(dims[0]), int(dims[1]), int(dims[2])
    else:
        nrows, ncols = int(dims[0]), int(dims[1])
        nnz = _array_stored_count(nrows, ncols, sym)
    return MatrixMarketHeader(obj, fmt, field, sym, nrows, ncols, nnz)


def read_mtx(path_or_file) -> Tuple[MatrixMarketHeader, np.ndarray, np.ndarray, np.ndarray]:
    """Read a .mtx file → (header, row_idx, col_idx, values), 0-based,
    WITHOUT symmetric expansion (raw stored entries, file order)."""
    if hasattr(path_or_file, "read"):
        f = path_or_file
        close = False
    else:
        f = open(path_or_file, "r")
        close = True
    try:
        obj, fmt, field, sym = _parse_banner(f.readline())
        if field == "complex":
            # Reference: "data type 'COMPLEX' is not supported" (main.cpp:166).
            raise MatrixMarketError("data type 'COMPLEX' is not supported")
        if fmt not in ("coordinate", "array"):
            raise MatrixMarketError(f"unknown MatrixMarket format {fmt!r}")
        if fmt == "array" and field == "pattern":
            # the MM spec forbids pattern+array (mmio.h:137 valid-typecode
            # table); the reference's mm_read_banner rejects it too
            raise MatrixMarketError("array format cannot be 'pattern'")
        dims = _skip_comments(f).split()
        if fmt == "coordinate":
            nrows, ncols, nnz = int(dims[0]), int(dims[1]), int(dims[2])
        else:
            # mm_read_mtx_array_size (mmio.h:27): dims line is "M N"
            nrows, ncols = int(dims[0]), int(dims[1])
            nnz = nrows * ncols
        body = f.read()
    finally:
        if close:
            f.close()

    if fmt == "array":
        return _read_array_body(obj, field, sym, nrows, ncols, body)

    header = MatrixMarketHeader(obj, fmt, field, sym, nrows, ncols, nnz)
    if nnz == 0:
        return (header, np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float64))

    if field == "pattern":
        arr = np.fromstring(body, sep=" ")
        if arr.size != nnz * 2:
            arr = np.loadtxt(_io.StringIO(body), ndmin=2).reshape(-1)
        arr = arr.reshape(nnz, 2)
        rows = arr[:, 0].astype(np.int64) - 1
        cols = arr[:, 1].astype(np.int64) - 1
        vals = np.ones(len(rows), dtype=np.float64)
    else:
        arr = np.fromstring(body, sep=" ")  # fast path
        if arr.size != nnz * 3:
            arr = np.loadtxt(_io.StringIO(body), ndmin=2).reshape(-1)
        arr = arr.reshape(nnz, 3)
        rows = arr[:, 0].astype(np.int64) - 1
        cols = arr[:, 1].astype(np.int64) - 1
        vals = arr[:, 2].astype(np.float64)
        if field == "integer":
            vals = np.trunc(vals)
    return header, rows.astype(np.int32), cols.astype(np.int32), vals


def _read_array_body(obj, field, sym, nrows, ncols, body):
    """MatrixMarket `array` (dense) body → COO triplets, 0-based.

    Values are listed COLUMN-major (the MM spec / mm_read_mtx_array_size,
    reference mmio.h:27,110). Symmetric/hermitian files store the lower
    triangle including the diagonal; skew-symmetric the strictly-lower
    triangle. Explicit zeros are kept (the file says dense, we report what
    it stores — callers assembling CSR get exactly the stored entries)."""
    if sym in ("symmetric", "hermitian"):
        # column j stores rows j..nrows-1
        reps = np.maximum(nrows - np.arange(ncols, dtype=np.int64), 0)
    elif sym == "skew-symmetric":
        # column j stores rows j+1..nrows-1
        reps = np.maximum(nrows - np.arange(ncols, dtype=np.int64) - 1, 0)
    else:
        reps = np.full(ncols, nrows, dtype=np.int64)
    n_expect = int(reps.sum())
    vals = np.fromstring(body, sep=" ")
    if vals.size != n_expect:
        vals = np.loadtxt(_io.StringIO(body), ndmin=1).reshape(-1)
    if field == "integer":
        vals = np.trunc(vals)
    cols = np.repeat(np.arange(ncols, dtype=np.int64), reps)
    offs = np.concatenate([[0], np.cumsum(reps)[:-1]])
    first_row = (nrows - reps)  # 0 general, j symmetric, j+1 skew
    rows = np.arange(len(cols), dtype=np.int64) - offs[cols] \
        + first_row[cols] if len(cols) else np.zeros(0, np.int64)
    if vals.size != n_expect:
        raise MatrixMarketError(
            f"array body has {vals.size} values, expected {n_expect}")
    header = MatrixMarketHeader(obj, "array", field, sym,
                                nrows, ncols, n_expect)
    return (header, rows.astype(np.int32), cols.astype(np.int32),
            vals.astype(np.float64))


def expand_symmetric(header: MatrixMarketHeader,
                     rows: np.ndarray, cols: np.ndarray, vals: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand symmetric/hermitian storage to full, in the reference's entry
    order: the mirror (j, i, v) of each off-diagonal entry is interleaved
    right after the original (main.cpp:373-401)."""
    if not (header.is_symmetric or header.is_skew):
        return rows, cols, vals
    off = rows != cols
    n_off = int(off.sum())
    n_out = len(rows) + n_off
    r = np.empty(n_out, dtype=rows.dtype)
    c = np.empty(n_out, dtype=cols.dtype)
    v = np.empty(n_out, dtype=vals.dtype)
    # Destination slots: entry k goes to k + (#off-diagonal entries before k);
    # its mirror (if any) goes right after.
    before = np.concatenate([[0], np.cumsum(off)[:-1]])
    dst = np.arange(len(rows)) + before
    r[dst] = rows
    c[dst] = cols
    v[dst] = vals
    mdst = dst[off] + 1
    r[mdst] = cols[off]
    c[mdst] = rows[off]
    v[mdst] = -vals[off] if header.is_skew else vals[off]
    return r, c, v


def coo_to_csr_arrays(nrows: int, rows: np.ndarray, cols: np.ndarray,
                      vals: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Counting sort by row, preserving in-row entry order — bit-identical to
    the reference's two-pass scatter (main.cpp:335-458). Duplicates are kept
    (the reference keeps them too)."""
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=nrows)
    row_ptr = np.zeros(nrows + 1, dtype=np.int32)
    row_ptr[1:] = np.cumsum(counts).astype(np.int32)
    return row_ptr, cols[order].astype(np.int32), vals[order]


def read_mtx_to_csr(path, dtype=np.float64, capacity: int | None = None,
                    device="cpu"):
    """Read a .mtx file to a CSR with symmetric expansion, the
    end-to-end equivalent of the reference's load path
    (main.cpp:143-458). Returns ia_spgemm_tpu_torch.formats.types.CSR on
    `device`."""
    from ia_spgemm_tpu_torch.formats.types import CSR

    header, rows, cols, vals = read_mtx(path)
    rows, cols, vals = expand_symmetric(header, rows, cols, vals)
    row_ptr, col_ind, values = coo_to_csr_arrays(header.nrows, rows, cols, vals)
    nnz = len(col_ind)
    cap = capacity or max(nnz, 1)
    col_pad = np.full(cap, header.ncols, dtype=np.int32)
    val_pad = np.zeros(cap, dtype=dtype)
    col_pad[:nnz] = col_ind
    val_pad[:nnz] = values.astype(dtype)
    return CSR.from_numpy(row_ptr, col_pad, val_pad, nnz,
                          (header.nrows, header.ncols), device)


def write_mtx(path, csr, field: str = "real", comment: str | None = None,
              symmetry: str = "general"):
    """Write a CSR to a MatrixMarket coordinate file.

    Counterpart of mm_write_* (reference: mmio.h:48-59), which can emit any
    typecode: `field` in {real, integer, pattern}, `symmetry` in {general,
    symmetric, skew-symmetric}. For the symmetric typecodes only the lower
    triangle is stored (incl. the diagonal for symmetric, excl. for skew),
    matching what read_mtx + expand_symmetric reconstructs."""
    import numpy as np
    if symmetry not in ("general", "symmetric", "skew-symmetric"):
        raise MatrixMarketError(f"unknown write symmetry {symmetry!r}")
    sp = csr.to_scipy().tocoo()
    rows, cols, data = sp.row, sp.col, sp.data
    if symmetry in ("symmetric", "skew-symmetric"):
        # the dropped upper triangle must be reconstructible, or the
        # file silently corrupts on read-back — verify, don't trust
        m = sp.tocsr()
        mt = m.T.tocsr()
        diff = (m + mt) if symmetry == "skew-symmetric" else (m - mt)
        scale = max(1.0, float(abs(m).max() if m.nnz else 0.0))
        err = float(abs(diff).max()) / scale if diff.nnz else 0.0
        # dtype-aware: f32 results (e.g. A @ A^T with different summation
        # orders per triangle) are symmetric only to ~eps(f32)
        tol = 64 * float(np.finfo(data.dtype).eps) \
            if np.issubdtype(data.dtype, np.floating) else 1e-12
        if err > tol:
            raise MatrixMarketError(
                f"matrix is not {symmetry} (max asymmetry {err:.3g}); "
                "writing it with this typecode would corrupt it")
        keep = (rows >= cols) if symmetry == "symmetric" else (rows > cols)
        rows, cols, data = rows[keep], cols[keep], data[keep]
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"%{line}\n")
        f.write(f"{sp.shape[0]} {sp.shape[1]} {len(rows)}\n")
        # vectorized body (a per-entry Python write loop is interpreter
        # speed — minutes at 50M nnz; the read path is numpy for the
        # same reason)
        if field == "pattern":
            body = np.stack([rows + 1, cols + 1], axis=1)
            np.savetxt(f, body, fmt="%d %d")
        else:
            ij = np.stack([rows + 1, cols + 1], axis=1).astype(np.float64)
            np.savetxt(f, np.concatenate([ij, data[:, None]], axis=1),
                       fmt="%d %d %.17g")
