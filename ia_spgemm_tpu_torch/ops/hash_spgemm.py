"""Hash-accumulator SpGEMM, the NSPARSE class slot (PyTorch port of
``ia_spgemm_tpu.ops.hash_spgemm``).

The reference names an NSPARSE hash-class algorithm it never ships
(main.cu:526,543-544); the JAX package keeps one open-addressing table
per output row (multiply-shift hash, linear probe) in the TPU's scalar
memory. Here kernel K12 (``ops/hash_kernels.py``, ``csrc/hash.cu``)
keeps each row's table in shared memory and inserts the row's products
in parallel.

The viability arithmetic is the JAX package's, unchanged (its SMEM
budget for 8-row tiles of tables plus B's stream buffers), so the same
inputs are accepted; a refit to the card's shared memory is ROADMAP
work. The output is an ELL whose slots are in hash order with holes:
``convert.compact_ell`` left-justifies it.
"""

from __future__ import annotations

import torch

from ia_spgemm_tpu_torch.formats.types import ELL
from ia_spgemm_tpu_torch.ops import hash_kernels as HK

DEFAULT_TILE_ROWS = 8
# The JAX package's SMEM budget for the per-tile hash tables.
SMEM_BUDGET_BYTES = 256 * 1024


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _table_bytes(H: int, kb: int, tile_rows: int) -> int:
    return tile_rows * H * 8 + 2 * 8 * 2 * max(_next_pow2(max(kb, 1)),
                                               128) * 4


def hash_viable(ka: int, kb: int, ncols: int,
                tile_rows: int = DEFAULT_TILE_ROWS) -> bool:
    """True when the JAX package's per-tile hash tables + B stream buffers
    fit its SMEM budget: the arithmetic spgemm_hash applies."""
    H = max(min(_next_pow2(2 * max(ka, 1) * max(kb, 1)),
                _next_pow2(2 * max(ncols, 1))), 8)
    return _table_bytes(H, kb, tile_rows) <= SMEM_BUDGET_BYTES


def spgemm_hash(A: ELL, B: ELL, *, table_size: int | None = None,
                tile_rows: int = DEFAULT_TILE_ROWS) -> ELL:
    """C = A @ B through per-row hash tables (K12), float32. Returns an
    ELL with hash-ordered slots (compact_ell / to_scipy give the
    canonical form). ValueError for non-float32 operands, past the
    budget, and for a table_size below min(ncols, Ka*Kb), which could
    leave a row's columns without a slot."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    for v in (A.values, B.values):
        if v.element_size() > 4:
            raise ValueError(
                f"spgemm_hash computes in f32 (packed int32 value bits); "
                f"got {v.dtype}. Cast explicitly or use the ESC/bitonic "
                "paths, which keep f64/compensated accumulation.")
    Ka, Kb = A.max_nnz_per_row, B.max_nnz_per_row
    # upper bound on a row's nnz, padded for load factor
    H = table_size or min(_next_pow2(2 * Ka * Kb), _next_pow2(2 * B.ncols))
    H = max(H, 8)
    t_bytes = _table_bytes(H, Kb, tile_rows)
    if t_bytes > SMEM_BUDGET_BYTES:
        raise ValueError(
            f"hash tables exceed the SMEM budget ({t_bytes} > "
            f"{SMEM_BUDGET_BYTES}); use the ESC/bitonic paths")
    if H < min(B.ncols, Ka * Kb):
        raise ValueError(f"table_size {H} < min(ncols, Ka*Kb) = "
                         f"{min(B.ncols, Ka * Kb)}: a row may not fit")
    col, val, nnz_row = HK.hash_accumulate(
        A.col_ind, A.values.to(torch.float32), B.col_ind,
        B.values.to(torch.float32), table_size=H)
    return ELL(col_ind=col, values=val, nnz_row=nnz_row[:, 0],
               nnz=nnz_row.sum(dtype=torch.int32), shape=(A.nrows, B.ncols))
