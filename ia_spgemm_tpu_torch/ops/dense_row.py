"""Dense-row-accumulator SpGEMM, Gustavson with a dense row (PyTorch port
of ``ia_spgemm_tpu.ops.dense_row``).

The reference's CPU kernels accumulate each output row into a dense
array indexed by column (csr/common_csr.h:130-189). Here A is ELL, B is
taken dense (its densification is conversion time, as any format's), and
kernel K11 (``ops/dense_row_kernels.py``, ``csrc/dense_row.cu``) turns
each A entry into one row-wide multiply-add against the matching B row.
The JAX package's padding of B to the TPU's (8, 128) tiling is not
needed here.
"""

from __future__ import annotations

from ia_spgemm_tpu_torch.formats.types import ELL, Dense
from ia_spgemm_tpu_torch.ops import dense_row_kernels as DK

# The JAX package's row tile (kept for API parity; the kernel tiles by
# row and 1024-column chunk instead).
DEFAULT_TILE_ROWS = 8
# The JAX package's VMEM budget for one accumulator row: n <= 64K floats.
# Kept so the same inputs are accepted (the card has no such limit; a
# refit is ROADMAP work).
MAX_N_F32 = 64 * 1024


def spgemm_dense_row(A: ELL, B: Dense) -> Dense:
    """C = A @ B, A in ELL, B dense; dense-row accumulator (K11)."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if B.ncols > MAX_N_F32:
        raise ValueError(
            f"n={B.ncols} exceeds the dense-row VMEM budget ({MAX_N_F32})")
    return Dense(values=DK.dense_row(A.col_ind, A.values.to(B.dtype),
                                     B.values.contiguous()))
