"""DIA x DIA SpGEMM, diagonal algebra (PyTorch port of
``ia_spgemm_tpu.ops.dia``, which is a plain XLA ``lax.scan``).

A diagonal of C at offset dC = dA + dB receives, for every contributing
pair, the elementwise product of A's dA-column with a dA-shifted view of
B's dB-column (reference dia/common_dia.h:101-195). The JAX package
scans the ndA x ndB pairs one by one; here a chunk of pairs is formed at
once and added into C's diagonal slots with ``index_add_``, in pair
order. The output diagonal set comes from a host planner.
"""

from __future__ import annotations

import numpy as np
import torch

from ia_spgemm_tpu_torch.formats.convert import _diag_index
from ia_spgemm_tpu_torch.formats.types import DIA

# Compute budget in scalar FMAs (pairs x rows), the JAX package's value.
# Past it a dense-ish input would run for minutes, and a device kernel,
# on the TPU or on this card, cannot be cancelled once dispatched: the
# guard rejects before dispatch.
DIA_PAIR_FLOP_BUDGET = 2 ** 28
# products formed per index_add_ (bounds the pair chunk's temporaries)
_CHUNK_ELEMS = 1 << 24


def plan_dia_out_offsets(A: DIA, B: DIA) -> np.ndarray:
    """Host planner: ascending unique {dA + dB} inside C's band (the
    reference's phase-1 occupancy flags, dia/common_dia.h:104-140)."""
    oa = A.offsets.cpu().numpy().astype(np.int64)
    ob = B.offsets.cpu().numpy().astype(np.int64)
    sums = np.unique((oa[:, None] + ob[None, :]).ravel())
    m, n = A.shape[0], B.shape[1]
    sums = sums[(sums >= -(m - 1)) & (sums <= n - 1)]
    if len(sums) == 0:
        sums = np.zeros(1, np.int64)
    return sums.astype(np.int32)


def dia_compute_viable(ndA: int, ndB: int, m: int) -> bool:
    """True when the pair computation fits DIA_PAIR_FLOP_BUDGET."""
    return int(ndA) * int(ndB) * max(int(m), 1) <= DIA_PAIR_FLOP_BUDGET


def _dia_core(a_offs, a_vals, b_offs, b_vals, c_offs, *, m: int, ka: int,
              n: int):
    """Every (dA, dB) diagonal pair, accumulated into C's slots. a_vals
    (m, ndA), b_vals (ka, ndB); returns (m, ndC)."""
    dev = a_vals.device
    nda, ndb = a_offs.shape[0], b_offs.shape[0]
    val_dtype = torch.promote_types(a_vals.dtype, b_vals.dtype)
    rows = torch.arange(m, device=dev)
    c = torch.zeros((c_offs.shape[0], m), dtype=val_dtype, device=dev)
    zero = torch.zeros((), dtype=val_dtype, device=dev)
    step = max(1, _CHUNK_ELEMS // max(m, 1))
    for p0 in range(0, nda * ndb, step):
        p = torch.arange(p0, min(p0 + step, nda * ndb), device=dev)
        pa, pb = p // ndb, p % ndb
        dA = a_offs[pa].long()[:, None]
        dB = b_offs[pb].long()[:, None]
        jmid = rows[None, :] + dA       # middle index: a row of B
        ok = (jmid >= 0) & (jmid < ka)
        bv = b_vals[jmid.clamp(0, ka - 1), pb[:, None]]
        kout = jmid + dB                # output column
        ok = ok & (kout >= 0) & (kout < n)
        prod = torch.where(ok, a_vals[:, pa].T.to(val_dtype)
                           * bv.to(val_dtype), zero)
        slot = torch.searchsorted(c_offs, (dA + dB)[:, 0].to(c_offs.dtype))
        c.index_add_(0, slot.clamp(0, c_offs.shape[0] - 1), prod)
    return c.T.contiguous()


def spgemm_dia(A: DIA, B: DIA, out_offsets: np.ndarray | None = None) -> DIA:
    """C = A @ B with both operands DIA (reference dia/common_dia.h:101-195).

    Raises ValueError past DIA_PAIR_FLOP_BUDGET, before any dispatch."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    m, n = A.nrows, B.ncols
    nda, ndb = A.num_diagonals, B.num_diagonals
    if not dia_compute_viable(nda, ndb, m):
        raise ValueError(
            f"DIA pair computation {nda}x{ndb} over m={m} rows exceeds the "
            f"compute budget ({nda * ndb * m:.2e} > "
            f"{DIA_PAIR_FLOP_BUDGET:.2e} scalar FMAs): it would run for "
            "minutes and cannot be cancelled once dispatched; use the "
            "csr/esc routes for dense-ish inputs")
    c_offs_h = (plan_dia_out_offsets(A, B) if out_offsets is None
                else np.asarray(out_offsets, np.int32))
    c_offs = torch.from_numpy(c_offs_h).to(A.device)
    vals = _dia_core(A.offsets, A.values, B.offsets, B.values, c_offs,
                     m=m, ka=A.ncols, n=n)
    return DIA(offsets=c_offs, values=vals, diag_ind=_diag_index(c_offs, m, n),
               nnz=(vals != 0).sum(dtype=torch.int32), shape=(m, n))
