"""The global ESC engine's expansion kernel: wrapper, plain version, count.

=====  ==========  =====================================================
 K14   esc_expand  none: ops/esc.py:214 _expand_products was plain XLA
=====  ==========  =====================================================

(file:line of the JAX package.) K14 replaces no TPU kernel: the JAX
package left the global engine's expansion to XLA's gathers and scans.
``esc_expand`` returns the intermediate products of C = A @ B as the
stable sort's input, padded to e_cap: (key (e_cap,), value (e_cap,) of
``val_dtype``). Key ``row * n + col`` is int32 where (m+1)(n+1) < 2^31,
else int64 (``key_dtype``). A's first ``a_nnz`` entries own consecutive
slots in entry order, each its B row's entries in B's order; slots past
the products get key m * n and value 0. The wrapper checks its operands,
then: on CUDA tensors it forms the entries' slot offsets (the B row
length of each entry, 0 past a_nnz, and their running sum: one gather
and one 1-D ``torch.cumsum`` over A's entries) and launches the kernel
of ``csrc/esc.cu`` on the current stream, adding one to ``launch.K14``;
on CPU tensors it runs the plain PyTorch version beside it, the
engine's expansion as it was. There is no fallback: a failed build or
launch raises.

The kernel writes the plain version's slots bit for bit (the same keys,
each product rounded once in ``val_dtype``), so the sort and the
duplicate sums after it see the same input on both paths. It needs A's
row pointer non-decreasing (the sliced engine's slab pointer is padded
with its last value), which the wrapper does not check: that would need
a device sync.
"""

from __future__ import annotations

import torch

from ia_spgemm_tpu_torch import tracing
from ia_spgemm_tpu_torch.ops.bitonic_kernels import (_check_tensor,
                                                     _cuda_or_raise, _launch)
from ia_spgemm_tpu_torch.utils.scans import entry_rows, segment_broadcast

_FLOATS = (torch.float32, torch.float64)


def key_dtype(m: int, n: int) -> torch.dtype:
    """The sort key's type: int32 while every key i*n + j and the filler
    m*n fit it, else int64."""
    return torch.int32 if (m + 1) * (n + 1) < 2**31 else torch.int64


# ---------------------------------------------------- plain PyTorch version

def _packed_gather2(x_int, x_f, idx):
    """(x_int[idx], x_f[idx]), as one gather of (int, value-bits) pairs
    for float32 values."""
    if x_f.dtype == torch.float32:
        g = torch.stack([x_int, x_f.view(torch.int32)], dim=1)[idx]
        return g[:, 0], g[:, 1].view(torch.float32)
    return x_int[idx], x_f[idx]


def _delta_broadcast(cols, positions, out_size: int):
    """Per-segment int32 constants broadcast to every covered position:
    each entry's delta to the previous entry is added at its segment
    start, then a cumsum telescopes back to the entry's value. Entries of
    zero length share a start with the next one; their deltas stack and
    still telescope. Positions at/after out_size fall into a dropped
    slot. The sums run in int64, so they never wrap.

    cols: (nnzA_cap, C) int32; positions: (nnzA_cap,) non-decreasing.
    Each constant is scanned as its own 1-D tensor: on CUDA only a 1-D
    cumsum takes the device-wide scan, while a few long rows of a 2-D
    tensor are scanned one block (or, along dim 0, one thread) each."""
    c = cols.long().T
    deltas = torch.cat([c[:, :1], c[:, 1:] - c[:, :-1]], dim=1)
    pos = positions.long().clamp(max=out_size)
    buf = torch.zeros((cols.shape[1], out_size + 1), dtype=torch.int64,
                      device=cols.device)
    buf.index_add_(1, pos, deltas)
    return torch.stack([torch.cumsum(row[:out_size], 0) for row in buf],
                       dim=1).to(torch.int32)


def _expand_products(a_row, a_col_local, a_val, ent_active, b_row_ptr,
                     b_col, b_val, *, e_cap: int, val_dtype):
    """Materialise the intermediate products (i, j, v, valid), padded to
    e_cap, in A-entry order. a_col_local is clipped into B's rows; rows of
    active entries are non-decreasing. val_dtype is the type the products
    are formed in."""
    nnzA_cap = a_col_local.shape[0]
    dev = a_col_local.device
    ent = torch.arange(nnzA_cap, dtype=torch.int32, device=dev)
    ac = a_col_local.long()
    b_start = b_row_ptr[ac]
    b_len = torch.where(ent_active, b_row_ptr[ac + 1] - b_start, 0)
    offs_end = torch.cumsum(b_len, 0, dtype=torch.int32)
    E = offs_end[-1] if nnzA_cap else torch.zeros((), dtype=torch.int32,
                                                   device=dev)
    offs_start = offs_end - b_len
    e = torch.arange(e_cap, dtype=torch.int32, device=dev)
    valid = e < E
    if a_val.dtype == torch.float32:
        cols = torch.stack([a_row.to(torch.int32), a_val.view(torch.int32),
                            b_start - offs_start], dim=1)
        bcast = _delta_broadcast(cols, offs_start, e_cap)
        i = bcast[:, 0]
        av_t = bcast[:, 1].view(torch.float32)
        bpos = bcast[:, 2] + e
    else:
        t = segment_broadcast(ent + 1, offs_start, b_len > 0, e_cap, 0) - 1
        t = t.clamp(0, max(nnzA_cap - 1, 0)).long()
        i = a_row[t]
        av_t = a_val[t]
        bpos = b_start[t] + (e - offs_start[t])
    bpos = bpos.clamp(0, b_col.shape[0] - 1).long()
    j, bv = _packed_gather2(b_col, b_val, bpos)
    v = torch.where(valid, av_t.to(val_dtype) * bv.to(val_dtype),
                    torch.zeros((), dtype=val_dtype, device=dev))
    return i, j, v, valid


def esc_expand_plain(a_row_ptr, a_col, a_val, a_nnz, b_row_ptr, b_col,
                     b_val, *, e_cap: int, m: int, k: int, n: int,
                     val_dtype):
    """The engine's expansion and key formation in plain PyTorch: A's
    entry rows by ``utils/scans.entry_rows``, the products by
    ``_expand_products``, invalid slots keyed m * n."""
    nnzA_cap = a_col.shape[0]
    ent_active = torch.arange(nnzA_cap, device=a_col.device) < a_nnz
    i, j, v, valid = _expand_products(
        entry_rows(a_row_ptr, nnzA_cap), a_col.clamp(0, k - 1), a_val,
        ent_active, b_row_ptr, b_col, b_val, e_cap=e_cap,
        val_dtype=val_dtype)
    kd = key_dtype(m, n)
    # the filler is a Python scalar, not a tensor made on the host:
    # copying one from pageable memory would hold the host until the
    # card caught up, in every call
    return torch.where(valid, i.to(kd) * n + j.to(kd), m * n), v


# ------------------------------------------------------------------ wrapper

def _check_operands(a_row_ptr, a_col, a_val, b_row_ptr, b_col, b_val, m,
                    k, n, e_cap, val_dtype):
    dev = a_col.device
    for name, t, size in (("a_row_ptr", a_row_ptr, m + 1),
                          ("a_col", a_col, None),
                          ("b_row_ptr", b_row_ptr, k + 1),
                          ("b_col", b_col, None)):
        _check_tensor(name, t, torch.int32, 1, dev)
        if size is not None and t.shape[0] != size:
            raise ValueError(f"{name} has {t.shape[0]} entries, want {size}")
    for name, t, cols in (("a_val", a_val, a_col), ("b_val", b_val, b_col)):
        _check_tensor(name, t, t.dtype, 1, dev)
        if t.shape != cols.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must match its "
                             f"columns {tuple(cols.shape)}")
    if not (0 <= e_cap < 2**31 and m >= 0 and k >= 0 and 0 <= n < 2**31):
        raise ValueError(f"e_cap {e_cap}, m {m}, k {k}, n {n} out of range")
    if dev.type == "cpu":
        return
    if (a_val.dtype not in _FLOATS or b_val.dtype not in _FLOATS
            or val_dtype not in _FLOATS):
        raise TypeError(f"values {a_val.dtype} x {b_val.dtype} -> "
                        f"{val_dtype}: K14 takes float32 and float64")
    if val_dtype == torch.float32 and torch.float64 in (a_val.dtype,
                                                        b_val.dtype):
        raise TypeError("float64 operands form float64 products")


def esc_expand(a_row_ptr, a_col, a_val, a_nnz, b_row_ptr, b_col, b_val, *,
               e_cap: int, m: int, k: int, n: int, val_dtype=None):
    """K14: the global engine's products as (key, value), padded to
    e_cap. a_row_ptr (m+1,) int32; a_col, a_val (nnzA_cap,); a_nnz an int
    or a 0-d tensor; b_row_ptr (k+1,) int32; b_col, b_val (nnzB_cap,).
    val_dtype (default: the operands' promoted type) is the type the
    products are formed in."""
    if val_dtype is None:
        val_dtype = torch.promote_types(a_val.dtype, b_val.dtype)
    _check_operands(a_row_ptr, a_col, a_val, b_row_ptr, b_col, b_val, m, k,
                    n, e_cap, val_dtype)
    dev = a_col.device
    if dev.type == "cpu":
        return esc_expand_plain(a_row_ptr, a_col, a_val, a_nnz, b_row_ptr,
                                b_col, b_val, e_cap=e_cap, m=m, k=k, n=n,
                                val_dtype=val_dtype)
    _cuda_or_raise(a_col)
    kd = key_dtype(m, n)
    key = torch.empty(e_cap, dtype=kd, device=dev)
    val = torch.empty(e_cap, dtype=val_dtype, device=dev)
    if e_cap:
        nnzA_cap = a_col.shape[0]
        ac = a_col.clamp(0, k - 1).long()
        b_len = torch.where(
            torch.arange(nnzA_cap, device=dev) < a_nnz,
            b_row_ptr[ac + 1] - b_row_ptr[ac], 0)
        offs_end = torch.cumsum(b_len, 0, dtype=torch.int32)
        types = ((a_val.dtype == torch.float64)
                 | (b_val.dtype == torch.float64) << 1
                 | (val_dtype == torch.float64) << 2
                 | (kd == torch.int64) << 3)
        _launch("ia_k14_esc_expand", a_row_ptr, a_col, a_val, b_row_ptr,
                b_col, b_val, offs_end, key, val, nnzA_cap, m, k, n,
                b_col.shape[0], e_cap, types, device=dev)
        tracing.count("launch.K14")
    return key, val


KERNELS = {"K14": esc_expand}


def reset_launch_counts():
    tracing.reset_launches(KERNELS)


def launch_counts() -> dict:
    return tracing.launches(KERNELS)
