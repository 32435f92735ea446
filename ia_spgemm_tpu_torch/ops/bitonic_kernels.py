"""The bitonic routes' kernels: wrappers, plain versions, counts.

=====  ==========================  ==========================================
 K1    expand_sort_compress        ops/bitonic.py:1034 _expand_sort_compress_kernel_t
 K2    expand_sort                 ops/bitonic.py:977  _expand_sort_kernel_t
 K3    compress                    ops/bitonic.py:523  _compress_kernel_t
 K4    sort_compress_rows          ops/bitonic.py:241  _kernel
 K5    sort_compress               ops/bitonic.py:657  _fused_kernel_t
 K6    sort_only                   ops/bitonic.py:346  _sort_only_kernel_t
 K7a   expand_sort_packed          ops/bitonic.py:1056 _expand_sort_kernel_packed
 K7b   compress_packed             ops/bitonic.py:1086 _compress_kernel_packed
=====  ==========================  ==========================================

K7a/K7b are the bf16 serve lane: each product rounds to bfloat16 and
travels with its column in one int32 sort key (``_pack_colval``). K5 and
K6 sort rows the torch expand (``ops/bitonic._expand_ell``) wrote to
device memory, the JAX package's cols layout; K5 compresses them too, K6
leaves that to K3. K3-K6 take float32 or float64 values (a float64 key /
value pair launches the kernel's ``_f64`` instance) and return values of
the same type; K1, K2 and K7 take float32. K2 reads either source below;
K7a reads the table.

(file:line of the JAX package.) Each wrapper checks its operands, then:
on CUDA tensors it launches the hand-written kernel of
``csrc/bitonic.cu`` on the current stream and adds one to its launch
counter (``launch.<K>`` in ``tracing``); on CPU tensors it runs the plain
PyTorch version of the same function (the ``*_plain`` function beside
it). There is no fallback: a failed build or launch raises.

Layouts (row-major, one output row per matrix row):

- ``g`` (ceil(ka/pack), m, lanes) int32: per fragment e, packed row
  e // pack holds [col_f | val_bits_f | col_rev | val_bits_rev] of one B
  sub-run of length ``run`` at lane offset (e % pack) * 4 * run; col -1
  marks an empty slot. ``avT`` (ka, m) float32: the A value of fragment e.
- or (K2, K7a) the wide B table ``table`` (F + 1, lanes) int32, one such
  [col_f | val_bits_f | col_rev | val_bits_rev] row per B sub-run (lanes
  >= 4 * run, a multiple of 4; the last row all -1, for empty slots) and
  the fragment index ``rT`` (ka, m) int32: fragment e of row r is table
  row rT[e, r], so that g = table[rT] at pack 1 (``table_gather``). The
  kernels read the table through rT themselves, with no gathered copy of
  its rows; the wrappers do not check that rT's values lie in the table,
  which would need a device sync.
- products of fragment e occupy slots [e*run, (e+1)*run) of the row, the
  reversed half for odd e, so the row holds alternating ascending and
  descending runs and the sort may start merging at ``start_kk = 2*run``.
- ``key``/``val`` (m, width): pre-expanded rows in the same run layout
  (K3-K6), SENTINEL / 0 in empty slots.
- outputs: col (m, out_w) int32 (-1 = empty), val (m, out_w) in the
  values' type (0 = empty), nnz (m, 1) int32 = survivors per row (not
  capped by out_w).

The plain versions sort stably (``torch.sort``) and sum duplicates with
``index_add_`` in slot order; the kernels' bitonic network is not stable,
so duplicate sums agree to the values' rounding, and structure exactly.
"""

from __future__ import annotations

import torch

from ia_spgemm_tpu_torch import tracing

SENTINEL = 2**31 - 1
MIN_WIDTH = 128
MAX_WIDTH = 16384


# ---------------------------------------------------------------- checks

def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def _check_width(width: int, start_kk: int | None = None):
    if not (_is_pow2(width) and MIN_WIDTH <= width <= MAX_WIDTH):
        raise ValueError(f"width {width} must be a power of two in "
                         f"[{MIN_WIDTH}, {MAX_WIDTH}]")
    if start_kk is not None and not (_is_pow2(start_kk) and start_kk >= 2):
        raise ValueError(f"start_kk {start_kk} must be a power of two >= 2")


def _check_tensor(name, t, dtype, ndim, device):
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: want {ndim}-d {dtype}, got "
                        f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_table(table, rT, avT, ka, run, width, index="rT"):
    """A B table read through a fragment index (K2, K7a; K8 and K9 with
    index "mt"): table (F, lanes) int32 with lanes >= 4 * run and a
    multiple of 4, the index int32 and avT float32, both (ka, m), all on
    avT's device."""
    dev = avT.device
    _check_tensor("table", table, torch.int32, 2, dev)
    _check_tensor(index, rT, torch.int32, 2, dev)
    _check_tensor("avT", avT, torch.float32, 2, dev)
    if rT.shape != avT.shape or rT.shape[0] != ka:
        raise ValueError(f"{index} {tuple(rT.shape)} / avT "
                         f"{tuple(avT.shape)} must both be ({ka}, m)")
    lanes = table.shape[1]
    if table.shape[0] < 1 or lanes < 4 * run or lanes % 4:
        raise ValueError(f"table shape {tuple(table.shape)}: want (F >= 1, "
                         f"lanes >= {4 * run}, a multiple of 4)")
    if ka * run > width:
        raise ValueError(f"ka*run = {ka * run} > width {width}")


def _check_gather(g, avT, ka, run, width, pack):
    dev = avT.device
    _check_tensor("g", g, torch.int32, 3, dev)
    _check_tensor("avT", avT, torch.float32, 2, dev)
    m = avT.shape[1]
    if avT.shape[0] != ka:
        raise ValueError(f"avT rows {avT.shape[0]} != ka {ka}")
    if g.shape[0] != -(-ka // pack) or g.shape[1] != m:
        raise ValueError(f"g shape {tuple(g.shape)} != "
                         f"({-(-ka // pack)}, {m}, lanes) for ka={ka} "
                         f"pack={pack}")
    if pack * 4 * run > g.shape[2]:
        raise ValueError(f"pack*4*run = {pack * 4 * run} > lanes "
                         f"{g.shape[2]}")
    if ka * run > width:
        raise ValueError(f"ka*run = {ka * run} > width {width}")


_VALUE_TYPES = (torch.float32, torch.float64)


def _check_rows(key, val, width):
    """Pre-expanded rows: int32 keys, float32 or float64 values."""
    dev = key.device
    _check_tensor("key", key, torch.int32, 2, dev)
    if val.dtype not in _VALUE_TYPES:
        raise TypeError(f"val: want float32 or float64, got {val.dtype}")
    _check_tensor("val", val, val.dtype, 2, dev)
    if key.shape != val.shape or key.shape[1] != width:
        raise ValueError(f"key {tuple(key.shape)} / val {tuple(val.shape)} "
                         f"must both be (m, {width})")


def _entry(name: str, val: torch.Tensor) -> str:
    """The C entry point of the kernel instance for val's type."""
    return name + ("_f64" if val.dtype == torch.float64 else "")


def _launch(name, *args, device: torch.device):
    """Call a C entry point on ``device`` (made current for the call
    where it is not already): tensors pass as their device pointers, then
    the device's current stream (its raw handle: building a
    torch.cuda.Stream to read it costs several us of host time a call);
    raise on a CUDA error."""
    from ia_spgemm_tpu_torch import _build
    fn = _build.load()[name]
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if torch.cuda.current_device() == device.index:
        err = fn(*ptrs, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*ptrs,
                     torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _cuda_or_raise(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def _row_outputs(m, out_w, dtype, device):
    """Uninitialised (col, val, nnz) outputs for m rows (the kernel
    writes every slot), values of ``dtype``."""
    return (torch.empty((m, out_w), dtype=torch.int32, device=device),
            torch.empty((m, out_w), dtype=dtype, device=device),
            torch.empty((m, 1), dtype=torch.int32, device=device))


# ---------------------------------------------------- plain PyTorch versions

def _expand_plain(g, avT, ka, run, width, pack):
    """Products (m, width): key SENTINEL / value 0 where the column is
    empty (a select, so NaN A values of padded rows never reach a sum)."""
    m = avT.shape[1]
    dev = avT.device
    e = torch.arange(ka, device=dev)
    off = (e % pack) * 4 * run + (e & 1) * 2 * run           # (ka,)
    lanes = (off[:, None] + torch.arange(run, device=dev))[:, None, :]
    ep = (e // pack)[:, None, None]
    r = torch.arange(m, device=dev)[None, :, None]
    c = g[ep, r, lanes]                                       # (ka, m, run)
    vb = g[ep, r, lanes + run]
    valid = c >= 0
    key = torch.where(valid, c, SENTINEL)
    val = torch.where(valid, avT[:, :, None] * vb.view(torch.float32),
                      torch.zeros((), dtype=torch.float32, device=dev))
    key = key.permute(1, 0, 2).reshape(m, ka * run)
    val = val.permute(1, 0, 2).reshape(m, ka * run)
    pad = width - ka * run
    if pad:
        key = torch.nn.functional.pad(key, (0, pad), value=SENTINEL)
        val = torch.nn.functional.pad(val, (0, pad))
    return key.contiguous(), val.contiguous()


def table_gather(table, rT):
    """g = table[rT] (ka, m, lanes): the table rows rT names, K1's gather
    at pack 1."""
    ka, m = rT.shape
    return table[rT.reshape(-1).long()].reshape(ka, m, table.shape[1])


def _sort_plain(key, val):
    key, order = torch.sort(key, dim=1, stable=True)
    return key, torch.gather(val, 1, order)


def _compress_plain(key, val, out_w, compact):
    m, w = key.shape
    dev = key.device
    if m == 0:
        ow = out_w if compact else w
        return (torch.full((0, ow), -1, dtype=torch.int32, device=dev),
                torch.zeros((0, ow), dtype=val.dtype, device=dev),
                torch.zeros((0, 1), dtype=torch.int32, device=dev))
    change = key[:, 1:] != key[:, :-1]
    ones = torch.ones((m, 1), dtype=torch.bool, device=dev)
    head = torch.cat([ones, change], dim=1)
    last = torch.cat([change, ones], dim=1)
    emit = last & (key != SENTINEL)
    seg = torch.cumsum(head.reshape(-1), 0) - 1
    sums = torch.zeros(int(seg[-1]) + 1, dtype=val.dtype, device=dev)
    sums.index_add_(0, seg, val.reshape(-1))
    s = sums[seg].reshape(m, w)
    nnz = emit.sum(dim=1, keepdim=True, dtype=torch.int32)
    if not compact:
        return (torch.where(emit, key, -1).to(torch.int32),
                torch.where(emit, s, torch.zeros((), dtype=s.dtype,
                                                 device=dev)),
                nnz)
    dest = torch.cumsum(emit, dim=1) - 1
    dest = torch.where(emit & (dest < out_w), dest, out_w)
    col = torch.full((m, out_w + 1), -1, dtype=torch.int32, device=dev)
    out = torch.zeros((m, out_w + 1), dtype=val.dtype, device=dev)
    col.scatter_(1, dest, key)
    out.scatter_(1, dest, s)
    return col[:, :out_w].contiguous(), out[:, :out_w].contiguous(), nnz


def expand_sort_compress_plain(g, avT, *, ka, run, width, start_kk, out_w,
                               pack=1):
    key, val = _expand_plain(g, avT, ka, run, width, pack)
    return _compress_plain(*_sort_plain(key, val), out_w, True)


def expand_sort_plain(src, avT, *, ka, run, width, start_kk, pack=1,
                      rT=None):
    if rT is not None:
        src = table_gather(src, rT)
    return _sort_plain(*_expand_plain(src, avT, ka, run, width, pack))


def compress_plain(key, val, *, width, out_w, compact=True):
    return _compress_plain(key, val, out_w, compact)


def sort_compress_rows_plain(key, val, *, width, start_kk):
    return _compress_plain(*_sort_plain(key, val), width, True)


def sort_compress_plain(key, val, *, width, start_kk, out_w):
    return _compress_plain(*_sort_plain(key, val), out_w, True)


def sort_only_plain(key, val, *, width, start_kk):
    return _sort_plain(key, val)


def _pack_colval(c, prod):
    """(col | bf16(product)) int32 keys, the JAX package's _pack_colval
    (bitonic.py:498) bit for bit: col in bits 30..16 (col <= 32767),
    the round-to-nearest-even bf16 bits of the float32 product in bits
    15..0, capped at 0xFFFE so no key equals SENTINEL. Worked in int64 so
    the 32-bit wrap and the logical shift are explicit."""
    pb = prod.to(torch.float32).view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    rnd = (pb + 0x7FFF + ((pb >> 16) & 1)) & 0xFFFFFFFF
    enc = torch.clamp(rnd >> 16, max=0xFFFE)
    return ((c.to(torch.int64) << 16) | enc).to(torch.int32)


def _unpack_colval(p):
    """Inverse of _pack_colval (bitonic.py:512): (cols, SENTINEL kept;
    float32 values, the bf16 bits widened exactly)."""
    sent = p == SENTINEL
    p64 = p.to(torch.int64) & 0xFFFFFFFF
    k = torch.where(sent, SENTINEL, (p64 >> 16).to(torch.int32))
    bits = torch.where(sent, 0, (p64 & 0xFFFF) << 16)
    bits = bits - ((bits >> 31) & 1) * (1 << 32)     # as signed int32
    return k, bits.to(torch.int32).view(torch.float32)


def expand_sort_packed_plain(table, rT, avT, *, ka, run, width, start_kk):
    key, val = _expand_plain(table_gather(table, rT), avT, ka, run, width,
                             1)
    p = torch.where(key != SENTINEL, _pack_colval(key.clamp(min=0), val),
                    SENTINEL)
    return torch.sort(p, dim=1).values


def compress_packed_plain(p, *, width, out_w, compact=True):
    return _compress_plain(*_unpack_colval(p), out_w, compact)


# ------------------------------------------------------------------ wrappers

def expand_sort_compress(g, avT, *, ka: int, run: int, width: int,
                         start_kk: int, out_w: int, pack: int = 1):
    """K1: expand + sort + compress of one width class, from the
    fragment gather ``g``/``avT``. Returns (col (m, out_w), val, nnz)."""
    _check_width(width, start_kk)
    _check_gather(g, avT, ka, run, width, pack)
    if not 1 <= out_w <= width:
        raise ValueError(f"out_w {out_w} not in [1, {width}]")
    if avT.device.type == "cpu":
        return expand_sort_compress_plain(g, avT, ka=ka, run=run,
                                          width=width, start_kk=start_kk,
                                          out_w=out_w, pack=pack)
    _cuda_or_raise(avT)
    m = avT.shape[1]
    col, val, nnz = _row_outputs(m, out_w, torch.float32, avT.device)
    if m:
        _launch("ia_k1_expand_sort_compress", g, avT, col, val, nnz, m, ka,
                g.shape[2], run, pack, width, start_kk, out_w,
                device=avT.device)
        tracing.count("launch.K1")
    return col, val, nnz


def expand_sort(src, avT, *, ka: int, run: int, width: int,
                start_kk: int, pack: int = 1, rT=None):
    """K2: expand + sort without compress, from K1's gather ``src`` = g,
    or (``rT`` given, pack 1) from the wide B table ``src`` read through
    rT. Returns sorted (key, val), each (m, width)."""
    _check_width(width, start_kk)
    if rT is None:
        _check_gather(src, avT, ka, run, width, pack)
    elif pack != 1:
        raise ValueError(f"pack {pack}: the table source reads one "
                         "fragment per table row")
    else:
        _check_table(src, rT, avT, ka, run, width)
    if avT.device.type == "cpu":
        return expand_sort_plain(src, avT, ka=ka, run=run, width=width,
                                 start_kk=start_kk, pack=pack, rT=rT)
    _cuda_or_raise(avT)
    m = avT.shape[1]
    key = torch.empty((m, width), dtype=torch.int32, device=avT.device)
    val = torch.empty((m, width), dtype=torch.float32, device=avT.device)
    if m:
        if rT is None:
            _launch("ia_k2_expand_sort", src, avT, key, val, m, ka,
                    src.shape[2], run, pack, width, start_kk,
                    device=avT.device)
        else:
            _launch("ia_k2_expand_sort_table", src, rT, avT, key, val, m,
                    ka, src.shape[1], run, width, start_kk,
                    device=avT.device)
        tracing.count("launch.K2")
    return key, val


def compress(key, val, *, width: int, out_w: int, compact: bool = True):
    """K3: duplicate sums, nnz and compaction of sorted rows. compact=False
    keeps survivors at their sorted slots (holes -1 / 0) and needs
    out_w == width."""
    _check_width(width)
    _check_rows(key, val, width)
    if not 1 <= out_w <= width or (not compact and out_w != width):
        raise ValueError(f"out_w {out_w} invalid for width {width}, "
                         f"compact={compact}")
    if key.device.type == "cpu":
        return compress_plain(key, val, width=width, out_w=out_w,
                              compact=compact)
    _cuda_or_raise(key)
    col, out, nnz = _row_outputs(key.shape[0], out_w, val.dtype,
                                 key.device)
    if col.shape[0]:
        _launch(_entry("ia_k3_compress", val), key, val, col, out, nnz,
                col.shape[0], width, out_w, int(compact), device=key.device)
        tracing.count("launch.K3")
    return col, out, nnz


def sort_compress_rows(key, val, *, width: int, start_kk: int):
    """K4: sort + compress of pre-expanded rows (the wide classes).
    Returns (col (m, width), val, nnz)."""
    _check_width(width, start_kk)
    _check_rows(key, val, width)
    if key.device.type == "cpu":
        return sort_compress_rows_plain(key, val, width=width,
                                        start_kk=start_kk)
    _cuda_or_raise(key)
    col, out, nnz = _row_outputs(key.shape[0], width, val.dtype,
                                 key.device)
    if col.shape[0]:
        _launch(_entry("ia_k4_sort_compress_rows", val), key, val, col, out,
                nnz, col.shape[0], width, start_kk, device=key.device)
        tracing.count("launch.K4")
    return col, out, nnz


def sort_compress(key, val, *, width: int, start_kk: int, out_w: int):
    """K5: sort + compress of pre-expanded rows (the cols layout up to
    FUSED_MAX_WIDTH), the first out_w survivors of each row kept.
    Returns (col (m, out_w), val, nnz)."""
    _check_width(width, start_kk)
    _check_rows(key, val, width)
    if not 1 <= out_w <= width:
        raise ValueError(f"out_w {out_w} not in [1, {width}]")
    if key.device.type == "cpu":
        return sort_compress_plain(key, val, width=width, start_kk=start_kk,
                                   out_w=out_w)
    _cuda_or_raise(key)
    col, out, nnz = _row_outputs(key.shape[0], out_w, val.dtype,
                                 key.device)
    if col.shape[0]:
        _launch(_entry("ia_k5_sort_compress", val), key, val, col, out, nnz,
                col.shape[0], width, start_kk, out_w, device=key.device)
        tracing.count("launch.K5")
    return col, out, nnz


def sort_only(key, val, *, width: int, start_kk: int):
    """K6: sort of pre-expanded rows without compress (the cols layout
    above FUSED_MAX_WIDTH; K3 follows). Returns sorted (key, val)."""
    _check_width(width, start_kk)
    _check_rows(key, val, width)
    if key.device.type == "cpu":
        return sort_only_plain(key, val, width=width, start_kk=start_kk)
    _cuda_or_raise(key)
    k_s, v_s = torch.empty_like(key), torch.empty_like(val)
    if key.shape[0]:
        _launch(_entry("ia_k6_sort", val), key, val, k_s, v_s, key.shape[0],
                width, start_kk, device=key.device)
        tracing.count("launch.K6")
    return k_s, v_s


def expand_sort_packed(table, rT, avT, *, ka: int, run: int, width: int,
                       start_kk: int):
    """K7a: the bf16 serve lane's expand + sort, from the wide B table
    read through rT: each product packed with its column into one int32
    key, the keys sorted. Returns the sorted keys (m, width); equal
    multisets sort to equal arrays, so they are the JAX package's bit for
    bit."""
    _check_width(width, start_kk)
    _check_table(table, rT, avT, ka, run, width)
    if avT.device.type == "cpu":
        return expand_sort_packed_plain(table, rT, avT, ka=ka, run=run,
                                        width=width, start_kk=start_kk)
    _cuda_or_raise(avT)
    m = avT.shape[1]
    p = torch.empty((m, width), dtype=torch.int32, device=avT.device)
    if m:
        _launch("ia_k7a_expand_sort_packed", table, rT, avT, p, m, ka,
                table.shape[1], run, width, start_kk, device=avT.device)
        tracing.count("launch.K7a")
    return p


def compress_packed(p, *, width: int, out_w: int, compact: bool = True):
    """K7b: unpack sorted (col | bf16) keys, then K3's float32 duplicate
    sums, nnz and compaction (compact=False: holes, out_w == width)."""
    _check_width(width)
    _check_tensor("p", p, torch.int32, 2, p.device)
    if p.shape[1] != width:
        raise ValueError(f"p {tuple(p.shape)} must be (m, {width})")
    if not 1 <= out_w <= width or (not compact and out_w != width):
        raise ValueError(f"out_w {out_w} invalid for width {width}, "
                         f"compact={compact}")
    if p.device.type == "cpu":
        return compress_packed_plain(p, width=width, out_w=out_w,
                                     compact=compact)
    _cuda_or_raise(p)
    m = p.shape[0]
    col = torch.empty((m, out_w), dtype=torch.int32, device=p.device)
    out = torch.empty((m, out_w), dtype=torch.float32, device=p.device)
    nnz = torch.empty((m, 1), dtype=torch.int32, device=p.device)
    if m:
        _launch("ia_k7b_compress_packed", p, col, out, nnz, m, width, out_w,
                int(compact), device=p.device)
        tracing.count("launch.K7b")
    return col, out, nnz


KERNELS = {"K1": expand_sort_compress, "K2": expand_sort, "K3": compress,
           "K4": sort_compress_rows, "K5": sort_compress, "K6": sort_only,
           "K7a": expand_sort_packed, "K7b": compress_packed}


def reset_launch_counts():
    tracing.reset_launches(KERNELS)


def launch_counts() -> dict:
    return tracing.launches(KERNELS)
