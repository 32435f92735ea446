"""The width-class route's four kernels: wrappers, plain versions, counts.

=====  ==========================  ==========================================
 K1    expand_sort_compress        ops/bitonic.py:1034 _expand_sort_compress_kernel_t
 K2    expand_sort                 ops/bitonic.py:977  _expand_sort_kernel_t
 K3    compress                    ops/bitonic.py:523  _compress_kernel_t
 K4    sort_compress_rows          ops/bitonic.py:241  _kernel
=====  ==========================  ==========================================

(file:line of the JAX package.) Each wrapper checks its operands, then:
on CUDA tensors it launches the hand-written kernel of
``csrc/bitonic.cu`` on the current stream and adds one to its
``launches`` count; on CPU tensors it runs the plain PyTorch version of the
same function (the ``*_plain`` function beside it). There is no fallback:
a failed build or launch raises.

Layouts (row-major, one output row per matrix row):

- ``g`` (ceil(ka/pack), m, lanes) int32: per fragment e, packed row
  e // pack holds [col_f | val_bits_f | col_rev | val_bits_rev] of one B
  sub-run of length ``run`` at lane offset (e % pack) * 4 * run; col -1
  marks an empty slot. ``avT`` (ka, m) float32: the A value of fragment e.
- products of fragment e occupy slots [e*run, (e+1)*run) of the row, the
  reversed half for odd e, so the row holds alternating ascending and
  descending runs and the sort may start merging at ``start_kk = 2*run``.
- outputs: col (m, out_w) int32 (-1 = empty), val (m, out_w) float32
  (0 = empty), nnz (m, 1) int32 = survivors per row (not capped by out_w).

The plain versions sort stably (``torch.sort``) and sum duplicates with
``index_add_`` in slot order; the kernels' bitonic network is not stable,
so duplicate sums agree to float32 rounding, and structure exactly.
"""

from __future__ import annotations

import torch

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


def _check_rows(key, val, width):
    dev = key.device
    _check_tensor("key", key, torch.int32, 2, dev)
    _check_tensor("val", val, torch.float32, 2, dev)
    if key.shape != val.shape or key.shape[1] != width:
        raise ValueError(f"key {tuple(key.shape)} / val {tuple(val.shape)} "
                         f"must both be (m, {width})")


def _launch(name, *args, device: torch.device):
    """Call a C entry point on ``device`` (made current for the call):
    tensors pass as their device pointers, then the device's current
    stream; raise on a CUDA error."""
    from ia_spgemm_tpu_torch import _build
    fn = _build.load()[name]
    with torch.cuda.device(device):
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _cuda_or_raise(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


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


def _sort_plain(key, val):
    key, order = torch.sort(key, dim=1, stable=True)
    return key, torch.gather(val, 1, order)


def _compress_plain(key, val, out_w, compact):
    m, w = key.shape
    dev = key.device
    if m == 0:
        ow = out_w if compact else w
        return (torch.full((0, ow), -1, dtype=torch.int32, device=dev),
                torch.zeros((0, ow), dtype=torch.float32, device=dev),
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


def expand_sort_plain(g, avT, *, ka, run, width, start_kk, pack=1):
    return _sort_plain(*_expand_plain(g, avT, ka, run, width, pack))


def compress_plain(key, val, *, width, out_w, compact=True):
    return _compress_plain(key, val, out_w, compact)


def sort_compress_rows_plain(key, val, *, width, start_kk):
    return _compress_plain(*_sort_plain(key, val), width, True)


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
    col = torch.empty((m, out_w), dtype=torch.int32, device=avT.device)
    val = torch.empty((m, out_w), dtype=torch.float32, device=avT.device)
    nnz = torch.empty((m, 1), dtype=torch.int32, device=avT.device)
    if m:
        _launch("ia_k1_expand_sort_compress", g, avT, col, val, nnz, m, ka,
                g.shape[2], run, pack, width, start_kk, out_w,
                device=avT.device)
        expand_sort_compress.launches += 1
    return col, val, nnz


def expand_sort(g, avT, *, ka: int, run: int, width: int, start_kk: int,
                pack: int = 1):
    """K2: expand + sort without compress. Returns sorted (key, val),
    each (m, width)."""
    _check_width(width, start_kk)
    _check_gather(g, avT, ka, run, width, pack)
    if avT.device.type == "cpu":
        return expand_sort_plain(g, avT, ka=ka, run=run, width=width,
                                 start_kk=start_kk, pack=pack)
    _cuda_or_raise(avT)
    m = avT.shape[1]
    key = torch.empty((m, width), dtype=torch.int32, device=avT.device)
    val = torch.empty((m, width), dtype=torch.float32, device=avT.device)
    if m:
        _launch("ia_k2_expand_sort", g, avT, key, val, m, ka, g.shape[2],
                run, pack, width, start_kk, device=avT.device)
        expand_sort.launches += 1
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
    m = key.shape[0]
    col = torch.empty((m, out_w), dtype=torch.int32, device=key.device)
    out = torch.empty((m, out_w), dtype=torch.float32, device=key.device)
    nnz = torch.empty((m, 1), dtype=torch.int32, device=key.device)
    if m:
        _launch("ia_k3_compress", key, val, col, out, nnz, m, width, out_w,
                int(compact), device=key.device)
        compress.launches += 1
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
    m = key.shape[0]
    col = torch.empty((m, width), dtype=torch.int32, device=key.device)
    out = torch.empty((m, width), dtype=torch.float32, device=key.device)
    nnz = torch.empty((m, 1), dtype=torch.int32, device=key.device)
    if m:
        _launch("ia_k4_sort_compress_rows", key, val, col, out, nnz, m,
                width, start_kk, device=key.device)
        sort_compress_rows.launches += 1
    return col, out, nnz


KERNELS = {"K1": expand_sort_compress, "K2": expand_sort, "K3": compress,
           "K4": sort_compress_rows}
for _fn in KERNELS.values():
    _fn.launches = 0


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
