"""Row-local bitonic SpGEMM, width-class route (PyTorch port of
``ia_spgemm_tpu.ops.bitonic``).

C = A @ B with both operands ELL. Every output row's intermediate
products are laid out in a fixed power-of-two width as alternating
ascending / descending runs of B sub-rows ("fragments"), then sorted,
duplicate-summed and compacted per row by the kernels of
``ops/bitonic_kernels.py``.

The host planner (``plan_bitonic_dims``, ``plan_multiclass``) is ported
line for line: the plan fixes the output layout (class spans, ``blk_ptr``),
so parity with the JAX package needs the same plan. The device glue the
JAX package left to XLA (fragment tables, gathers, assembly) is plain
torch here and runs on the operands' device. The Pallas kernels became
CUDA kernels; on CPU tensors their plain PyTorch versions run instead.

Routing by class width ``w`` (as in the JAX package), for float32
operands read through the fragment gather:

- ``w <= FUSED_MAX_WIDTH``: K1 (expand + sort + compress in one kernel)
  on g, the plan's pregathered fragments or ``table[rT]``;
- ``FUSED_MAX_WIDTH < w <= TRANSPOSED_MAX_WIDTH``: K2 (expand + sort),
  then K3 (compress); K2 reads the pregathered g, or the wide B table
  itself through the fragment index rT (the flat route, the serve lane's
  K7a and the classes not pregathered write no gathered copy);
- wider classes: torch expand, then K4 (sort + compress of rows).

Operands of another type (float64), and the flat route's float32 plans
outside the gather budget, take the cols layout over the torch expand
``_expand_ell``: K5 (sort + compress) up to FUSED_MAX_WIDTH, K6 (sort)
then K3 up to TRANSPOSED_MAX_WIDTH, K4 above; every kernel in the
operands' type.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from ia_spgemm_tpu_torch import config as cfg
from ia_spgemm_tpu_torch.formats.types import ELL, BlockCSR
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K

SENTINEL = K.SENTINEL
_INT32_MIN = -2**31

# planner constants, equal to the JAX package's
_TILE_ELEMS = 32 * 1024
MAX_WIDTH = 16384
PRODUCT_BUDGET_BYTES = 4 << 30
PREGATHER_BUDGET_BYTES = 2 << 30
# widths up to this run the expand-from-gather kernels (K1, or K2 + K3)
TRANSPOSED_MAX_WIDTH = 1024
# K1 up to this width, K2 + K3 above; same environment variable and
# default as the JAX package (bench/headline.py applies the tuned value)
FUSED_MAX_WIDTH = int(os.environ.get("IA_SPGEMM_FUSED_MAX_WIDTH", 256))
# flat spgemm_bitonic routes through the expand-from-gather kernels only
# within this entry budget, as in the JAX package
_EXPAND_TILE_ELEMS = 8192

# The JAX planner's cost-model constants, kept for plan parity (the plan
# fixes the output layout); to be refit on the card later.
_EXPAND_GBS = 500.0
_SORT_PS_PER_STAGE_SLOT = 3.8
_COMPRESS_PS_PER_SLOT = 68.0


# ------------------------------------------------------------ host planning

def _sort_stages(width: int, run: int) -> int:
    """Bitonic stages left when the input is presorted in runs of `run`:
    sum of j over blocks 2^j in (run, width]."""
    lw = max(int(width), 1).bit_length() - 1
    lr = max(int(run), 1).bit_length() - 1
    return sum(j for j in range(lr + 1, lw + 1))


def _candidate_time_ps(W: np.ndarray, run: int) -> float:
    """Modelled per-call cost of a width-class candidate: expand (table
    gather at the padded 128-lane row width + product write) + per-class
    sort stages + compress."""
    slots = float(W.sum())
    lanes = max(128, 4 * run)
    expand_bytes = slots / max(run, 1) * lanes * 4.0 + slots * 8.0
    t = expand_bytes * (1000.0 / _EXPAND_GBS)
    for w in np.unique(W):
        rows = float((W == w).sum())
        t += rows * _sort_stages(int(w), run) * float(w) \
            * _SORT_PS_PER_STAGE_SLOT
    t += slots * _COMPRESS_PS_PER_SLOT
    return t


@dataclasses.dataclass(frozen=True)
class BitonicPlan:
    width: int        # padded products per row (pow2, >= 128)
    run: int          # pow2 sorted-run length (B-row chunk size)
    tile_rows: int    # rows per tile in the JAX package (kept for parity)
    viable: bool
    reason: str = ""
    chunks: int = 1   # B rows cut into `chunks` sub-runs of `run` slots


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _next_pow2_arr(x: np.ndarray) -> np.ndarray:
    x = np.maximum(np.asarray(x, np.int64), 1)
    return (np.int64(1) << np.ceil(np.log2(x)).astype(np.int64))


def plan_bitonic_dims(m: int, ka: int, kb: int,
                      allow_split: bool = True) -> BitonicPlan:
    """Flat plan from dimensions only: the pow2 sub-run length that gives
    the smallest padded width (the largest such run on ties)."""
    full_run = max(1, _next_pow2(kb))
    best = None  # (width, -run0, run0, chunks)
    run0 = full_run
    while True:
        chunks = -(-max(kb, 1) // run0) if kb else 1
        width = max(128, _next_pow2(ka * chunks * run0))
        cand = (width, -run0, run0, chunks)
        if best is None or cand < best:
            best = cand
        if run0 <= 8 or not allow_split:
            break
        run0 //= 2
    width, _, run, chunks = best
    run = min(run, width)
    if width > MAX_WIDTH:
        return BitonicPlan(width, run, 8, False,
                           f"ka*chunks*run={ka * chunks * run} exceeds "
                           f"{MAX_WIDTH} lanes", chunks)
    if m * width * 8 > PRODUCT_BUDGET_BYTES:
        return BitonicPlan(width, run, 8, False,
                           f"m*Wp*8={m * width * 8} exceeds "
                           f"product budget {PRODUCT_BUDGET_BYTES}", chunks)
    tile_rows = max(8, min(512, _TILE_ELEMS // width))
    return BitonicPlan(width, run, tile_rows, True, "", chunks)


def plan_bitonic(A: ELL, B: ELL, allow_split: bool = True) -> BitonicPlan:
    return plan_bitonic_dims(A.nrows, A.max_nnz_per_row, B.max_nnz_per_row,
                             allow_split=allow_split)


@dataclasses.dataclass(frozen=True)
class MultiClassPlan:
    run: int
    chunks: int       # chunked mode: sub-runs per B row; ragged: 0
    widths: tuple     # ascending per-class product widths
    viable: bool
    ragged: bool = False
    reason: str = ""


def _compact_entries(a_col_h, b_len_h, a_len_h=None):
    """Live-entry stream of A's padded ELL (row-major order): in-row slot
    ids, B-row ids, B-row lengths, A-row ids, and per-A-row pointers into
    the stream. With a_len_h (per-row nnz) the stream follows from ELL's
    left-justification, with no scan of the grid."""
    m, ka = a_col_h.shape
    if a_len_h is not None:
        al = np.minimum(np.maximum(a_len_h.astype(np.int64), 0), ka)
        row_ptr = np.concatenate([[0], np.cumsum(al)]).astype(np.int64)
        nnz = int(row_ptr[-1])
        rows_live = np.repeat(np.arange(m, dtype=np.int32), al)
        rp32 = row_ptr.astype(np.int32)
        e_live = np.arange(nnz, dtype=np.int32) - rp32[:-1][rows_live]
        ent = rows_live.astype(np.int64) * ka + e_live
        j_live = a_col_h.reshape(-1)[ent].astype(np.int64)
    else:
        flat = a_col_h.reshape(-1)
        ent = np.nonzero(flat >= 0)[0]
        j_live = flat[ent].astype(np.int64)
        rows_live = (ent // ka).astype(np.int32)
        e_live = (ent % ka).astype(np.int32)
        row_ptr = np.searchsorted(rows_live,
                                  np.arange(m + 1, dtype=np.int64))
    len_live = np.maximum(b_len_h[j_live], 0).astype(np.int64)
    return e_live, j_live, len_live, rows_live, row_ptr


def _frag_totals(len_live, row_ptr, run: int):
    """(per-live-entry fragment counts, per-row totals): each stored A
    entry contributes ceil(len_B/run) fragments, at least one."""
    frag = np.maximum(-(-len_live // run), 1)
    cs = np.concatenate([[0], np.cumsum(frag)])
    return frag, cs[row_ptr[1:]] - cs[row_ptr[:-1]]


def _frag_rows_dev_multi(a_col, b_len, runs):
    """Every run candidate's per-row ragged fragment totals, computed on
    A's device with one (m, ka) gather of B's row lengths: (len(runs), m)
    int64 on the host."""
    lens = b_len.to(torch.int64)[a_col.clamp(0, b_len.shape[0] - 1)
                                 .to(torch.int64)].clamp(min=0)
    live = a_col >= 0
    return torch.stack([
        torch.where(live, _cdiv_pos(lens, r).clamp(min=1), 0).sum(dim=1)
        for r in runs]).cpu().numpy()


def plan_multiclass(row_lens, kb: int, *, max_classes: int = 4,
                    value_bytes: int = 4, a_col_h=None, b_len_h=None,
                    a_col_dev=None, b_len_dev=None,
                    layout: str | None = None,
                    run_override: int | None = None):
    """Per-row width classes: each row's products pad to its own pow2
    width. Two layouts compete per sub-run length: chunked (every entry
    fetches ceil(kb/run) sub-runs) and, given A's column grid and B's row
    lengths, ragged (each entry fetches only its own B row's
    ceil(len/run) fragments). Those two come as host arrays (`a_col_h`,
    `b_len_h`) or as tensors (`a_col_dev`, `b_len_dev`, which take
    precedence: the fragment totals of every candidate are then counted
    on their device, the JAX package's device probe). layout "chunked" or
    "ragged" forces one (None: the cost model decides); run_override pins
    the sub-run length. Returns (MultiClassPlan, per-row width array)."""
    if layout not in (None, "chunked", "ragged"):
        raise ValueError(f"unknown layout {layout!r}")
    lens = np.asarray(row_lens, dtype=np.int64)
    full_run = max(1, _next_pow2(kb))
    use_dev = a_col_dev is not None and b_len_dev is not None
    ragged_ok = (use_dev or (a_col_h is not None and b_len_h is not None)
                 ) and layout != "chunked"
    ce = (_compact_entries(a_col_h, b_len_h, a_len_h=lens)
          if ragged_ok and not use_dev else None)
    F_by_run = {}
    if ragged_ok and use_dev:
        cand_runs = [r for r in (full_run >> s for s in range(64))
                     if r >= min(4, full_run)
                     and (run_override is None or r == run_override)]
        if cand_runs:
            F_by_run = dict(zip(cand_runs, _frag_rows_dev_multi(
                a_col_dev, b_len_dev, cand_runs)))

    def feasible(W):
        return (int(W.max(initial=128)) <= MAX_WIDTH
                and int(W.sum()) * 2 * value_bytes <= PRODUCT_BUDGET_BYTES)

    best = None      # cheapest feasible candidate
    fallback = None  # cheapest candidate overall (for the error message)
    run0 = full_run
    while True:
        if run_override is not None and run0 != run_override:
            if run0 <= 4:
                break
            run0 //= 2
            continue
        chunks = -(-max(kb, 1) // run0) if kb else 1
        W = np.maximum(128, _next_pow2_arr(
            np.maximum(lens, 1) * chunks * run0))
        cand = ((_candidate_time_ps(W, run0), -run0), run0, chunks, W,
                False)
        if fallback is None or cand[0] < fallback[0]:
            fallback = cand
        if layout != "ragged" and feasible(W) and (
                best is None or cand[0] < best[0]):
            best = cand
        if ragged_ok:
            Fr = (F_by_run[run0] if use_dev
                  else _frag_totals(ce[2], ce[4], run0)[1])
            Wr = np.maximum(128, _next_pow2_arr(np.maximum(Fr, 1) * run0))
            cand_r = ((_candidate_time_ps(Wr, run0), -run0), run0, 0, Wr,
                      True)
            if feasible(Wr) and (best is None or cand_r[0] < best[0]):
                best = cand_r
        if run0 <= 4:
            break
        run0 //= 2
    if best is None:
        if fallback is None:
            return (MultiClassPlan(
                run_override or 0, 1, (), False, False,
                f"run_override {run_override} matches no candidate"),
                np.maximum(128, _next_pow2_arr(np.maximum(lens, 1))))
        _, run, chunks, W, ragged = fallback
        reason = (f"a row's products exceed {MAX_WIDTH} lanes"
                  if int(W.max(initial=128)) > MAX_WIDTH
                  else "summed class buffers exceed the product budget")
        return (MultiClassPlan(run, chunks, (), False, ragged, reason), W)
    _, run, chunks, W, ragged = best
    classes = np.unique(W)
    while len(classes) > max_classes:
        # merge the class with the fewest rows into the next one up
        counts = np.array([(W == w).sum() for w in classes[:-1]])
        i = int(np.argmin(counts))
        W[W == classes[i]] = classes[i + 1]
        classes = np.unique(W)
    return (MultiClassPlan(run, chunks, tuple(int(w) for w in classes),
                           True, ragged), W)


def multiclass_viable(row_lens: np.ndarray, kb: int,
                      value_bytes: int = 4) -> bool:
    plan, _ = plan_multiclass(row_lens, kb, value_bytes=value_bytes)
    return plan.viable


def _pg_pack(run: int, width: int) -> int:
    """Fragments packed per 128-lane row of the pregathered g (only
    where K1 consumes g: width <= FUSED_MAX_WIDTH)."""
    used = 4 * run
    if width > FUSED_MAX_WIDTH or used >= 128 or 128 % used:
        return 1
    return 128 // used


# ------------------------------------------------------ device-side glue

def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for class row ids padded with m: the pad row reads as
    INT32_MIN (ints) or NaN (floats), what ``jnp.take`` fills out-of-range
    rows with. Consumers mask them by column (< 0), never by multiply."""
    fill = _INT32_MIN if not x.dtype.is_floating_point else float("nan")
    pad = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])[idx]


def _cdiv_pos(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x + (d - 1), d, rounding_mode="floor")


def _build_wide_table(b_col, b_val, *, run: int, chunks: int):
    """Packed B table (kt+1, max(128, 4*run)) int32:
    [col_f | val_bits_f | col_rev | val_bits_rev] per (sub-run of a) B
    row, lanes padded with 0, plus a final all -1 sentinel row. Returns
    (table, kt)."""
    k, kb = b_col.shape
    cap = chunks * run
    bc_p = F.pad(b_col, (0, cap - kb), value=-1).reshape(k * chunks, run)
    bv_p = F.pad(b_val, (0, cap - kb)).reshape(k * chunks, run)
    return _wide_rows(bc_p, bv_p.view(torch.int32)), k * chunks


def _wide_rows(bc, bvb):
    wide = torch.cat([bc, bvb, bc.flip(1), bvb.flip(1)], dim=1)
    if wide.shape[1] < 128:
        wide = F.pad(wide, (0, 128 - wide.shape[1]))
    return F.pad(wide, (0, 0, 0, 1), value=-1)


def _chunk_entries(a_col, a_val, chunks: int):
    """Each A entry becomes `chunks` sub-entries addressing consecutive
    table rows."""
    m, ka = a_col.shape
    if chunks == 1:
        return a_col, a_val, ka
    sub = torch.arange(chunks, dtype=torch.int32, device=a_col.device)
    ac = a_col[:, :, None]
    a_col = torch.where(ac >= 0, ac * chunks + sub, -1).reshape(
        m, ka * chunks)
    a_val = a_val[:, :, None].expand(m, ka, chunks).reshape(m, ka * chunks)
    return a_col, a_val, ka * chunks


def _table_rows(a_col, kt: int) -> torch.Tensor:
    """Table row per entry: the entry's B (sub-)row, or the sentinel row
    kt for an empty slot."""
    return torch.where(a_col >= 0, a_col.clamp(0, kt - 1),
                       kt).to(torch.int64)


def _flat_table(a_col, a_val, b_col, b_val, *, run: int, chunks: int = 1):
    """The flat route's table source: the wide B table, the fragment
    index rT (ka_eff, m) int32 (entry e of row r reads table row rT[e,
    r]) and avT (ka_eff, m). K1 takes g = table[rT]
    (``bitonic_kernels.table_gather``); K2 and K7a read the table through
    rT themselves."""
    wide, kt = _build_wide_table(b_col, b_val, run=run, chunks=chunks)
    a_col, a_val, _ = _chunk_entries(a_col, a_val, chunks)
    rT = _table_rows(a_col, kt).T.to(torch.int32).contiguous()
    return wide, rT, a_val.T.contiguous()


def _expand_rows(table, rows, av, *, run: int, width: int):
    """Row-major products for K4: rows (n, F) table row ids, av (n, F)
    A values per fragment -> keys/vals (n, width), odd fragments taken
    reversed, empty slots SENTINEL / 0 (a select keeps NaN pad values
    out)."""
    n, nf = rows.shape
    lanes = table.shape[1]
    g2 = table[rows.reshape(-1).to(torch.int64)].reshape(n, nf, lanes)
    par = (torch.arange(nf, device=table.device) & 1).bool()[None, :, None]
    bc = torch.where(par, g2[:, :, 2 * run:3 * run], g2[:, :, :run])
    bvb = torch.where(par, g2[:, :, 3 * run:4 * run],
                      g2[:, :, run:2 * run])
    valid = bc >= 0
    key = torch.where(valid, bc, SENTINEL).reshape(n, nf * run)
    val = torch.where(valid, av[:, :, None] * bvb.view(torch.float32),
                      torch.zeros((), dtype=torch.float32,
                                  device=table.device)).reshape(n, nf * run)
    pad = width - nf * run
    if pad:
        key = F.pad(key, (0, pad), value=SENTINEL)
        val = F.pad(val, (0, pad))
    return key.contiguous(), val.contiguous()


def _expand_ell(a_col, a_val, b_col, b_val, *, width: int, run: int,
                chunks: int = 1):
    """Row-major products (m, width) for the cols layout (K5, K6 + K3)
    and the rows layout (K4), in the operands' promoted type: the JAX
    package's _expand_ell (bitonic.py:786). B's ELL rows, padded to
    chunks*run and cut into `chunks` sub-rows, are gathered at A's
    columns from a doubled table whose second half holds every sub-row
    reversed; odd runs take the reversed half, so a row holds alternating
    ascending / descending runs and the sort may start merging at 2*run.
    col < 0 (an empty slot, or a padded class row) becomes SENTINEL with
    value 0 by a select, never a multiply: padded class rows carry NaN A
    values."""
    m = a_col.shape[0]
    k, kb = b_col.shape
    cap = chunks * run
    bc = F.pad(b_col, (0, cap - kb), value=-1).reshape(k * chunks, run)
    bv = F.pad(b_val, (0, cap - kb)).reshape(k * chunks, run)
    kt = k * chunks
    a_col, a_val, ka = _chunk_entries(a_col, a_val, chunks)
    parity = torch.arange(ka, device=a_col.device) & 1
    rows = (a_col.clamp(0, kt - 1).to(torch.int64) + kt * parity).reshape(-1)
    bc, bv = doubled_table_gather(bc, bv, rows, run=run,
                                  out_shape=(m, ka, run))
    valid = (a_col >= 0)[:, :, None] & (bc >= 0)
    dtype = torch.result_type(a_val, b_val)
    key = torch.where(valid, bc, SENTINEL).reshape(m, ka * run)
    val = torch.where(valid, a_val.to(dtype)[:, :, None] * bv.to(dtype),
                      torch.zeros((), dtype=dtype, device=bv.device)
                      ).reshape(m, ka * run)
    pad = width - ka * run
    if pad:
        key = F.pad(key, (0, pad), value=SENTINEL)
        val = F.pad(val, (0, pad))
    return key.contiguous(), val.contiguous()


def doubled_table_gather(bc_p, bv_p, rows_flat, *, run: int, out_shape):
    """Rows of B's (sub-)run table and of its reversed copy, the JAX
    package's doubled_table_gather (bitonic.py:844), shared by
    ``_expand_ell`` and the ring step (``parallel/ring.py``): a fix to
    this motif must reach both callers.

    bc_p / bv_p (kt, run): B's sub-runs; rows_flat indexes the doubled
    table, row kt + r being row r reversed. float32 values travel beside
    their columns as int32 bits in one (2*kt, 2*run) table, so each
    index is one gather; other types gather the two tables apart.
    Returns (cols, vals), each reshaped to out_shape."""
    if bv_p.dtype == torch.float32:
        bvb = bv_p.view(torch.int32)
        table = torch.cat([torch.cat([bc_p, bvb], dim=1),
                           torch.cat([bc_p.flip(1), bvb.flip(1)], dim=1)])
        g = table[rows_flat]
        return (g[:, :run].reshape(out_shape),
                g[:, run:].view(torch.float32).reshape(out_shape))
    bc_t = torch.cat([bc_p, bc_p.flip(1)])
    bv_t = torch.cat([bv_p, bv_p.flip(1)])
    return (bc_t[rows_flat].reshape(out_shape),
            bv_t[rows_flat].reshape(out_shape))


def _ragged_table(b_col, b_val, frag_src, *, run: int, cm: int):
    """Packed table over B's fragments (B rows cut into cm sub-runs of
    `run`; frag_src lists the non-empty ones) + a final -1 sentinel row."""
    k, kb = b_col.shape
    bc_p = F.pad(b_col, (0, cm * run - kb), value=-1).reshape(k * cm, run)
    bv_p = F.pad(b_val, (0, cm * run - kb)).reshape(k * cm, run)
    packed = torch.cat([bc_p, bv_p.view(torch.int32)], dim=1)[frag_src]
    return _wide_rows(packed[:, :run], packed[:, run:])


def _device_fragments(a_col, b_len, startp, idx, *, run: int, F_c: int,
                      F_B: int, m: int):
    """Per-class fragment index matrices built on the device.

    M[r, p] = table row of class-row r's p-th fragment (F_B past the
    row's fragments); E[r, p] = in-row ordinal of the A entry owning it.
    Each entry's segment constant is scattered as a telescoping delta at
    its per-row fragment offset, then a row cumsum broadcasts it."""
    n_pad = idx.shape[0]
    dev = a_col.device
    i32 = torch.int32
    ac = _take_rows(a_col, idx)                          # (n_pad, ka)
    row_ok = (idx < m)[:, None]
    jc = ac.clamp(0, b_len.shape[0] - 1).to(torch.int64)
    lens = b_len[jc].clamp(min=0)
    live = (ac >= 0) & row_ok
    frag_e = torch.where(live, _cdiv_pos(lens, run).clamp(min=1), 0)
    pref_end = torch.cumsum(frag_e, dim=1, dtype=i32)
    pref = pref_end - frag_e
    F_rows = pref_end[:, -1:]
    sM = startp[jc] - pref
    sE = torch.arange(ac.shape[1], dtype=i32, device=dev).expand_as(ac)
    dM = sM - F.pad(sM[:, :-1], (1, 0))
    dE = sE - F.pad(sE[:, :-1], (1, 0))
    flat = (torch.arange(n_pad, device=dev)[:, None] * (F_c + 1)
            + pref.clamp(max=F_c)).reshape(-1)
    gM = torch.zeros(n_pad * (F_c + 1), dtype=i32, device=dev)
    gE = torch.zeros(n_pad * (F_c + 1), dtype=i32, device=dev)
    gM.scatter_add_(0, flat, dM.reshape(-1).to(i32))
    gE.scatter_add_(0, flat, dE.reshape(-1).to(i32))
    gM = gM.reshape(n_pad, F_c + 1)[:, :F_c]
    gE = gE.reshape(n_pad, F_c + 1)[:, :F_c]
    p_io = torch.arange(F_c, dtype=i32, device=dev)[None, :]
    valid = p_io < F_rows
    M = torch.where(valid, torch.cumsum(gM, dim=1, dtype=i32) + p_io, F_B)
    E = torch.where(valid, torch.cumsum(gE, dim=1, dtype=i32), 0)
    return M.to(i32), E.to(i32)


def _pregather_class(a_col, a_val, b_nnz_row, idx, table, *, run: int,
                     F_c: int, F_B: int, m: int, gather: bool,
                     pack: int = 1):
    """One class's plan-time artifacts: (g, AVT) for classes the
    expand-from-gather kernels take (g = table[MT], lane-packed when
    pack > 1), (MT, AVT) for wide classes."""
    b_len_d = b_nnz_row.to(torch.int32).clamp(min=0)
    frag_cnt = _cdiv_pos(b_len_d, run).clamp(min=1)
    startp_d = F.pad(torch.cumsum(frag_cnt, 0, dtype=torch.int32), (1, 0))
    M_c, E_c = _device_fragments(a_col, b_len_d, startp_d, idx, run=run,
                                 F_c=F_c, F_B=F_B, m=m)
    av_c = _take_rows(a_val, idx)
    av_f = torch.gather(av_c, 1,
                        E_c.clamp(0, av_c.shape[1] - 1).to(torch.int64))
    if not gather:
        return M_c.T.contiguous(), av_f.T.contiguous()
    lanes = table.shape[1]
    n_pad = idx.shape[0]
    g = table[M_c.T.reshape(-1).to(torch.int64)].reshape(F_c, n_pad, lanes)
    if pack > 1:
        used = 4 * run
        F_pad = -(-F_c // pack) * pack
        gp = F.pad(g[:, :, :used], (0, 0, 0, 0, 0, F_pad - F_c), value=-1)
        g = (gp.reshape(F_pad // pack, pack, n_pad, used)
             .permute(0, 2, 1, 3)
             .reshape(F_pad // pack, n_pad, pack * used))
    return g.contiguous(), av_f.T.contiguous()


def _pregather_fragments_device(A, B, widths, run, idxs, kas, table, m):
    """Per class: (g or MT, AVT) built on the device at plan time."""
    kt = int(table.shape[0]) - 1
    gs, avts = [], []
    for c, w in enumerate(widths):
        g, avt = _pregather_class(A.col_ind, A.values, B.nnz_row, idxs[c],
                                  table, run=run, F_c=kas[c], F_B=kt, m=m,
                                  gather=int(w) <= TRANSPOSED_MAX_WIDTH,
                                  pack=_pg_pack(run, int(w)))
        gs.append(g)
        avts.append(avt)
    return gs, avts


def _host_fragments(A, b_len_h, widths, run, startp, F_B, idx_h, kas,
                    counts):
    """Host-numpy fragment planning: one global fragment stream over the
    live A entries, scattered into every class's (F_c, n_pad) matrices.
    Returns per-class MT (table row ids, int32) and AVT (A values per
    fragment, 0 in dead slots), transposed, on A's device."""
    a_col_h = A.col_ind.cpu().numpy()
    m = a_col_h.shape[0]
    e_live, j_live, len_live, rows_live, row_ptr = _compact_entries(
        a_col_h, b_len_h, a_len_h=A.nnz_row.cpu().numpy())
    frag_live, _ = _frag_totals(len_live, row_ptr, run)
    F_total = int(frag_live.sum())
    pref_live = (np.cumsum(frag_live) - frag_live).astype(np.int32)
    src = np.repeat(np.arange(len(frag_live), dtype=np.int32), frag_live)
    rows_f = rows_live[src]
    e_f = e_live[src]
    ar = np.arange(F_total, dtype=np.int32)
    within = ar - pref_live[src]
    sv = startp[j_live].astype(np.int32)
    mval_f = np.where((len_live > 0)[src], sv[src] + within,
                      np.int32(F_B))
    cs = np.concatenate([[0], np.cumsum(frag_live)])
    row_base = cs[row_ptr[:-1]].astype(np.int32)
    fpos_f = ar - row_base[rows_f]
    class_rank = np.zeros(m, np.int32)
    class_id = np.zeros(m, np.int8)
    bases = np.concatenate([[0], np.cumsum(
        [counts[c] * kas[c] for c in range(len(widths))])]).astype(np.int64)
    for c in range(len(widths)):
        class_id[idx_h[c]] = c
        class_rank[idx_h[c]] = np.arange(len(idx_h[c]), dtype=np.int32)
    cls_f = class_id[rows_f]
    tgt = (bases[:-1][cls_f]
           + class_rank[rows_f].astype(np.int64)
           * np.asarray(kas, np.int64)[cls_f]
           + fpos_f)
    M_flat = np.full(int(bases[-1]), F_B, np.int32)
    AV_flat = np.zeros(int(bases[-1]), np.float32)
    M_flat[tgt] = mval_f
    AV_flat[tgt] = A.values.cpu().numpy()[rows_f, e_f]
    dev = A.device

    def per_class(flat, c):
        return torch.from_numpy(np.ascontiguousarray(
            flat[bases[c]:bases[c + 1]].reshape(counts[c], kas[c]).T)
        ).to(dev)

    n = len(widths)
    return ([per_class(M_flat, c) for c in range(n)],
            [per_class(AV_flat, c) for c in range(n)])


# ---------------------------------------------------------- kernel routing

def _sort_compress_from_gather(src, avT, *, width: int, run: int, ka: int,
                               start_kk: int, out_width: int | None = None,
                               compact: bool = True, pack: int = 1,
                               rT=None):
    """Expand-from-gather pipeline of one width class, from the gather
    ``src`` = g, or (``rT`` given) the wide table ``src`` read through
    the fragment index rT: K1 up to FUSED_MAX_WIDTH (which always
    compacts, as in the JAX package; it takes g = table[rT]), K2 + K3
    above (K2 reads the table itself). Returns (col (m, out_w), val, nnz
    (m, 1))."""
    out_w = width if (out_width is None or not compact) \
        else min(out_width, width)
    if width <= FUSED_MAX_WIDTH:
        g = src if rT is None else K.table_gather(src, rT)
        return K.expand_sort_compress(g, avT, ka=ka, run=run, width=width,
                                      start_kk=start_kk, out_w=out_w,
                                      pack=pack)
    key, val = K.expand_sort(src, avT, ka=ka, run=run, width=width,
                             start_kk=start_kk, pack=pack, rT=rT)
    return K.compress(key, val, width=width, out_w=out_w, compact=compact)


def _sort_compress_cols(key, val, *, width: int, start_kk: int,
                        out_width: int | None = None):
    """The cols layout over pre-expanded rows (_expand_ell): K5 up to
    FUSED_MAX_WIDTH, K6 then K3 above; always compacts, as in the JAX
    package. Returns (col (m, out_w), val (m, out_w), nnz (m, 1))."""
    out_w = width if out_width is None else min(out_width, width)
    if width <= FUSED_MAX_WIDTH:
        return K.sort_compress(key, val, width=width, start_kk=start_kk,
                               out_w=out_w)
    key, val = K.sort_only(key, val, width=width, start_kk=start_kk)
    return K.compress(key, val, width=width, out_w=out_w)


# ---------------------------------------------------------------- pipeline

@dataclasses.dataclass
class MulticlassCall:
    """A planned width-class product C = A @ B; call it to run.

    Per class c (ascending widths): ``idxs[c]`` the class's rows padded
    with m to ``counts[c]`` (int64, index-only); for the ragged layout
    ``frags[c]`` the fragment table rows MT (F_c, n_pad) or, pregathered,
    g = table[MT] (lane-packed for K1 classes), and ``avts[c]`` the
    fragments' A values (F_c, n_pad); with ``plan_device`` both lists
    are empty and every call builds them on the device. ``src_full`` /
    ``blk_ptr`` are the BlockCSR assembly map and spans
    (assemble="bcsr")."""

    A: ELL
    B: ELL
    widths: tuple
    kas: tuple
    counts: tuple
    run: int
    chunks: int
    out_w: int
    ragged: bool
    assemble: str
    pregather: bool
    idxs: list
    frags: list
    avts: list
    table: torch.Tensor
    src_full: torch.Tensor | None = None
    blk_ptr: torch.Tensor | None = None
    plan_device: bool = False

    def __call__(self):
        return _results(self, _multiclass_fn(self))


def _multiclass_fn(c: MulticlassCall):
    """Run every class's kernels and assemble the rows."""
    run = c.run
    start_kk = 2 * run
    kt = c.table.shape[0] - 1
    f32 = c.A.dtype == torch.float32 and c.B.dtype == torch.float32
    frags, avts = c.frags, c.avts
    if c.plan_device:
        # the fragment matrices built on the device in every call, the
        # JAX package's in-graph plan_device path
        frags, avts = zip(*(
            _pregather_class(c.A.col_ind, c.A.values, c.B.nnz_row,
                             c.idxs[i], c.table, run=run, F_c=c.kas[i],
                             F_B=kt, m=c.A.nrows, gather=False)
            for i in range(len(c.widths))))
    cols_p, vals_p, nnz_p = [], [], []
    for i, w in enumerate(c.widths):
        out_c = min(c.out_w, w)
        if c.ragged:
            F_c, avT = c.kas[i], avts[i]
            if w <= TRANSPOSED_MAX_WIDTH and c.pregather:
                out = _sort_compress_from_gather(
                    frags[i], avT, width=w, run=run, ka=F_c,
                    start_kk=start_kk, out_width=out_c,
                    pack=_pg_pack(run, w))
            elif w <= TRANSPOSED_MAX_WIDTH:
                out = _sort_compress_from_gather(
                    c.table, avT, width=w, run=run, ka=F_c,
                    start_kk=start_kk, out_width=out_c, rT=frags[i])
            else:
                key, val = _expand_rows(c.table, frags[i].T, avT.T,
                                        run=run, width=w)
                out = K.sort_compress_rows(key, val, width=w,
                                           start_kk=start_kk)
        else:
            ac = _take_rows(c.A.col_ind, c.idxs[i])[:, :c.kas[i]]
            av = _take_rows(c.A.values, c.idxs[i])[:, :c.kas[i]]
            if w <= TRANSPOSED_MAX_WIDTH and f32:
                # every float32 class of these widths takes the gather
                # kernels: the JAX package's entry-budget gate (K5 above
                # it) is a VMEM limit with no counterpart here, same
                # results
                ac_e, av_e, ka_e = _chunk_entries(ac, av, c.chunks)
                rT = _table_rows(ac_e, kt).T.to(torch.int32).contiguous()
                out = _sort_compress_from_gather(
                    c.table, av_e.T.contiguous(), width=w, run=run,
                    ka=ka_e, start_kk=start_kk, out_width=out_c, rT=rT)
            else:
                key, val = _expand_ell(ac, av, c.B.col_ind, c.B.values,
                                       width=w, run=run, chunks=c.chunks)
                out = (_sort_compress_cols(key, val, width=w,
                                           start_kk=start_kk,
                                           out_width=out_c)
                       if w <= TRANSPOSED_MAX_WIDTH else
                       K.sort_compress_rows(key, val, width=w,
                                            start_kk=start_kk))
        col_c, val_c, nnz_c = out
        cols_p.append(col_c[:, :out_c])
        vals_p.append(val_c[:, :out_c])
        nnz_p.append(nnz_c)
    m = c.A.nrows
    if c.assemble == "bcsr":
        return _assemble_bcsr(cols_p, vals_p, nnz_p, c.idxs, c.src_full, m=m)
    dev = c.table.device
    col = torch.full((m + 1, c.out_w), -1, dtype=torch.int32, device=dev)
    val = torch.zeros((m + 1, c.out_w), dtype=vals_p[0].dtype, device=dev)
    nnz = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    for i in range(len(c.widths)):
        # row m collects the padded class rows and is dropped; nnz_row is
        # clamped to the stored width (an out_width cap can cut a row)
        oc = cols_p[i].shape[1]
        col[c.idxs[i], :oc] = cols_p[i]
        val[c.idxs[i], :oc] = vals_p[i]
        nnz[c.idxs[i]] = nnz_p[i][:, 0].clamp(max=oc)
    return col[:m], val[:m], nnz[:m]


def _assemble_bcsr(cols_p, vals_p, nnz_p, idxs, src_full, *, m: int):
    """Per-class compact outputs -> 128-aligned BlockCSR blocks with
    plan-constant spans: one block gather through src_full."""
    dev = src_full.device
    nnz = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    for c in range(len(cols_p)):
        nnz[idxs[c]] = nnz_p[c][:, 0].clamp(max=cols_p[c].shape[1])
    col_src = torch.cat([x.reshape(-1, 128) for x in cols_p])
    val_src = torch.cat([x.reshape(-1, 128) for x in vals_p])
    return col_src[src_full], val_src[src_full], nnz[:m]


def _finish_build(A, B, *, widths, kas, counts, run, chunks, out_w, ragged,
                  assemble, pregather, idxs, idx_h, frags, avts, table,
                  plan_device=False):
    """BlockCSR assembly map (host, m-sized) and the runnable call.
    Row r owns ocs[class(r)]/128 blocks, 0 when its A row is empty."""
    src_full = blk_ptr = None
    if assemble == "bcsr":
        m = A.nrows
        ocs = [min(out_w, int(w)) for w in widths]
        nblk = [counts[c] * ocs[c] // 128 for c in range(len(widths))]
        base = np.concatenate([[0], np.cumsum(nblk)])
        lens_h = A.nnz_row.cpu().numpy().astype(np.int64)
        src_start_h = np.zeros(m, np.int64)
        bpr_h = np.zeros(m, np.int64)
        for c in range(len(widths)):
            src_start_h[idx_h[c]] = base[c] + np.arange(
                len(idx_h[c]), dtype=np.int64) * (ocs[c] // 128)
            bpr_h[idx_h[c]] = ocs[c] // 128
        bpr_h[lens_h == 0] = 0
        blk_ptr_h = np.concatenate([[0], np.cumsum(bpr_h)])
        nb_out = int(blk_ptr_h[-1])
        src_full_h = np.repeat(src_start_h, bpr_h) \
            + (np.arange(nb_out, dtype=np.int64)
               - np.repeat(blk_ptr_h[:-1], bpr_h))
        src_full = torch.from_numpy(src_full_h).to(A.device)
        blk_ptr = torch.from_numpy(blk_ptr_h.astype(np.int32)).to(A.device)
    return MulticlassCall(A=A, B=B, widths=tuple(widths), kas=tuple(kas),
                          counts=tuple(counts), run=run, chunks=chunks,
                          out_w=out_w, ragged=ragged, assemble=assemble,
                          pregather=pregather, idxs=idxs, frags=frags,
                          avts=avts, table=table, src_full=src_full,
                          blk_ptr=blk_ptr, plan_device=plan_device)


def _results(call: MulticlassCall, out):
    shape = (call.A.nrows, call.B.ncols)
    if call.assemble == "bcsr":
        colb, valb, nnz_row = out
        return BlockCSR(blk_ptr=call.blk_ptr, col_blocks=colb,
                        val_blocks=valb, nnz_row=nnz_row,
                        nnz=nnz_row.sum(dtype=torch.int32), shape=shape)
    col, val, nnz_row = out
    return ELL(col_ind=col, values=val, nnz_row=nnz_row,
               nnz=nnz_row.sum(dtype=torch.int32), shape=shape)


# Planned calls keyed by the identity AND the version counter of the
# operand tensors: torch tensors are mutable, so an in-place edit bumps
# `_version` and misses. Entries pin their anchors (ids stay unique); the
# FIFO bound caps how much device memory cached plans hold.
_BUILD_CACHE: dict = {}
_BUILD_CACHE_STATS = {"hits": 0, "misses": 0}
_BUILD_CACHE_MAX = 2


def clear_plan_cache():
    _BUILD_CACHE.clear()
    _BUILD_CACHE_STATS.update(hits=0, misses=0)


def plan_cache_stats():
    return dict(_BUILD_CACHE_STATS)


def _multiclass_build(A: ELL, B: ELL, **kw):
    anchors = (A.col_ind, A.values, A.nnz_row,
               B.col_ind, B.values, B.nnz_row)
    key = (tuple((id(x), x._version) for x in anchors),
           tuple(sorted(kw.items())))
    cached = _BUILD_CACHE.get(key)
    if cached is not None:
        _BUILD_CACHE_STATS["hits"] += 1
        return cached[0]
    _BUILD_CACHE_STATS["misses"] += 1
    call = _multiclass_build_uncached(A, B, **kw)
    if len(_BUILD_CACHE) >= _BUILD_CACHE_MAX:
        _BUILD_CACHE.pop(next(iter(_BUILD_CACHE)))
    _BUILD_CACHE[key] = (call, anchors)
    return call


def _multiclass_build_uncached(A: ELL, B: ELL, *, max_classes: int,
                               out_width: int | None, assemble: str,
                               layout: str | None,
                               run_override: int | None, pregather: bool,
                               plan_device: bool):
    if assemble not in ("ell", "bcsr"):
        raise ValueError(f"unknown assemble mode {assemble!r}")
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if A.device != B.device:
        raise ValueError(f"operands on {A.device} and {B.device}")
    m = A.nrows
    kb = B.max_nnz_per_row
    lens = A.nnz_row.cpu().numpy().astype(np.int64)
    # Operands of another type than float32 plan the chunked layout only:
    # the ragged layout reads the float32 bit-packed table, so the JAX
    # package gates its probe on float32 (bitonic.py:1954-1962).
    f32 = A.dtype == torch.float32 and B.dtype == torch.float32
    # plan_device: the candidates' fragment totals are counted on the
    # device too, so only m-sized arrays come to the host
    b_len_h = B.nnz_row.cpu().numpy().astype(np.int64) if f32 else None
    probe = (dict(a_col_dev=A.col_ind, b_len_dev=B.nnz_row) if plan_device
             else dict(a_col_h=A.col_ind.cpu().numpy(), b_len_h=b_len_h))
    plan, W = plan_multiclass(lens, kb, max_classes=max_classes,
                              **(probe if f32 else {}), layout=layout,
                              run_override=run_override)
    if not plan.viable:
        return None
    widths, run, chunks = plan.widths, plan.run, plan.chunks
    out_w = int(widths[-1]) if out_width is None \
        else min(int(out_width), int(widths[-1]))
    if assemble == "bcsr":
        out_w = -(-out_w // 128) * 128   # whole 128-slot blocks

    def class_rows(w):
        idx = np.nonzero(W == w)[0]
        n_pad = cfg.bucket_capacity(max(len(idx), 1))
        padded = np.pad(idx, (0, n_pad - len(idx)), constant_values=m)
        return idx, n_pad, torch.from_numpy(padded.astype(np.int64)).to(
            A.device)

    idxs, idx_h, kas, counts = [], [], [], []
    frags, avts = [], []
    if plan.ragged:
        cm = -(-max(kb, 1) // run)
        b_frag_cnt = np.maximum(-(-np.maximum(b_len_h, 0) // run),
                                1).astype(np.int64)
        startp = np.concatenate([[0], np.cumsum(b_frag_cnt)])
        F_B = int(startp[-1])
        js = np.repeat(np.arange(len(b_frag_cnt)), b_frag_cnt)
        within_b = np.arange(F_B) - np.repeat(startp[:-1], b_frag_cnt)
        frag_src = js * cm + within_b
        for w in widths:
            idx, n_pad, idx_d = class_rows(w)
            idxs.append(idx_d)
            idx_h.append(idx)
            kas.append(max(1, int(w) // run))
            counts.append(int(n_pad))
        table = _ragged_table(B.col_ind, B.values,
                              torch.from_numpy(frag_src).to(A.device),
                              run=run, cm=cm)
        pregather = pregather and not plan_device
        if pregather:
            lanes = int(table.shape[1])
            g_bytes = sum(-(-kas[c] // _pg_pack(run, int(widths[c])))
                          * counts[c] * lanes * 4
                          for c in range(len(widths))
                          if int(widths[c]) <= TRANSPOSED_MAX_WIDTH)
            if g_bytes > PREGATHER_BUDGET_BYTES or not any(
                    int(w) <= TRANSPOSED_MAX_WIDTH for w in widths):
                pregather = False
        if plan_device:
            pass    # every call builds them (_multiclass_fn)
        elif pregather:
            frags, avts = _pregather_fragments_device(
                A, B, widths, run, idxs, kas, table, m)
        else:
            frags, avts = _host_fragments(A, b_len_h, widths, run, startp,
                                          F_B, idx_h, kas, counts)
    else:
        pregather = False
        per_entry = chunks * run
        for w in widths:
            idx, n_pad, idx_d = class_rows(w)
            idxs.append(idx_d)
            idx_h.append(idx)
            kas.append(max(1, min(A.max_nnz_per_row, w // per_entry)))
            counts.append(int(n_pad))
        # other types take _expand_ell: a one-row sentinel table
        table = (_build_wide_table(B.col_ind, B.values, run=run,
                                   chunks=chunks)[0] if f32 else
                 torch.full((1, 128), -1, dtype=torch.int32,
                            device=A.device))
    return _finish_build(A, B, widths=widths, kas=kas, counts=counts,
                         run=run, chunks=0 if plan.ragged else chunks,
                         out_w=out_w, ragged=plan.ragged,
                         assemble=assemble, pregather=pregather, idxs=idxs,
                         idx_h=idx_h, frags=frags, avts=avts, table=table,
                         plan_device=plan_device and plan.ragged)


def multiclass_planned(A: ELL, B: ELL, *, max_classes: int = 4,
                       out_width: int | None = None,
                       assemble: str = "ell",
                       layout: str | None = None,
                       run_override: int | None = None,
                       pregather: bool = False,
                       plan_device: bool = False):
    """Plan the width-class pipeline once and return a zero-argument
    callable (MulticlassCall) that runs it; None when not viable.
    Operands of any one float type; float32 ones may plan the ragged
    layout, others plan the chunked one (layout="ragged" on them is not
    viable).

    assemble="ell" returns an ELL padded to the widest class (or
    out_width); "bcsr" a BlockCSR. out_width caps every class's output
    width (rows past it are cut: the caller guarantees every row fits,
    as the headline does with the observed width). pregather=True also
    materialises g = table[MT] at plan time (within
    PREGATHER_BUDGET_BYTES), so a call skips the fragment gather.
    plan_device=True builds the ragged layout's fragment matrices on the
    device in every call instead of on the host at plan time (one-shot
    calls with no plan reuse; pregather is then off), and counts the
    planner's fragment totals on the device.
    layout "chunked" / "ragged" forces the planner's choice (None: its
    cost model decides); run_override pins the sub-run length. Repeat
    calls on the same, unmodified operands with the same options return
    the cached plan."""
    return _multiclass_build(A, B, max_classes=max_classes,
                             out_width=out_width, assemble=assemble,
                             layout=layout, run_override=run_override,
                             pregather=pregather, plan_device=plan_device)


def spgemm_bitonic_multiclass(A: ELL, B: ELL, *, max_classes: int = 4,
                              out_width: int | None = None,
                              assemble: str = "ell",
                              layout: str | None = None,
                              run_override: int | None = None,
                              plan_device: bool = False):
    """C = A @ B through the width-class route; None when not viable."""
    call = multiclass_planned(A, B, max_classes=max_classes,
                              out_width=out_width, assemble=assemble,
                              layout=layout, run_override=run_override,
                              plan_device=plan_device)
    return call() if call is not None else None


def spgemm_bitonic(A: ELL, B: ELL, plan: BitonicPlan | None = None,
                   layout: str = "auto", out_width: int | None = None,
                   compact: bool = True, value_mode: str = "f32") -> ELL:
    """C = A @ B with one global width (flat route). Returns left-justified
    ELL with ascending columns per row, values in the operands' type.

    layout "auto" takes the cols layout for widths up to
    TRANSPOSED_MAX_WIDTH and the rows layout (torch expand + K4) above;
    "cols" or "rows" forces one. The cols layout reads float32 operands
    within the gather budget (ka*chunks*lanes <= _EXPAND_TILE_ELEMS)
    through the expand-from-gather kernels (K1 / K2 + K3), and everything
    else (float64, or a wide A) through the torch expand (K5 / K6 + K3).
    out_width caps the output width of the cols layout (the caller
    guarantees every row fits); compact=False keeps survivors at their
    sorted slots (honoured by K3 after K2, and by K7b, as in the JAX
    package).

    value_mode="bf16", the serve lane (K7a + K7b): each product rounds to
    bfloat16 and is packed with its column into one int32 sort key; sums
    accumulate in float32 (per-product relative error <= 2^-9). It needs
    the expand-from-gather path with float32 operands, B.ncols <= 32768
    (15 column bits) and no entry split, as in the JAX package, and
    raises ValueError otherwise."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if plan is None:
        plan = plan_bitonic(A, B)
    if not plan.viable:
        raise ValueError(f"bitonic plan not viable: {plan.reason}")
    if value_mode not in ("f32", "bf16"):
        raise ValueError(f"unknown value_mode {value_mode!r}")
    if A.device != B.device:
        raise ValueError(f"operands on {A.device} and {B.device}")
    use_cols = layout == "cols" or (layout == "auto"
                                    and plan.width <= TRANSPOSED_MAX_WIDTH)
    ka_eff = A.col_ind.shape[1] * plan.chunks
    lanes = max(128, 4 * plan.run)
    f32 = A.dtype == torch.float32 and B.dtype == torch.float32
    fused_expand = (use_cols and f32 and ka_eff * plan.run <= plan.width
                    and ka_eff * lanes <= _EXPAND_TILE_ELEMS)
    if value_mode == "bf16":
        if not fused_expand:
            raise ValueError(
                "value_mode='bf16' requires the fused-expand path "
                "(f32 inputs within the gather-tile budget)")
        if B.ncols > 32768:
            raise ValueError(
                f"value_mode='bf16' packs columns into 15 bits; "
                f"n={B.ncols} > 32768")
        table, rT, avT = _flat_table(A.col_ind, A.values, B.col_ind,
                                     B.values, run=plan.run,
                                     chunks=plan.chunks)
        out_w = plan.width if (out_width is None or not compact) \
            else min(out_width, plan.width)
        p = K.expand_sort_packed(table, rT, avT, ka=ka_eff, run=plan.run,
                                 width=plan.width, start_kk=2 * plan.run)
        col, val, nnz = K.compress_packed(p, width=plan.width, out_w=out_w,
                                          compact=compact)
        nnz_row = nnz[:, 0]
        return ELL(col_ind=col, values=val, nnz_row=nnz_row,
                   nnz=nnz_row.sum(dtype=torch.int32),
                   shape=(A.nrows, B.ncols))
    start_kk = 2 * plan.run
    if fused_expand:
        table, rT, avT = _flat_table(A.col_ind, A.values, B.col_ind,
                                     B.values, run=plan.run,
                                     chunks=plan.chunks)
        col, val, nnz = _sort_compress_from_gather(
            table, avT, width=plan.width, run=plan.run, ka=ka_eff,
            start_kk=start_kk, out_width=out_width, compact=compact, rT=rT)
    else:
        key, v = _expand_ell(A.col_ind, A.values, B.col_ind, B.values,
                             width=plan.width, run=plan.run,
                             chunks=plan.chunks)
        col, val, nnz = (
            _sort_compress_cols(key, v, width=plan.width, start_kk=start_kk,
                                out_width=out_width) if use_cols else
            K.sort_compress_rows(key, v, width=plan.width,
                                 start_kk=start_kk))
    nnz_row = nnz[:, 0]
    return ELL(col_ind=col, values=val, nnz_row=nnz_row,
               nnz=nnz_row.sum(dtype=torch.int32),
               shape=(A.nrows, B.ncols))
