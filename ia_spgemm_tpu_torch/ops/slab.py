"""Slab-packed ESC: expand / sort / compress with many C rows per sort
(PyTorch port of ``ia_spgemm_tpu.ops.slab``).

1. plan (host numpy, ported line for line so plans are equal): whole
   rows are packed greedily into fixed-width slabs over their padded
   product counts (the reference's upper_bound over the cumulative row
   workspace, coo_dev/common_coo_dev.h:388-421), and per-slab fragment
   matrices (table row, A value, slab-local row) are built, transposed
   to (F_c, S_pad).
2. run: kernel K8 (each slab's fragments read from the packed B
   fragment table through its fragment index, expanded with keys
   ``local_row * n + col``, one bitonic sort per slab,
   ``ops/slab_kernels.py``), then K3 (duplicate sums and
   compaction per slab, ``ops/bitonic_kernels.py``). The compensated
   pipeline runs K9 (float64 products) and K10 (float64 run sums, split
   into a float32 hi/lo pair) instead.
3. output: SlabCSR, exact and row-major sorted; ``slab_to_csr`` flattens
   it to CSR as a priced, separate conversion (gather or scatter).

f32 operands only; the planner returns None (the JAX package's routing)
when the engine is not viable, and callers take another engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ia_spgemm_tpu_torch import config as cfg
from ia_spgemm_tpu_torch import tracing
from ia_spgemm_tpu_torch.formats.types import CSR, SlabCSR
from ia_spgemm_tpu_torch.ops import bitonic
from ia_spgemm_tpu_torch.ops import bitonic_kernels as BK
from ia_spgemm_tpu_torch.ops import esc
from ia_spgemm_tpu_torch.ops import slab_kernels as SK

# sub-run fragment length: [col|val|col_rev|val_rev] fills 128 table lanes
DEFAULT_RUN = 32
# slab widths (the JAX package's caps, kept so plans are equal)
SLAB_MAX_WIDTH = 1024
SLAB_MIN_WIDTH = 512
# total padded product slots allowed (n_slabs * width)
SLAB_ELEMS_BUDGET = 1 << 28
# slab count padding (the TPU's 128-lane tile; kept so plans are equal)
_TILE_LANES = 128


@dataclasses.dataclass
class SlabPlan:
    """Host-side slab packing + device operands for one (A, B) problem."""
    width: int
    run: int
    n_slabs: int           # padded to a _TILE_LANES multiple
    out_cap: int
    nnz_bound: int         # exact output-nnz upper bound (pre-bucket)
    m: int
    n: int
    padded_slots: int      # n_slabs * width (sort volume incl. padding)
    true_flops: int        # exact E (GetFlop)
    mt: torch.Tensor       # (F_c, n_slabs) fragment-table row ids
    avt: torch.Tensor      # (F_c, n_slabs) owning A values
    lrt: torch.Tensor      # (F_c, n_slabs) slab-local C-row ids
    table: torch.Tensor    # packed B fragment table (F_B+1, lanes)
    slab_first_row: torch.Tensor  # (n_slabs, 1) global row of local row 0


def _slab_run(table, mt, avt, lrt, *, F_c: int, W: int, run: int, n: int,
              sp=None):
    """K8 (expand from the table + sort) -> K3 (compress) -> nnz fold.
    Returns (keys (S, W), vals, nnz_s (S, 1), total)."""
    if sp:
        sp.leaf("slab.sort")
    key, val = SK.expand_sort_lr(table, mt, avt, lrt, ka=F_c, run=run,
                                 width=W, n=n, start_kk=2 * run)
    if sp:
        sp.leaf("slab.compress")
    keys, vals, nnz_s = BK.compress(key, val, width=W, out_w=W)
    return keys, vals, nnz_s, nnz_s.sum(dtype=torch.int32)


def _slab_run_dd(table, mt, avt, lrt, *, F_c: int, W: int, run: int,
                 n: int, sp=None):
    """The compensated pipeline: K9 -> K10 -> nnz fold. Returns (keys, hi,
    lo, nnz_s, total)."""
    if sp:
        sp.leaf("slab.sort")
    key, val = SK.expand_sort_lr_dd(table, mt, avt, lrt, ka=F_c, run=run,
                                    width=W, n=n, start_kk=2 * run)
    if sp:
        sp.leaf("slab.compress")
    keys, his, los, nnz_s = SK.compress_dd(key, val, width=W)
    return keys, his, los, nnz_s, nnz_s.sum(dtype=torch.int32)


@dataclasses.dataclass
class SlabCall:
    """A planned slab product; call it to run. Returns SlabCSR (with
    values_lo when dd)."""
    plan: SlabPlan
    dd: bool
    shape: tuple

    def __call__(self, sp=None) -> SlabCSR:
        """The product. ``sp``, the caller's ``tracing.Tracer`` whose top
        is open (None: no spans), opens the leaves ``slab.sort`` (K8 /
        K9) and ``slab.compress`` (K3 / K10 and the nnz fold). Counts the
        plan's padded slots (``slab.padded_slots``)."""
        p = self.plan
        tracing.count("slab.padded_slots", p.padded_slots)
        kw = dict(F_c=p.width // p.run, W=p.width, run=p.run, n=p.n)
        lo = None
        if self.dd:
            keys, vals, lo, nnz_s, total = _slab_run_dd(
                p.table, p.mt, p.avt, p.lrt, sp=sp, **kw)
        else:
            keys, vals, nnz_s, total = _slab_run(
                p.table, p.mt, p.avt, p.lrt, sp=sp, **kw)
        return SlabCSR(keys=keys, values=vals, values_lo=lo,
                       nnz_slab=nnz_s[:, 0],
                       slab_first_row=p.slab_first_row[:, 0], nnz=total,
                       shape=self.shape)


# Planned calls keyed by the identity and version counter of the operand
# tensors (as ops.bitonic's plan cache): an in-place edit misses. Entries
# pin their anchors; the FIFO bound caps the device memory they hold.
_BUILD_CACHE: dict = {}
_BUILD_CACHE_MAX = 2


def clear_plan_cache():
    _BUILD_CACHE.clear()


def plan_slab_csr(A: CSR, B: CSR, *, width: int | None = None,
                  run: int | None = None, dd: bool = False):
    """Plan the slab engine for C = A @ B (cached); see
    _plan_slab_csr_uncached."""
    anchors = (A.row_ptr, A.col_ind, A.values, B.row_ptr, B.col_ind,
               B.values)
    key = (tuple((id(x), x._version) for x in anchors), width, run, dd)
    hit = _BUILD_CACHE.get(key)
    if hit is not None:
        return hit[0]
    call = _plan_slab_csr_uncached(A, B, width=width, run=run, dd=dd)
    if len(_BUILD_CACHE) >= _BUILD_CACHE_MAX:
        _BUILD_CACHE.pop(next(iter(_BUILD_CACHE)))
    _BUILD_CACHE[key] = (call, anchors)
    return call


def _plan_slab_csr_uncached(A: CSR, B: CSR, *, width: int | None = None,
                            run: int | None = None, dd: bool = False):
    """Host-plan the slab engine for C = A @ B (both CSR, float32) and
    return a SlabCall, or None when the engine is not viable (non-f32, a
    row's padded products exceed the slab width cap, the padded volume
    exceeds the budget, or slab-local keys would not fit int32).

    dd=True plans the compensated pipeline (K9 + K10): float64-grade
    sums, SlabCSR with values_lo. Planning is nnz-scaled host numpy."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if A.values.dtype != torch.float32 or B.values.dtype != torch.float32:
        return None
    run = int(run) if run else DEFAULT_RUN
    m, n = A.nrows, B.ncols
    nnzA = int(A.nnz)
    if nnzA == 0 or int(B.nnz) == 0:
        return None  # trivial problems stay on the general engine
    dev = A.device
    a_rp = A.row_ptr.cpu().numpy().astype(np.int64)
    a_col = A.col_ind.cpu().numpy()[:nnzA].astype(np.int64)
    a_val = A.values.cpu().numpy()[:nnzA].astype(np.float32)
    b_len = np.diff(B.row_ptr.cpu().numpy()).astype(np.int64)

    e_len = b_len[np.clip(a_col, 0, B.nrows - 1)]
    frag_e = -(-e_len // run)                       # 0 for empty B rows
    ecs = np.concatenate([[0], np.cumsum(frag_e)])
    prf = (ecs[a_rp[1:]] - ecs[a_rp[:-1]]) * run    # padded row products
    rf = np.concatenate([[0], np.cumsum(e_len)])
    rf = rf[a_rp[1:]] - rf[a_rp[:-1]]               # true row products
    max_prf = int(prf.max(initial=0))
    if max_prf == 0:
        return None
    W = int(width) if width else max(
        SLAB_MIN_WIDTH, bitonic._next_pow2(max_prf))
    if max_prf > W or W > SLAB_MAX_WIDTH:
        return None

    # greedy packing of nonempty rows over the padded-flops prefix
    live_rows = np.nonzero(prf > 0)[0]
    pl_live = prf[live_rows]
    csum = np.concatenate([[0], np.cumsum(pl_live)])
    bounds = [0]
    nlive = len(live_rows)
    while bounds[-1] < nlive:
        r0 = bounds[-1]
        r1 = int(np.searchsorted(csum, csum[r0] + W, side="right")) - 1
        bounds.append(max(r1, r0 + 1))
    n_slabs = len(bounds) - 1
    S_pad = -(-n_slabs // _TILE_LANES) * _TILE_LANES
    F_c = W // run
    if S_pad * W > SLAB_ELEMS_BUDGET:
        return None
    bounds = np.asarray(bounds, dtype=np.int64)
    slab_of = np.repeat(np.arange(n_slabs, dtype=np.int64),
                        np.diff(bounds))                   # per live row
    # local row = global row offset from the slab's first row (empty rows
    # inside a slab keep their gap, so slab_first_row + key // n decodes)
    first_row = live_rows[bounds[:-1]]                     # per slab
    lrow_of = live_rows - first_row[slab_of]
    rspan = int(lrow_of.max(initial=0)) + 1
    if rspan * n >= 2**31:
        return None  # slab-local keys must fit int32 below SENTINEL

    # B's fragments (its nonempty rows cut into runs), in row order
    b_cnt = -(-b_len // run)
    startp = np.concatenate([[0], np.cumsum(b_cnt)])
    F_B = int(startp[-1])
    js = np.repeat(np.arange(len(b_cnt)), b_cnt)
    within_b = np.arange(F_B) - np.repeat(startp[:-1], b_cnt)

    # global fragment stream over A's entries -> (slab, fragment slot)
    F_total = int(ecs[-1])
    src_e = np.repeat(np.arange(nnzA, dtype=np.int64), frag_e)
    within = np.arange(F_total, dtype=np.int64) \
        - np.repeat(ecs[:-1], frag_e)
    mval = startp[a_col[src_e]] + within                # table row ids
    row_of_e = np.repeat(np.arange(m, dtype=np.int64), np.diff(a_rp))
    rows_f = row_of_e[src_e]
    live_rank = np.zeros(m, np.int64)
    live_rank[live_rows] = np.arange(nlive)
    lr_f = live_rank[rows_f]
    # a fragment's slot in its slab: its stream position minus the
    # stream start of the slab's first live row
    slab_f = slab_of[lr_f]
    slab_stream_start = ecs[a_rp[live_rows[bounds[:-1]]]]
    fpos = np.arange(F_total, dtype=np.int64) \
        - slab_stream_start[slab_f]

    tgt = slab_f * F_c + fpos
    M_flat = np.full(S_pad * F_c, F_B, np.int32)
    AV_flat = np.zeros(S_pad * F_c, np.float32)
    LR_flat = np.zeros(S_pad * F_c, np.int32)
    M_flat[tgt] = mval.astype(np.int32)
    AV_flat[tgt] = a_val[src_e]
    LR_flat[tgt] = lrow_of[lr_f].astype(np.int32)

    def dev_t(flat):
        return torch.from_numpy(np.ascontiguousarray(
            flat.reshape(S_pad, F_c).T)).to(dev)

    # the packed table (pre-reversed runs, 128 lanes) from B's CSR arrays
    table = bitonic._ragged_table(
        B.row_ptr, B.col_ind, B.values, torch.from_numpy(js).to(dev),
        torch.from_numpy(within_b).to(dev), run=run)

    sfr_h = np.zeros((S_pad, 1), np.int32)
    sfr_h[:n_slabs, 0] = live_rows[bounds[:-1]]

    nnz_bound = int(np.minimum(rf, n).sum())
    out_cap = cfg.bucket_capacity(max(nnz_bound, 1))
    if out_cap + W >= 2**31:
        return None

    plan = SlabPlan(width=W, run=run, n_slabs=S_pad, out_cap=out_cap,
                    nnz_bound=nnz_bound, m=m, n=n, padded_slots=S_pad * W,
                    true_flops=int(e_len.sum()), mt=dev_t(M_flat),
                    avt=dev_t(AV_flat), lrt=dev_t(LR_flat), table=table,
                    slab_first_row=torch.from_numpy(sfr_h).to(dev))
    return SlabCall(plan=plan, dd=dd, shape=(m, n))


# --------------------------------------------------------- flattening

def _compact_xla(keys, vals, nnz_s, sfr, *, n: int, out_cap: int):
    """Slab concatenation as scatters: survivor t of slab s goes to
    base[s] + t (the JAX package's drop-mode scatter formulation)."""
    S, W = keys.shape
    dev = keys.device
    base = F.pad(torch.cumsum(nnz_s[:, 0], 0), (1, 0))
    t = torch.arange(W, device=dev)[None, :]
    ok = t < nnz_s
    dst = torch.where(ok, base[:-1, None] + t, out_cap).reshape(-1)
    dst = dst.clamp(max=out_cap)
    lrow = torch.div(keys, n, rounding_mode="floor")
    rows = torch.where(ok, sfr + lrow, 0).reshape(-1).to(torch.int32)
    cols = torch.where(ok, keys - lrow * n, 0).reshape(-1).to(torch.int32)
    vv = torch.where(ok, vals, torch.zeros((), dtype=vals.dtype,
                                           device=dev)).reshape(-1)
    out_r = torch.zeros(out_cap + 1, dtype=torch.int32, device=dev)
    out_c = torch.zeros(out_cap + 1, dtype=torch.int32, device=dev)
    out_v = torch.zeros(out_cap + 1, dtype=vals.dtype, device=dev)
    return (out_r.scatter_(0, dst, rows), out_c.scatter_(0, dst, cols),
            out_v.scatter_(0, dst, vv))


def _compact_gather(keys, vals, nnz_s, sfr, *, n: int, out_cap: int,
                    vals_lo=None):
    """Slab concatenation inverted into per-output-position gathers: the
    output -> source map is piecewise linear (output base[s] + t reads
    slot t of slab s), so src(p) = p + off(p) with off jumping only at
    slab starts; off comes from one S-sized scatter of deltas and a
    cumsum. Positions past the total clip and are masked by
    _finalize_csr."""
    S, W = keys.shape
    dev = keys.device
    base = F.pad(torch.cumsum(nnz_s[:, 0].long(), 0), (1, 0))
    offs = torch.arange(S, device=dev) * W - base[:-1]
    d_off = offs - F.pad(offs[:-1], (1, 0))
    sfr0 = sfr[:, 0].long()
    sfr_d = sfr0 - F.pad(sfr0[:-1], (1, 0))
    pos_s = base[:-1].clamp(max=out_cap)
    g_off = torch.zeros(out_cap + 1, dtype=torch.int64, device=dev)
    g_sfr = torch.zeros(out_cap + 1, dtype=torch.int64, device=dev)
    g_off.index_add_(0, pos_s, d_off)
    g_sfr.index_add_(0, pos_s, sfr_d)
    p = torch.arange(out_cap, device=dev)
    src = (p + torch.cumsum(g_off[:out_cap], 0)).clamp(0, S * W - 1)
    sfr_p = torch.cumsum(g_sfr[:out_cap], 0)
    k = keys.reshape(-1)[src].long()
    vv = vals.reshape(-1)[src]
    lrow = torch.div(k, n, rounding_mode="floor")
    rows = F.pad((sfr_p + lrow).to(torch.int32), (0, 1))
    cols = F.pad((k - lrow * n).to(torch.int32), (0, 1))
    out = (rows, cols, F.pad(vv, (0, 1)))
    if vals_lo is not None:
        out += (F.pad(vals_lo.reshape(-1)[src], (0, 1)),)
    return out


def _finalize_csr(rows_raw, cols_raw, vals_raw, total, *, m: int, n: int,
                  out_cap: int):
    """Mask the tail past the exact nnz, then derive row_ptr from the
    ascending compacted row stream."""
    live = torch.arange(out_cap, device=rows_raw.device) < total
    rows = torch.where(live, rows_raw[:out_cap], m)
    col = torch.where(live, cols_raw[:out_cap], n)
    val = torch.where(live, vals_raw[:out_cap],
                      torch.zeros((), dtype=vals_raw.dtype,
                                  device=vals_raw.device))
    row_ptr = torch.searchsorted(
        rows, torch.arange(m + 1, dtype=torch.int32, device=rows.device),
        side="left").to(torch.int32)
    return row_ptr, col, val


def slab_to_csr(C: SlabCSR, *, out_cap: int | None = None,
                engine: str = "gather") -> CSR:
    """Flatten a SlabCSR to exact CSR on its device: a priced conversion,
    not part of the engine's hot path. engine="gather" (default) inverts
    the concatenation into gathers; "scatter" keeps the scatter form."""
    m, n = C.shape
    if out_cap is None:
        out_cap = cfg.bucket_capacity(max(int(C.keys.shape[0])
                                          * int(C.keys.shape[1]), 1))
    nnz_s = C.nnz_slab[:, None]
    sfr = C.slab_first_row[:, None]
    if engine == "gather":
        parts = _compact_gather(C.keys, C.values, nnz_s, sfr, n=n,
                                out_cap=out_cap, vals_lo=C.values_lo)
        rows_raw, cols_raw, vals_raw = parts[:3]
        lo_raw = parts[3] if C.values_lo is not None else None
    elif engine == "scatter":
        rows_raw, cols_raw, vals_raw = _compact_xla(
            C.keys, C.values, nnz_s, sfr, n=n, out_cap=out_cap)
        lo_raw = None
        if C.values_lo is not None:
            _, _, lo_raw = _compact_xla(C.keys, C.values_lo, nnz_s, sfr,
                                        n=n, out_cap=out_cap)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    row_ptr, col, val = _finalize_csr(rows_raw, cols_raw, vals_raw, C.nnz,
                                      m=m, n=n, out_cap=out_cap)
    val_lo = None
    if lo_raw is not None:
        val_lo = torch.where(
            torch.arange(out_cap, device=lo_raw.device) < C.nnz,
            lo_raw[:out_cap], torch.zeros((), device=lo_raw.device))
    return CSR(row_ptr=row_ptr, col_ind=col, values=val, values_lo=val_lo,
               nnz=C.nnz, shape=C.shape)


def spgemm_csr_slab(A: CSR, B: CSR, *, width: int | None = None,
                    run: int | None = None):
    """C = A @ B through the slab engine (SlabCSR out); None when not
    viable."""
    call = plan_slab_csr(A, B, width=width, run=run)
    return call() if call is not None else None


# ------------------------------------------------------------- hybrid

@dataclasses.dataclass
class HybridCSR:
    """Disjoint-row composition of a SlabCSR (light rows) and a CSR (the
    heavy rows), the slab + global hybrid's output. Exact: the parts
    cover disjoint row sets."""
    light: SlabCSR
    heavy: CSR
    shape: tuple

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> torch.Tensor:
        return self.light.nnz + self.heavy.nnz

    def checksum(self) -> torch.Tensor:
        return self.light.checksum() + self.heavy.checksum()

    def to_scipy(self):
        return (self.light.to_scipy() + self.heavy.to_scipy()).tocsr()


@dataclasses.dataclass
class HybridCall:
    """A planned hybrid product; call it to run (HybridCSR out)."""
    light_call: SlabCall
    A_heavy: CSR
    B: CSR
    heavy_plan: object
    n_heavy: int
    shape: tuple

    def __call__(self) -> HybridCSR:
        """Counters (plan constants, once a call): ``hybrid.calls``,
        ``hybrid.light_products``, ``hybrid.heavy_products``. Spans, while
        tracing is active: ``hybrid.call``, inside it ``hybrid.light``
        (the slab call's leaves) and ``hybrid.heavy`` (the global
        engine's)."""
        tracing.count_all((
            ("hybrid.calls", 1),
            ("hybrid.light_products", self.light_call.plan.true_flops),
            ("hybrid.heavy_products", self.heavy_plan.flops)))
        sp = tracing.tracer(self.B.row_ptr.device)
        if sp is None:
            light = self.light_call()
            heavy = esc.spgemm_csr_global(self.A_heavy, self.B,
                                          self.heavy_plan)
        else:
            with sp.top("hybrid.call",
                        f"call={tracing.counter('hybrid.calls')}"):
                with sp.child("hybrid.light") as t:
                    light = self.light_call(t)
                with sp.child("hybrid.heavy") as t:
                    heavy = esc.spgemm_csr_global(self.A_heavy, self.B,
                                                  self.heavy_plan, t)
        return HybridCSR(light=light, heavy=heavy, shape=self.shape)


def plan_slab_hybrid(A: CSR, B: CSR):
    """The slab engine for the rows it admits plus the global engine for
    the heavy rows (padded products over the slab width cap). Returns a
    HybridCall, or None when A has no heavy rows (plan_slab_csr applies),
    only heavy rows, or the light part is not viable."""
    if A.values.dtype != torch.float32 or B.values.dtype != torch.float32:
        return None
    nnzA = int(A.nnz)
    if nnzA == 0:
        return None
    run = DEFAULT_RUN
    a_rp = A.row_ptr.cpu().numpy().astype(np.int64)
    a_col = A.col_ind.cpu().numpy()[:nnzA].astype(np.int64)
    a_val = A.values.cpu().numpy()[:nnzA]
    b_len = np.diff(B.row_ptr.cpu().numpy()).astype(np.int64)
    e_len = b_len[np.clip(a_col, 0, B.nrows - 1)]
    frag_e = -(-e_len // run)
    ecs = np.concatenate([[0], np.cumsum(frag_e)])
    prf = (ecs[a_rp[1:]] - ecs[a_rp[:-1]]) * run
    heavy = prf > SLAB_MAX_WIDTH
    n_heavy = int(heavy.sum())
    if n_heavy == 0 or n_heavy == A.nrows:
        return None

    def split(mask):
        rl = np.diff(a_rp) * mask
        rp = np.concatenate([[0], np.cumsum(rl)]).astype(np.int64)
        keep = np.repeat(mask, np.diff(a_rp))
        total = int(rp[-1])
        col = np.full(max(total, 1), A.ncols, np.int32)
        val = np.zeros(max(total, 1), a_val.dtype)
        col[:total] = a_col[keep]
        val[:total] = a_val[keep]
        return CSR.from_numpy(rp.astype(np.int32), col, val, total, A.shape,
                              device=A.device)

    A_light = split(~heavy)
    A_heavy = split(heavy)
    light_call = plan_slab_csr(A_light, B)
    if light_call is None:
        return None
    return HybridCall(light_call=light_call, A_heavy=A_heavy, B=B,
                      heavy_plan=esc.plan_spgemm(A_heavy, B),
                      n_heavy=n_heavy, shape=(A.nrows, B.ncols))
