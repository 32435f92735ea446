"""ESC (expand-sort-compress) SpGEMM and the production CSR entry
(PyTorch port of ``ia_spgemm_tpu.ops.esc``).

- ``plan_spgemm`` / ``spgemm_csr``: the global-sort engine. Every
  intermediate product (i, j, a*b) is materialised, sorted by (i, j) and
  duplicate runs summed; expansions beyond the workspace are row-sliced
  (the reference's sliced ESC, coo_dev/common_coo_dev.h:388-450). This was
  plain XLA in the JAX package, so it is plain torch here
  (``torch.sort``, scans, gathers) on the operands' device. Where
  (m+1)(n+1) >= 2^31 the sort key is one int64 ``i*n + j`` (the JAX
  package sorts two int32 keys); the order is the same. The expansion
  that feeds the sort is kernel K14 on the card
  (``ops/esc_kernels.esc_expand``).
- ``plan_csr_auto`` / ``spgemm_csr_auto``: a cost model picks the tiled
  width-class route (``ops/bitonic.py``), the slab engine
  (``ops/slab.py``), the slab + global hybrid, or the global engine. The
  model's constants are the JAX package's (measured on a TPU v5e), kept
  so the port picks the same route; they say nothing about this card.
- ``spgemm_coo``: COO operands through the global engine.
- ``spgemm_csr_compensated``: float32 operands, float64-grade sums,
  returned as a float32 (hi, lo) pair. The slab route runs kernels K9 +
  K10; the global fallback forms exact float64 products and float64 run
  sums (this card has float64; the TPU needed double-double arithmetic).

Plan capacities (``SpGEMMPlan``) are the JAX package's, from the same
host arithmetic, so plans compare equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ia_spgemm_tpu_torch import config as cfg
from ia_spgemm_tpu_torch import tracing
from ia_spgemm_tpu_torch.formats.types import COO, CSR
from ia_spgemm_tpu_torch.ops import esc_kernels as EK
from ia_spgemm_tpu_torch.utils.scans import entry_rows

# Single-slab workspace ceiling, in intermediate products (the JAX
# package's value, sized for a 16 GB TPU; kept so plans stay equal).
DEFAULT_WORKSPACE_ELEMS = 1 << 28
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class SpGEMMPlan:
    """Static capacities for one (A, B) SpGEMM problem."""
    expansion_capacity: int   # >= E of a slab (number of products)
    out_capacity: int         # >= nnz(C) of a slab
    flops: int                # exact total E, the reference's GetFlop(A, B)
    # "gather": per-product gather into an exact-size expansion;
    # "rowexpand": one row gather of B's padded ELL row per A entry into
    # a (nnzA, b_run) grid, when the pow2 padding at most doubles it
    variant: str = "gather"
    b_run: int = 0
    # workspace slicing: row bounds [0, r1, ..., m] whose slabs each fit
    # the workspace; None = single slab. Slabs share the capacities below.
    slabs: tuple | None = None
    rows_capacity: int = 0
    nnza_capacity: int = 0
    total_out_capacity: int = 0


def plan_spgemm(A: CSR, B: CSR, *, bucket: bool = True,
                workspace_elems: int | None = None) -> SpGEMMPlan:
    """Symbolic pass and capacities (the reference's phase-1 bound,
    csr/common_csr.h:100-125); expansions beyond `workspace_elems` get a
    sliced plan of greedy row slabs (coo_dev/common_coo_dev.h:388-421)."""
    from ia_spgemm_tpu_torch.ops import symbolic
    ws = workspace_elems or DEFAULT_WORKSPACE_ELEMS
    ws = min(ws, _INT32_MAX - 1)
    # bucket_capacity rounds up by <= 25%: keep even the bucketed
    # capacity below int32 positions
    while cfg.bucket_capacity(ws) > _INT32_MAX - 1:
        ws -= max(ws // 16, 1)
    E, out_bound, max_rf, rf = symbolic.plan_symbolic(A, B,
                                                      return_rows=True)
    b_maxlen = int(np.diff(B.row_ptr.cpu().numpy()).max(initial=0))
    run = 1 << max(b_maxlen - 1, 0).bit_length()
    if E > ws:
        if max_rf > ws:
            raise ValueError(
                f"a single row expands to {max_rf} products, beyond the "
                f"{ws}-element workspace; row-partition the problem or "
                "raise workspace_elems")
        csum = np.concatenate([[0], np.cumsum(rf, dtype=np.int64)])
        bounds = [0]
        while bounds[-1] < len(rf):
            r0 = bounds[-1]
            r1 = int(np.searchsorted(csum, csum[r0] + ws, side="right")) - 1
            bounds.append(max(r1, r0 + 1))
        slabs = tuple(bounds)
        spans = [(slabs[i], slabs[i + 1]) for i in range(len(slabs) - 1)]
        row_ptr = A.row_ptr.cpu().numpy().astype(np.int64)
        slab_E = max(int(rf[r0:r1].sum()) for r0, r1 in spans)
        slab_out = max(int(np.minimum(rf[r0:r1], B.ncols).sum())
                       for r0, r1 in spans)
        slab_nnz = max(int(row_ptr[r1] - row_ptr[r0]) for r0, r1 in spans)
        slab_rows = max(r1 - r0 for r0, r1 in spans)
        total_out = int(np.minimum(rf, B.ncols).sum())
        if total_out >= _INT32_MAX:
            raise ValueError(
                f"output bound {total_out} overflows int32 positions; "
                "row-partition the problem")
        return SpGEMMPlan(
            expansion_capacity=cfg.bucket_capacity(slab_E, enabled=bucket),
            out_capacity=cfg.bucket_capacity(slab_out or 1, enabled=bucket),
            flops=E, variant="gather", b_run=0, slabs=slabs,
            rows_capacity=cfg.bucket_capacity(slab_rows, enabled=bucket),
            nnza_capacity=cfg.bucket_capacity(slab_nnz or 1,
                                              enabled=bucket),
            total_out_capacity=cfg.bucket_capacity(total_out or 1,
                                                   enabled=bucket))
    e_cap = cfg.bucket_capacity(E, enabled=bucket)
    out_cap = cfg.bucket_capacity(out_bound or 1, enabled=bucket)
    variant, b_run = "gather", 0
    # (float32 only, as in the JAX package)
    if (b_maxlen > 0 and A.capacity * run <= 2 * e_cap
            and A.values.dtype == torch.float32
            and B.values.dtype == torch.float32):
        variant, b_run = "rowexpand", run
        e_cap = A.capacity * run
    return SpGEMMPlan(expansion_capacity=e_cap, out_capacity=out_cap,
                      flops=E, variant=variant, b_run=b_run)


# ------------------------------------------------------- sort + compress

def _segmented_scan_add(v, head):
    """Inclusive prefix sums that reset at `head`: a Hillis-Steele
    log-step scan, each run combined in balanced-tree order (accuracy of
    a per-run tree sum, not of a global cumsum difference)."""
    s, f = v, head
    size = s.shape[0]
    d = 1
    while d < size:
        s_sh = F.pad(s[:-d], (d, 0))
        f_sh = F.pad(f[:-d], (d, 0), value=True)
        s = torch.where(f, s, s + s_sh)
        f = f | f_sh
        d *= 2
    return s


def _sort_compress(key, v, *, out_cap: int, m: int, n: int, sp=None):
    """Sort products by their keys i*n + j (``EK.key_dtype``; m*n marks
    an empty slot), sum duplicate runs, compact. Returns (row_ptr,
    col_ind, values, nnz) padded to out_cap (col n, value 0 past nnz).
    float64 runs are summed by a scatter-add, others by the segmented
    scan (as in the JAX package). ``sp`` (a call's ``tracing.Tracer``,
    None: tracing off) opens the leaves ``esc.sort`` and
    ``esc.compress``."""
    if sp:
        sp.leaf("esc.sort")
    e_cap = v.shape[0]
    dev = v.device
    kd = key.dtype
    inval = m * n
    if out_cap > e_cap:
        pad = out_cap - e_cap
        key = torch.cat([key, key.new_full((pad,), inval)])
        v = F.pad(v, (0, pad))
        e_cap = out_cap
    key_s, order = torch.sort(key, stable=True)
    v_s = v[order]
    if sp:
        sp.leaf("esc.compress")
    valid_s = key_s < inval
    edge = torch.full((1,), -1, dtype=kd, device=dev)
    head = valid_s & (key_s != torch.cat([edge, key_s[:-1]]))
    is_last = valid_s & (key_s != torch.cat([key_s[1:], edge]))
    seg = torch.cumsum(head, 0) - 1
    nnz_c = head.sum(dtype=torch.int32)
    if v.dtype == torch.float64:
        segc = seg.clamp(0, e_cap - 1)
        sums = torch.zeros(e_cap, dtype=v.dtype, device=dev)
        sums.index_add_(0, segc, v_s)
        run_pref = sums[segc]
    else:
        run_pref = _segmented_scan_add(v_s, head)
    # compaction: each run's last element (carrying the run sum) moves
    # to slot seg; everything else lands in a dropped slot
    dst = torch.where(is_last & (seg < out_cap), seg, out_cap)
    key_c = torch.full((out_cap + 1,), inval, dtype=kd, device=dev)
    val_c = torch.zeros(out_cap + 1, dtype=v.dtype, device=dev)
    key_c = key_c.scatter_(0, dst, key_s)[:out_cap]
    val_c = val_c.scatter_(0, dst, run_pref)[:out_cap]
    seg_valid = torch.arange(out_cap, device=dev) < nnz_c
    rows_c = torch.div(key_c, n, rounding_mode="floor")
    cols_c = key_c - rows_c * n
    c_val = torch.where(seg_valid, val_c, torch.zeros((), dtype=v.dtype,
                                                      device=dev))
    c_col = torch.where(seg_valid, cols_c, n).to(torch.int32)
    rows_m = torch.where(seg_valid, rows_c, m).to(torch.int32)
    row_ptr = torch.searchsorted(
        rows_m, torch.arange(m + 1, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)
    return row_ptr, c_col, c_val, nnz_c


def _esc_core(a_row_ptr, a_col, a_val, a_nnz, b_row_ptr, b_col, b_val, *,
              e_cap: int, out_cap: int, m: int, k: int, n: int,
              val_dtype=None, sp=None):
    """ESC over A's CSR arrays (row pointer (m+1,), non-decreasing):
    expand (K14), then sort-compress. Returns (row_ptr, col_ind, values,
    nnz) of C = A @ B padded to out_cap. ``sp``: the leaves
    ``esc.expand``, then _sort_compress's."""
    if sp:
        sp.leaf("esc.expand")
    key, v = EK.esc_expand(a_row_ptr, a_col, a_val, a_nnz, b_row_ptr, b_col,
                           b_val, e_cap=e_cap, m=m, k=k, n=n,
                           val_dtype=val_dtype)
    return _sort_compress(key, v, out_cap=out_cap, m=m, n=n, sp=sp)


def _esc_core_rowexpand(a_row_ptr, a_col, a_val, a_nnz, b_col_ell,
                        b_val_ell, *, out_cap: int, m: int, n: int, run: int,
                        sp=None):
    """ESC with the B-row-gather expansion (float32; no K14): one row
    gather of B's padded ELL row per A entry into a (nnzA_cap, run) grid
    (empty slots masked), then the shared sort-compress (``sp`` as in
    _esc_core)."""
    if sp:
        sp.leaf("esc.expand")
    nnzA_cap = a_col.shape[0]
    k, kb = b_col_ell.shape
    dev = a_col.device
    ent_valid = torch.arange(nnzA_cap, device=dev) < a_nnz
    rows = a_col.clamp(0, k - 1).long()
    bc_p = F.pad(b_col_ell, (0, run - kb), value=-1)
    bv_p = F.pad(b_val_ell, (0, run - kb))
    if a_val.dtype == torch.float32:
        g = torch.cat([bc_p, bv_p.view(torch.int32)], dim=1)[rows]
        bc = g[:, :run]
        bv = g[:, run:].contiguous().view(torch.float32)
    else:
        bc, bv = bc_p[rows], bv_p[rows]
    valid = ent_valid[:, None] & (bc >= 0)
    a_row = entry_rows(a_row_ptr, nnzA_cap)
    val_dtype = torch.promote_types(a_val.dtype, b_val_ell.dtype)
    kd = EK.key_dtype(m, n)
    key = torch.where(valid, a_row[:, None].to(kd) * n + bc.to(kd), m * n)
    v = torch.where(valid, a_val[:, None].to(val_dtype) * bv.to(val_dtype),
                    torch.zeros((), dtype=val_dtype, device=dev))
    return _sort_compress(key.reshape(-1), v.reshape(-1), out_cap=out_cap,
                          m=m, n=n, sp=sp)


# ------------------------------------------------------------- slicing

def _slab_inputs(row_ptr, col_ind, values, *, r0: int, s0: int, s1: int,
                 rows_cap: int, nnza_cap: int):
    """One row slab of a CSR at fixed capacities (rebased row pointer,
    non-decreasing; tail rows and entries padded empty)."""
    m1 = row_ptr.shape[0] - 1
    rp = torch.cat([row_ptr, row_ptr[-1:].expand(rows_cap)])
    rp = rp[r0:r0 + rows_cap + 1]
    rp = (rp - s0).clamp(0, s1 - s0)
    col = F.pad(col_ind, (0, nnza_cap), value=m1)[s0:s0 + nnza_cap]
    val = F.pad(values, (0, nnza_cap))[s0:s0 + nnza_cap]
    return rp, col, val


def _slab_write(col_out, val_out, rp_out, piece_col, piece_val, piece_rp,
                off: int, r0: int):
    """One slab's compressed piece into the padded global output at
    host-known offsets, in place. Tail-row garbage in piece_rp is
    overwritten by the next slab; the buffers carry one slab of padding."""
    col_out[off:off + piece_col.shape[0]] = piece_col
    val_out[off:off + piece_val.shape[0]] = piece_val
    rp_out[r0:r0 + piece_rp.shape[0]] = piece_rp + off


def _spgemm_csr_sliced(A: CSR, B: CSR, plan: SpGEMMPlan, sp=None) -> CSR:
    """Workspace-sliced ESC: the core per row slab, concatenated on the
    device (the reference's sliced coo_spmm_helper loop,
    coo_dev/common_coo_dev.h:388-450); each slab's nnz is read back."""
    m, n = A.nrows, B.ncols
    dev = A.device
    row_ptr_h = A.row_ptr.cpu().numpy().astype(np.int64)
    total_cap = plan.total_out_capacity
    out_dtype = torch.promote_types(A.values.dtype, B.values.dtype)
    col_out = torch.full((total_cap + plan.out_capacity,), n,
                         dtype=torch.int32, device=dev)
    val_out = torch.zeros(total_cap + plan.out_capacity, dtype=out_dtype,
                          device=dev)
    rp_out = torch.zeros(m + 1 + plan.rows_capacity, dtype=torch.int32,
                         device=dev)
    off = 0
    slabs = plan.slabs
    for s in range(len(slabs) - 1):
        r0, r1 = slabs[s], slabs[s + 1]
        s0, s1 = int(row_ptr_h[r0]), int(row_ptr_h[r1])
        rp, col, val = _slab_inputs(
            A.row_ptr, A.col_ind, A.values, r0=r0, s0=s0, s1=s1,
            rows_cap=plan.rows_capacity, nnza_cap=plan.nnza_capacity)
        prow, pcol, pval, pnnz = _esc_core(
            rp, col, val, s1 - s0, B.row_ptr, B.col_ind, B.values,
            e_cap=plan.expansion_capacity, out_cap=plan.out_capacity,
            m=plan.rows_capacity, k=A.ncols, n=n, sp=sp)
        _slab_write(col_out, val_out, rp_out, pcol, pval, prow, off, r0)
        off += int(pnnz)
    rp_out[m] = off
    return CSR(row_ptr=rp_out[:m + 1], col_ind=col_out[:total_cap],
               values=val_out[:total_cap],
               nnz=torch.tensor(off, dtype=torch.int32, device=dev),
               shape=(m, n))


def spgemm_coo(A: COO, B: COO, plan: SpGEMMPlan | None = None) -> COO:
    """C = A @ B with both operands COO. The reference's COO_MUL_COO
    probes the output row linearly (coo/common_coo.h:72-161); here the
    same products go through the global engine with A's row pointer
    (the sliced engine for a sliced plan)."""
    from ia_spgemm_tpu_torch.formats.convert import coo_to_csr, csr_to_coo
    if plan is None:
        plan = plan_spgemm(coo_to_csr(A), coo_to_csr(B))
    if plan.slabs is not None:
        return csr_to_coo(_spgemm_csr_sliced(coo_to_csr(A), coo_to_csr(B),
                                             plan))
    row_ptr, col, val, nnz = _esc_core(
        A.row_offset, A.col_ind, A.values, A.nnz, B.row_offset, B.col_ind,
        B.values, e_cap=plan.expansion_capacity,
        out_cap=plan.out_capacity, m=A.nrows, k=A.ncols, n=B.ncols)
    return csr_to_coo(CSR(row_ptr=row_ptr, col_ind=col, values=val, nnz=nnz,
                          shape=(A.nrows, B.ncols)))


def spgemm_csr(A: CSR, B: CSR, plan: SpGEMMPlan | None = None,
               engine: str = "global") -> CSR:
    """C = A @ B with both operands CSR (the reference's CSR_MUL_CSR,
    csr/common_csr.h:85-193), exact CSR out.

    engine="global": the global-sort engine, sliced beyond the workspace.
    engine="slab": the slab engine (ops/slab.py) flattened by
    slab_to_csr, when its planner accepts the problem (else global)."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if engine == "slab":
        from ia_spgemm_tpu_torch.ops import slab as slab_mod
        call = slab_mod.plan_slab_csr(A, B)
        if call is not None:
            return slab_mod.slab_to_csr(call(), out_cap=call.plan.out_cap)
    if plan is None:
        plan = plan_spgemm(A, B)
    return spgemm_csr_global(A, B, plan)


def spgemm_csr_global(A: CSR, B: CSR, plan: SpGEMMPlan, sp=None) -> CSR:
    """The global engine under a plan. ``sp``, the caller's
    ``tracing.Tracer`` whose top is open (None: no spans), opens the
    leaves ``esc.expand``, ``esc.sort`` and ``esc.compress`` (once a row
    slab when sliced)."""
    if plan.slabs is not None:
        return _spgemm_csr_sliced(A, B, plan, sp)
    if plan.variant == "rowexpand":
        from ia_spgemm_tpu_torch.formats.convert import csr_to_ell
        B_ell = csr_to_ell(B, check_guard=False)
        row_ptr, col, val, nnz = _esc_core_rowexpand(
            A.row_ptr, A.col_ind, A.values, A.nnz, B_ell.col_ind,
            B_ell.values, out_cap=plan.out_capacity, m=A.nrows, n=B.ncols,
            run=plan.b_run, sp=sp)
    else:
        row_ptr, col, val, nnz = _esc_core(
            A.row_ptr, A.col_ind, A.values, A.nnz, B.row_ptr, B.col_ind,
            B.values, e_cap=plan.expansion_capacity,
            out_cap=plan.out_capacity, m=A.nrows, k=A.ncols, n=B.ncols,
            sp=sp)
    return CSR(row_ptr=row_ptr, col_ind=col, values=val, nnz=nnz,
               shape=(A.nrows, B.ncols))


# ------------------------------------------------------------- routing

# padded ELL slots allowed per operand for the tiled route
TILED_ELL_BUDGET_ELEMS = 1 << 28


def plan_csr_tiled(A: CSR, B: CSR, *, out_width: int | None = None):
    """Plan the tiled (width-class) route once: CSR -> ELL and the class
    plan. Returns a zero-argument call producing BlockCSR, or None when
    the route is not viable (non-float32, an operand over the ELL budget,
    a row over the class planner's caps)."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if A.values.dtype != torch.float32 or B.values.dtype != torch.float32:
        return None
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.ops import bitonic
    with tracing.span("plan.ell", device=A.device):
        ka = convert.plan_ell_width(A)
        kb = convert.plan_ell_width(B)
        if (A.nrows * max(ka, 1) > TILED_ELL_BUDGET_ELEMS
                or B.nrows * max(kb, 1) > TILED_ELL_BUDGET_ELEMS):
            return None
        A_ell = convert.csr_to_ell(A, width=ka, check_guard=False)
        B_ell = convert.csr_to_ell(B, width=kb, check_guard=False)
    return bitonic.multiclass_planned(A_ell, B_ell, assemble="bcsr",
                                      out_width=out_width)


def spgemm_csr_tiled(A: CSR, B: CSR, *, out_width: int | None = None):
    """C = A @ B through the width-class route (BlockCSR out); None when
    not viable."""
    call = plan_csr_tiled(A, B, out_width=out_width)
    return call() if call is not None else None


# The JAX package's per-engine device-time model, TPU v5e constants (ns
# per padded sort slot / per product), kept unchanged so the port routes
# as the JAX package does; a refit on this card is later work.
_NS_PER_SLOT_MC = 0.39
_NS_PER_SLOT_MC_WIDE = 1.0
_NS_PER_SLOT_SLAB = 0.48
_NS_PER_PRODUCT_GLOBAL = 26.0
_SLAB_PACK_OVERHEAD = 1.1


def predict_csr_route_ms(A: CSR, B: CSR) -> dict:
    """{route: predicted ms} over the routes whose cheap viability checks
    pass ('tiled', 'slab', 'hybrid'; 'global' always), from host-side
    statistics only."""
    from ia_spgemm_tpu_torch.ops import bitonic
    from ia_spgemm_tpu_torch.ops import slab as slab_mod

    nnzA = int(A.nnz)
    out = {}
    if nnzA == 0 or int(B.nnz) == 0:
        return {"global": 0.0}
    a_rp = A.row_ptr.cpu().numpy().astype(np.int64)
    a_col = A.col_ind.cpu().numpy()[:nnzA].astype(np.int64)
    b_len = np.diff(B.row_ptr.cpu().numpy()).astype(np.int64)
    e_len = b_len[np.clip(a_col, 0, B.nrows - 1)]
    E = int(e_len.sum())
    out["global"] = E * _NS_PER_PRODUCT_GLOBAL * 1e-6

    if A.values.dtype != torch.float32 or B.values.dtype != torch.float32:
        return out    # the sort engines are float32-only

    def padded_row_products(run):
        frag = -(-e_len // run)
        ecs = np.concatenate([[0], np.cumsum(frag)])
        return (ecs[a_rp[1:]] - ecs[a_rp[:-1]]) * run

    ka = int(np.max(np.diff(a_rp), initial=0))
    kb = int(b_len.max(initial=0))
    if (A.nrows * max(ka, 1) <= TILED_ELL_BUDGET_ELEMS
            and B.nrows * max(kb, 1) <= TILED_ELL_BUDGET_ELEMS):
        p16 = padded_row_products(16)
        W = np.maximum(128, 2 ** np.ceil(
            np.log2(np.maximum(p16, 128))).astype(np.int64))
        if (int(W.max(initial=128)) <= bitonic.MAX_WIDTH
                and int(W.sum()) * 8 <= bitonic.PRODUCT_BUDGET_BYTES):
            wide = W > 1024
            out["tiled"] = (float(W[~wide].sum()) * _NS_PER_SLOT_MC
                            + float(W[wide].sum())
                            * _NS_PER_SLOT_MC_WIDE) * 1e-6

    p32 = padded_row_products(slab_mod.DEFAULT_RUN)
    heavy = p32 > slab_mod.SLAB_MAX_WIDTH
    n_heavy = int(heavy.sum())
    v_light = float(p32[~heavy].sum()) * _SLAB_PACK_OVERHEAD
    t_light = v_light * _NS_PER_SLOT_SLAB * 1e-6
    if n_heavy == 0:
        out["slab"] = t_light
    elif n_heavy < A.nrows:
        e_heavy = float(e_len[np.repeat(heavy, np.diff(a_rp))].sum())
        out["hybrid"] = t_light + e_heavy * _NS_PER_PRODUCT_GLOBAL * 1e-6
    return out


def plan_csr_auto(A: CSR, B: CSR, plan: SpGEMMPlan | None = None,
                  bucket=True):
    """Plan the production CSR @ CSR route: the cheapest predicted engine
    whose full planner accepts the problem. Returns (route, zero-argument
    call); the call returns BlockCSR (tiled), SlabCSR (slab), HybridCSR
    (hybrid) or CSR (global), all with checksum/to_scipy/nnz.

    Spans (``tracing``, while it is active): ``plan`` around the whole,
    ``plan.route`` around the cost model, and the tiled planner's
    ``plan.ell``, ``plan.classes``, ``plan.table``, ``plan.fragments``,
    ``plan.assembly_map``."""
    from ia_spgemm_tpu_torch.ops import slab as slab_mod
    with tracing.span("plan", device=A.device):
        with tracing.span("plan.route", device=A.device):
            pred = predict_csr_route_ms(A, B)
        for route in sorted(pred, key=pred.get):
            if route == "tiled":
                call = plan_csr_tiled(A, B)
            elif route == "slab":
                call = slab_mod.plan_slab_csr(A, B)
            elif route == "hybrid":
                call = slab_mod.plan_slab_hybrid(A, B)
            else:
                esc_plan = plan if plan is not None \
                    else plan_spgemm(A, B, bucket=bucket)
                return "global", lambda: spgemm_csr(A, B, esc_plan)
            if call is not None:
                return route, call
    raise AssertionError("unreachable: 'global' is always a candidate")


def spgemm_csr_auto(A: CSR, B: CSR, plan: SpGEMMPlan | None = None):
    """Production CSR @ CSR entry (the reference's CSR_MUL_CSR role): the
    engine is picked by plan_csr_auto's cost model."""
    _route, call = plan_csr_auto(A, B, plan)
    return call()


# --------------------------------------------------------- compensated

def _split_dd(s: torch.Tensor):
    """float64 -> (hi, lo) float32 with hi = f32(s), lo = f32(s - hi)."""
    hi = s.float()
    return hi, (s - hi.double()).float()


def dd_sum(hi: torch.Tensor, lo: torch.Tensor):
    """Total of a (hi, lo) float32 pair array on its device, returned as
    a (hi, lo) float32 pair of 0-d tensors: a float64 sum of hi + lo
    (float64-grade, like the JAX package's double-double fold)."""
    return _split_dd((hi.double() + lo.double()).sum())


def _esc_core_dd(a_row_ptr, a_col, a_val, a_nnz, b_row_ptr, b_col, b_val, *,
                 e_cap: int, out_cap: int, m: int, k: int, n: int):
    """ESC with exact float64 products (two float32 factors fit a float64
    mantissa) and float64 run sums, split into a float32 (hi, lo) pair.
    Returns (row_ptr, col_ind, hi, lo, nnz)."""
    row_ptr, col, val, nnz = _esc_core(
        a_row_ptr, a_col, a_val, a_nnz, b_row_ptr, b_col, b_val,
        e_cap=e_cap, out_cap=out_cap, m=m, k=k, n=n, val_dtype=torch.float64)
    return (row_ptr, col) + _split_dd(val) + (nnz,)


_NO_SLICING = ("the expansion exceeds the single-slab workspace and the "
               "compensated path does not slice; raise workspace_elems in "
               "plan_spgemm or row-partition the problem")


def spgemm_csr_compensated(A: CSR, B: CSR,
                           plan: SpGEMMPlan | None = None,
                           engine: str = "auto"):
    """C = A @ B from float32 operands with float64-grade sums, as a
    float32 (values, values_lo) pair whose float64 sum is the value.

    engine="auto" runs the compensated slab pipeline (K9 + K10, SlabCSR
    out) when its planner accepts the problem, the global core (CSR out)
    otherwise; "global" forces the global core. The global core does not
    slice: a sliced plan raises. Needs (m+1)(n+1) < 2^31."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if (A.nrows + 1) * (B.ncols + 1) >= 2**31:
        raise ValueError("compensated path needs m*n < 2^31")
    if A.values.dtype != torch.float32:
        raise ValueError("compensated path takes float32 operands")
    if plan is not None and plan.slabs is not None:
        raise ValueError(_NO_SLICING)
    if engine == "auto":
        from ia_spgemm_tpu_torch.ops import slab as slab_mod
        call = slab_mod.plan_slab_csr(A, B, dd=True)
        if call is not None:
            return call()
    if plan is None:
        plan = plan_spgemm(A, B)
    if plan.slabs is not None:
        raise ValueError(_NO_SLICING)
    e_cap = (plan.expansion_capacity if plan.variant == "gather"
             else cfg.bucket_capacity(plan.flops))
    row_ptr, col, hi, lo, nnz = _esc_core_dd(
        A.row_ptr, A.col_ind, A.values, A.nnz, B.row_ptr, B.col_ind, B.values,
        e_cap=e_cap, out_cap=plan.out_capacity, m=A.nrows, k=A.ncols,
        n=B.ncols)
    return CSR(row_ptr=row_ptr, col_ind=col, values=hi, values_lo=lo,
               nnz=nnz, shape=(A.nrows, B.ncols))
