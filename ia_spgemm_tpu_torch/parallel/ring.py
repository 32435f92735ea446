"""Ring distributed SpGEMM (PyTorch port of
``ia_spgemm_tpu.parallel.ring``).

The simple paths (``parallel/distributed.py``) replicate or all-gather
B, which puts all of B on every device. This one streams B around a
ring instead:

  - A and C are row-sharded ELL blocks, one per shard.
  - B is row-sharded into D blocks; at step s shard d holds the block
    owned by (d + s) % D.
  - Each step, every shard gathers the product runs of its A entries
    whose column falls in the block it holds, from the block's doubled
    (forward + reversed) run table (``bitonic.doubled_table_gather``),
    then every block moves one shard to the left: through K13
    (``parallel/rdma_ring.py``) when the mesh's cards can reach each
    other (``use_rdma``), in one process or across processes (its
    instance with the barrier, into receivers shared by CUDA IPC); else
    through the plain hop (a copy, the counterpart of ``lax.ppermute``),
    or ``torch.distributed`` point-to-point when the mesh spans
    processes.
  - After D steps every product run is filled; one row-local sort +
    compress (K4, ``ops/bitonic_kernels.sort_compress_rows``) finishes
    each row block.

Capacity is static: each A row has ka * chunks runs of ``run`` slots
whichever step fills them, so the product buffer is allocated once and
steps only select into it. The JAX loop hops D times and never uses the
last hop's blocks; this loop skips that hop, so a ring call makes D - 1
hops (none at D = 1), each carrying the column and value blocks
together: one K13 launch per source card in one process, one per
process (on its home card, whatever cards its shards lie on) across
processes. The hops write into two sets of
receivers alternated: allocated once per call in one process, made once
per layout and shared with the neighbours across processes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ia_spgemm_tpu_torch.formats.types import ELL
from ia_spgemm_tpu_torch.ops import bitonic
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
from ia_spgemm_tpu_torch.parallel.distributed import _placement
from ia_spgemm_tpu_torch.parallel.mesh import Mesh, gather_shards
from ia_spgemm_tpu_torch.parallel.rdma_ring import (
    alloc_receivers, check_hops, rdma_available, ring_hop_plain,
    ring_hop_processes_plain, ring_hop_rdma, ring_hop_xproc,
    shared_receivers)


@dataclasses.dataclass
class ShardedELL:
    """Row-block-sharded ELL: one tensor per shard held here.

    row_map holds the GLOBAL row id of each (shard, local) slot (-1 =
    padding) so balanced partitionings can permute rows; contiguous
    blocks use the identity map."""

    col_ind: List[torch.Tensor]   # (m_loc, K) int32, -1 empty
    values: List[torch.Tensor]    # (m_loc, K)
    nnz_row: List[torch.Tensor]   # (m_loc,) int32
    row_map: List[torch.Tensor]   # (m_loc,) int32 global rows, -1 padding
    shape: Tuple[int, int]
    contiguous: bool = True
    num_shards: int = 0           # over all processes (default: held here)
    shards: Tuple[int, ...] = ()  # global indices held here (default all)

    def __post_init__(self):
        if not self.num_shards:
            self.num_shards = len(self.col_ind)
        if not self.shards:
            self.shards = tuple(range(len(self.col_ind)))

    @property
    def rows_per_shard(self) -> int:
        return self.col_ind[0].shape[0]

    @property
    def width(self) -> int:
        return self.col_ind[0].shape[1]


def partition_rows_ell(A: ELL, num_shards: int, mesh: Mesh | None = None,
                       balance: str = "rows",
                       B: ELL | None = None) -> ShardedELL:
    """Row blocks of ceil(m / D) rows.

    balance="rows": contiguous blocks (identity row_map, tail padded).
    balance="flops": rows dealt greedily by descending per-row product
    count onto the least-loaded shard (the flops balance the reference's
    CV feature motivates, csr/common_csr.h:276), recorded in row_map.
    Without a mesh every shard lies on A's device; with one, this
    process keeps its own shards, each on its device."""
    m, Kw = A.col_ind.shape
    m_loc = -(-m // num_shards)
    pad = num_shards * m_loc - m
    a_col = A.col_ind.cpu().numpy()
    a_val = A.values.cpu().numpy()
    a_nnz = A.nnz_row.cpu().numpy()
    if balance == "rows":
        col = np.pad(a_col, ((0, pad), (0, 0)), constant_values=-1)
        val = np.pad(a_val, ((0, pad), (0, 0)))
        nnz_row = np.pad(a_nnz, (0, pad))
        row_map = np.concatenate([np.arange(m, dtype=np.int64),
                                  np.full(pad, -1, np.int64)])
    elif balance == "flops":
        lens_b = (B or A).nnz_row.cpu().numpy().astype(np.int64)
        rf = np.where(a_col >= 0,
                      lens_b[np.clip(a_col, 0, lens_b.shape[0] - 1)],
                      0).sum(axis=1)
        by_cost = np.argsort(-rf, kind="stable")
        # greedy deal: heaviest row onto the least-loaded shard
        assign = np.full((num_shards, m_loc), -1, np.int64)
        slot = np.zeros(num_shards, np.int64)
        load = np.zeros(num_shards, np.float64)
        for r in by_cost:
            d = int(np.argmin(load))
            assign[d, slot[d]] = r
            slot[d] += 1
            load[d] += float(rf[r])
            if slot[d] == m_loc:
                load[d] = np.inf  # shard full
        row_map = assign.reshape(-1)
        sel = np.clip(row_map, 0, m - 1)
        valid = (row_map >= 0)[:, None]
        col = np.where(valid, a_col[sel], -1)
        val = np.where(valid, a_val[sel], 0).astype(a_val.dtype)
        nnz_row = np.where(row_map >= 0, a_nnz[sel], 0)
    else:
        raise ValueError(balance)
    col = col.reshape(num_shards, m_loc, Kw).astype(np.int32)
    val = val.reshape(num_shards, m_loc, Kw)
    nnz_row = nnz_row.reshape(num_shards, m_loc).astype(np.int32)
    row_map = row_map.reshape(num_shards, m_loc).astype(np.int32)
    shards, devs = _placement(num_shards, mesh, A.device)
    put = lambda x, dev: torch.from_numpy(np.array(x)).to(dev)  # noqa: E731
    return ShardedELL(
        col_ind=[put(col[d], dv) for d, dv in zip(shards, devs)],
        values=[put(val[d], dv) for d, dv in zip(shards, devs)],
        nnz_row=[put(nnz_row[d], dv) for d, dv in zip(shards, devs)],
        row_map=[put(row_map[d], dv) for d, dv in zip(shards, devs)],
        shape=A.shape, contiguous=(balance == "rows"),
        num_shards=num_shards, shards=tuple(shards))


def plan_ring(A: ELL, B: ELL, num_shards: int,
              allow_split: bool = True) -> bitonic.BitonicPlan:
    m_loc = -(-A.nrows // num_shards)
    return bitonic.plan_bitonic_dims(m_loc, A.max_nnz_per_row,
                                     B.max_nnz_per_row,
                                     allow_split=allow_split)


def ring_spgemm(A: ShardedELL, B: ShardedELL, mesh: Mesh | None,
                plan: bitonic.BitonicPlan, use_rdma="auto") -> ShardedELL:
    """C = A @ B, A and C row-sharded, B streamed around the ring.

    B may be partitioned with any balance: the inverse row map (global B
    row -> owning shard, local slot) is built once from every shard's
    row_map (an all_gather across processes), so membership tests
    against the circulating block are O(1) per entry. Sub-run splitting
    (plan.chunks > 1) applies to the circulating block's table exactly
    as the single-device expand applies it.

    use_rdma: True hops through K13 and raises where it cannot run,
    False through the plain hop, "auto" through K13 wherever
    ``rdma_available(mesh)`` (in one process or across processes, as the
    JAX gate). A hop across processes that timed out raises at the
    call's end."""
    keys, vals = ring_products(A, B, mesh, plan, use_rdma)
    cols, outs, nnzs = [], [], []
    for key, val in zip(keys, vals):
        col, out_val, nnz_row = K.sort_compress_rows(
            key, val, width=plan.width, start_kk=2 * plan.run)
        cols.append(col)
        outs.append(out_val)
        nnzs.append(nnz_row[:, 0])
    return ShardedELL(col_ind=cols, values=outs, nnz_row=nnzs,
                      row_map=A.row_map, shape=(A.shape[0], B.shape[1]),
                      contiguous=A.contiguous, num_shards=A.num_shards,
                      shards=A.shards)


def ring_products(A: ShardedELL, B: ShardedELL, mesh: Mesh | None,
                  plan: bitonic.BitonicPlan, use_rdma="auto"):
    """The ring's D steps: every shard's products, (m_loc, plan.width)
    keys (SENTINEL in empty slots) and values, in the alternating-run
    layout that K4 sorts from start_kk = 2 * run."""
    if not plan.viable:
        raise ValueError(
            f"ring plan not viable (width {plan.width}); split sub-runs "
            "further or fall back to the distributed ESC path")
    if mesh is None:
        mesh = Mesh(tuple(t.device for t in A.col_ind))
    if use_rdma == "auto":
        use_rdma = rdma_available(mesh)
    elif use_rdma and not rdma_available(mesh):
        raise ValueError("use_rdma=True: K13 needs a mesh of two or more "
                         "shards on cards that reach each other (across "
                         "processes: each process's home card must reach "
                         "its other cards, its left neighbour's last card "
                         "and both neighbours' home cards; rdma_ring."
                         "card_gate)")
    D = A.num_shards
    m_loc, ka = A.rows_per_shard, A.width
    k_loc, kb = B.rows_per_shard, B.width
    run, width, chunks = plan.run, plan.width, plan.chunks
    ke = ka * chunks          # expanded entry count per row
    kc = k_loc * chunks       # circulating table rows (fwd half)
    devs = [t.device for t in A.col_ind]

    tabs = None
    if not B.contiguous:
        # inverse of B's row permutation, from every shard's row map
        k_total = D * k_loc
        ids = gather_shards(mesh, B.row_map, devs[0]).reshape(-1).long()
        slot = torch.arange(k_total, dtype=torch.int32, device=devs[0])
        safe = torch.where(ids >= 0, ids.clamp(max=k_total - 1), k_total)
        owner_tab = torch.full((k_total + 1,), -1, dtype=torch.int32,
                               device=devs[0])
        local_tab = torch.zeros(k_total + 1, dtype=torch.int32,
                                device=devs[0])
        owner_tab[safe] = slot // k_loc
        local_tab[safe] = slot % k_loc
        owner_tab[k_total] = -1
        tabs = (owner_tab, local_tab)

    owner_of, local_of, a_val_e, keys, vals = [], [], [], [], []
    for i, dev in enumerate(devs):
        a_col, a_val = A.col_ind[i], A.values[i]
        if tabs is None:
            own = torch.where(a_col >= 0,
                              torch.div(a_col, k_loc, rounding_mode="floor"),
                              -1)
            loc = (a_col - own.clamp(min=0) * k_loc).clamp(0, k_loc - 1)
        else:
            ot, lt = (t.to(dev) for t in tabs)
            k_total = D * k_loc
            a_safe = torch.where(a_col >= 0, a_col.clamp(0, k_total - 1),
                                 k_total).long()
            own, loc = ot[a_safe], lt[a_safe]
        if chunks > 1:
            sub = torch.arange(chunks, dtype=torch.int32, device=dev)
            own = own[:, :, None].expand(m_loc, ka, chunks).reshape(
                m_loc, ke)
            loc = (loc[:, :, None] * chunks + sub).reshape(m_loc, ke)
            a_val = a_val[:, :, None].expand(m_loc, ka, chunks).reshape(
                m_loc, ke)
        parity = torch.arange(ke, device=dev) & 1
        owner_of.append(own)
        local_of.append((loc + kc * parity).reshape(-1).long())
        a_val_e.append(a_val[:, :, None])
        keys.append(torch.full((m_loc, ke, run), K.SENTINEL,
                               dtype=torch.int32, device=dev))
        vals.append(torch.zeros((m_loc, ke, run), dtype=a_val.dtype,
                                device=dev))

    bc, bv = list(B.col_ind), list(B.values)
    # two sets of receivers, alternated: step s's hop writes the set that
    # step s - 1 read (rdma_ring.ring_hop_rdma; across processes K13's
    # barrier waits for the neighbour whose set it writes)
    if not mesh.spans_processes:
        hop = ring_hop_rdma if use_rdma else ring_hop_plain
        recv = [alloc_receivers(bc, bv) for _ in range(2)] if D > 1 else None
    elif use_rdma:
        hop = functools.partial(ring_hop_xproc, mesh)
        recv = shared_receivers(mesh, bc, bv)
    else:
        hop = functools.partial(ring_hop_processes_plain, mesh)
        recv = None
    pad_b = chunks * run - kb
    for s in range(D):
        for i, d in enumerate(A.shards):
            in_blk = (owner_of[i] == (d + s) % D)[:, :, None]
            bc_p = F.pad(bc[i], (0, pad_b), value=-1).reshape(kc, run)
            bv_p = F.pad(bv[i], (0, pad_b)).reshape(kc, run)
            gc, gv = bitonic.doubled_table_gather(
                bc_p, bv_p, local_of[i], run=run, out_shape=(m_loc, ke, run))
            sel = in_blk & (gc >= 0)
            keys[i] = torch.where(in_blk, torch.where(sel, gc, K.SENTINEL),
                                  keys[i])
            vals[i] = torch.where(sel, (a_val_e[i] * gv).to(vals[i].dtype),
                                  vals[i])
        if s == D - 1:
            break      # the last hop's blocks would go unused
        bc, bv = hop(bc, bv) if recv is None else hop(bc, bv,
                                                      out=recv[s % 2])
    if mesh.spans_processes and use_rdma:
        check_hops(recv[0])

    pad = width - ke * run
    return ([F.pad(k.reshape(m_loc, ke * run), (0, pad),
                   value=K.SENTINEL).contiguous() for k in keys],
            [F.pad(v.reshape(m_loc, ke * run), (0, pad)).contiguous()
             for v in vals])


def gather_result_ell(C: ShardedELL) -> ELL:
    """Host-side: fuse the row-sharded result (every shard held here)
    into one global ELL on the device of C's first shard, inverting the
    partition's row permutation."""
    if len(C.shards) != C.num_shards:
        raise ValueError(f"{len(C.shards)} of {C.num_shards} shards held "
                         "here: read them with multihost.local_ell_rows")
    m, n = C.shape
    w = C.width
    stack = lambda x: np.stack([t.cpu().numpy() for t in x])  # noqa: E731
    col = stack(C.col_ind).reshape(-1, w)
    val = stack(C.values).reshape(-1, w)
    nnz_row = stack(C.nnz_row).reshape(-1)
    rmap = stack(C.row_map).reshape(-1)
    sel = rmap >= 0
    out_col = np.full((m, w), -1, np.int32)
    out_val = np.zeros((m, w), val.dtype)
    out_nnz = np.zeros(m, np.int32)
    out_col[rmap[sel]] = col[sel]
    out_val[rmap[sel]] = val[sel]
    out_nnz[rmap[sel]] = nnz_row[sel]
    return ELL.from_numpy(out_col, out_val, out_nnz, out_nnz.sum(), (m, n),
                          device=C.col_ind[0].device)
