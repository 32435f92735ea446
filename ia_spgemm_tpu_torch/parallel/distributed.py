"""Row-partitioned distributed SpGEMM over a shard mesh (PyTorch port of
``ia_spgemm_tpu.parallel.distributed``).

A and C are split into row blocks, one per shard; B is either replicated
(small B, no communication) or row-sharded and all-gathered, then every
shard runs the ESC engine (``ops/esc._esc_core``, plain torch as it is
XLA in the JAX package) on its row block. C comes back row-sharded.

Layout: a ShardedCSR holds one tensor per shard of this process, each on
its shard's device (the counterpart of JAX's ``addressable_shards``):
row_ptr (m_loc+1,) LOCAL offsets, col_ind / values (cap_loc,), nnz 0-d.
``row_start`` (the global first row of every block) is host metadata
known to every process, since every process partitions the same A.
``stacked`` gives the (D, ...) numpy view that JAX's fields have. Row
blocks are balanced by row count or by flops (prefix sums of per-row
intermediate-product counts, the skew the reference's CV feature
measures, csr/common_csr.h:276).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ia_spgemm_tpu_torch import config as cfg
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.ops import esc
from ia_spgemm_tpu_torch.parallel.mesh import Mesh, gather_shards
from ia_spgemm_tpu_torch.utils.scans import entry_rows


@dataclasses.dataclass
class ShardedCSR:
    """Row-block-sharded CSR: one tensor per shard held here."""

    row_ptr: List[torch.Tensor]   # (m_loc+1,) int32, local offsets
    col_ind: List[torch.Tensor]   # (cap_loc,) int32
    values: List[torch.Tensor]    # (cap_loc,)
    nnz: List[torch.Tensor]       # 0-d int32
    row_start: np.ndarray         # (D,) int32, every block's first row
    shape: Tuple[int, int]
    shards: Tuple[int, ...] = ()  # global indices held here (default all)

    def __post_init__(self):
        if not self.shards:
            self.shards = tuple(range(len(self.row_ptr)))

    @property
    def num_shards(self) -> int:
        return len(self.row_start)

    @property
    def rows_per_shard(self) -> int:
        return self.row_ptr[0].shape[0] - 1


def stacked(x) -> np.ndarray:
    """The (D, ...) numpy array of a per-shard field, as the JAX
    package's stacked fields (every shard must be held here)."""
    if isinstance(x, np.ndarray):
        return x
    return np.stack([t.cpu().numpy() for t in x])


def _placement(num_shards: int, mesh: Mesh | None, device):
    """(global shard ids held here, their devices): every shard on
    `device` without a mesh, this process's shards of the mesh with
    one."""
    if mesh is None:
        return list(range(num_shards)), [device] * num_shards
    if mesh.num_shards != num_shards:
        raise ValueError(f"{num_shards} shards on a mesh of "
                         f"{mesh.num_shards}")
    return list(mesh.local_shards), list(mesh.devices)


def _entry_flops_csum(A: CSR, B: CSR) -> np.ndarray:
    """Host prefix sum of per-entry intermediate products: csum[e] = sum
    of len(B row a_col[j]) for j < e. Row r's flops = csum[rp[r+1]] -
    csum[rp[r]], shared by the balancer and the capacity planner."""
    nnzA = int(A.nnz)
    col = A.col_ind[:nnzA].cpu().numpy()
    b_len = np.diff(B.row_ptr.cpu().numpy()).astype(np.int64)
    per_entry = b_len[np.clip(col, 0, B.nrows - 1)]
    return np.concatenate([[0], np.cumsum(per_entry)])


def _row_boundaries(A: CSR, num_shards: int, balance: str,
                    B: CSR | None) -> np.ndarray:
    m = A.nrows
    if balance == "rows" or m < num_shards:
        bounds = np.linspace(0, m, num_shards + 1).astype(np.int64)
    elif balance == "flops":
        # balanced intermediate products per shard
        rp = A.row_ptr.cpu().numpy().astype(np.int64)
        ecsum = _entry_flops_csum(A, B if B is not None else A)
        csum = ecsum[rp]  # per-row flops prefix at row boundaries
        targets = np.linspace(0, csum[-1], num_shards + 1)
        bounds = np.searchsorted(csum, targets)
        bounds[0], bounds[-1] = 0, m
        bounds = np.maximum.accumulate(bounds)
    else:
        raise ValueError(balance)
    return bounds.astype(np.int64)


def partition_rows(A: CSR, num_shards: int, *, balance: str = "rows",
                   B: CSR | None = None,
                   mesh: Mesh | None = None) -> ShardedCSR:
    """Host-side row partitioner: equal-size padded blocks.

    All shards share one (rows_per_shard, cap_loc); shorter blocks pad
    rows with empty row_ptr tails and entries with the column sentinel.
    Without a mesh every shard lies on A's device; with one, this
    process keeps its own shards, each on its device."""
    m, n = A.shape
    bounds = _row_boundaries(A, num_shards, balance, B)
    rp = A.row_ptr.cpu().numpy().astype(np.int64)
    ci = A.col_ind.cpu().numpy()
    vv = A.values.cpu().numpy()

    m_loc = max(int(np.max(bounds[1:] - bounds[:-1])), 1)
    caps = [int(rp[bounds[d + 1]] - rp[bounds[d]])
            for d in range(num_shards)]
    cap_loc = cfg.bucket_capacity(max(max(caps), 1))

    row_ptr = np.zeros((num_shards, m_loc + 1), np.int32)
    col = np.full((num_shards, cap_loc), n, np.int32)
    val = np.zeros((num_shards, cap_loc), vv.dtype)
    nnz = np.zeros(num_shards, np.int32)
    for d in range(num_shards):
        r0, r1 = int(bounds[d]), int(bounds[d + 1])
        e0, e1 = int(rp[r0]), int(rp[r1])
        local_rp = (rp[r0:r1 + 1] - rp[r0]).astype(np.int32)
        row_ptr[d, :r1 - r0 + 1] = local_rp
        row_ptr[d, r1 - r0 + 1:] = local_rp[-1]
        col[d, :e1 - e0] = ci[e0:e1]
        val[d, :e1 - e0] = vv[e0:e1]
        nnz[d] = e1 - e0

    shards, devs = _placement(num_shards, mesh, A.device)
    put = lambda x, dev: torch.from_numpy(np.array(x)).to(dev)  # noqa: E731
    return ShardedCSR(
        row_ptr=[put(row_ptr[d], dv) for d, dv in zip(shards, devs)],
        col_ind=[put(col[d], dv) for d, dv in zip(shards, devs)],
        values=[put(val[d], dv) for d, dv in zip(shards, devs)],
        nnz=[put(nnz[d], dv) for d, dv in zip(shards, devs)],
        row_start=bounds[:-1].astype(np.int32), shape=(m, n),
        shards=tuple(shards))


def _assemble_global_csr(rp_blocks, col_blocks, val_blocks, nnz_blocks,
                         *, n_cols: int, row_start=None,
                         n_rows: int | None = None):
    """Fuse stacked per-shard CSR blocks (padded) into one global CSR.

    rp_blocks: (D, m_loc+1) local offsets; returns global (row_ptr, col,
    val, nnz) with capacity D*cap_loc (entries compacted to the front).

    row_start/n_rows: the blocks' global first-row ids and the true global
    row count, REQUIRED when row counts don't divide evenly (blocks pad
    tail rows, which the scatter below sends to a slot it then cuts off,
    as JAX's mode="drop" scatter does). When omitted, every block is
    assumed to hold exactly m_loc real rows."""
    D, cap_loc = col_blocks.shape
    m_loc = rp_blocks.shape[1] - 1
    dev = col_blocks.device
    i32 = torch.int32
    shard_off = F.pad(torch.cumsum(nnz_blocks.to(i32), 0, dtype=i32), (1, 0))
    local = rp_blocks[:, :-1] + shard_off[:-1, None]
    if row_start is None:
        # even split: block-local offsets + per-shard entry offset
        row_ptr = torch.cat([local.reshape(-1), shard_off[-1:]])
    else:
        # uneven split: each block's REAL rows to their global positions;
        # padded tail rows land in slot n_rows + 1, cut off below
        rs = row_start.to(device=dev, dtype=torch.int64)
        rows_d = torch.cat([rs[1:], rs.new_full((1,), n_rows)]) - rs
        li = torch.arange(m_loc, device=dev)[None, :]
        dst_r = torch.where(li < rows_d[:, None], rs[:, None] + li,
                            n_rows + 1)
        rp_g = torch.zeros(n_rows + 2, dtype=i32, device=dev)
        rp_g[dst_r.reshape(-1)] = local.reshape(-1)
        row_ptr = rp_g[:n_rows + 1]
        row_ptr[n_rows] = shard_off[-1]
    # compact entries: local entry t of shard d -> shard_off[d] + t
    t = torch.arange(cap_loc, device=dev)[None, :]
    valid = t < nnz_blocks[:, None]
    dst = torch.where(valid, shard_off[:-1, None] + t, D * cap_loc)
    col = torch.full((D * cap_loc + 1,), n_cols, dtype=i32, device=dev)
    val = torch.zeros(D * cap_loc + 1, dtype=val_blocks.dtype, device=dev)
    col[dst.reshape(-1)] = torch.where(valid, col_blocks, n_cols).reshape(-1)
    val[dst.reshape(-1)] = torch.where(
        valid, val_blocks, torch.zeros((), dtype=val_blocks.dtype,
                                       device=dev)).reshape(-1)
    return row_ptr, col[:-1], val[:-1], shard_off[-1]


def _gathered_b(B: ShardedCSR, mesh: Mesh | None, device, k: int, n: int):
    """All of B on `device`: its row blocks gathered from every shard (an
    all_gather across processes), reassembled by each block's
    row_start, which handles uneven and flops-balanced splits alike."""
    if mesh is None:
        mesh = Mesh(tuple(t.device for t in B.row_ptr))
    g = [gather_shards(mesh, x, device)
         for x in (B.row_ptr, B.col_ind, B.values, B.nnz)]
    rs = torch.from_numpy(np.asarray(B.row_start)).to(device)
    b_rp, b_col, b_val, _ = _assemble_global_csr(*g, n_cols=n,
                                                 row_start=rs, n_rows=k)
    return b_rp, b_col, b_val


def dist_spgemm(A: ShardedCSR, B, mesh: Mesh | None,
                *, e_cap: int, out_cap: int,
                b_sharded: bool | None = None) -> ShardedCSR:
    """C = A @ B with A, C row-sharded over `mesh`.

    B may be a replicated CSR (no communication, pure data parallelism:
    one copy per device of the mesh) or a ShardedCSR (its blocks gathered
    once, across processes by one all_gather, then reassembled on every
    device before the local ESC engine).

    e_cap/out_cap are per-shard capacities (use plan_dist_spgemm)."""
    m, k = A.shape
    if b_sharded is None:
        b_sharded = isinstance(B, ShardedCSR)
    n = B.shape[1]
    m_loc = A.rows_per_shard
    devs = [t.device for t in A.row_ptr]
    if b_sharded:
        b_first = _gathered_b(B, mesh, devs[0], k, n)
    else:
        b_first = (B.row_ptr, B.col_ind, B.values)
    b_on = {}
    out = ([], [], [], [])
    for i, dev in enumerate(devs):
        if dev not in b_on:
            b_on[dev] = tuple(x.to(dev) for x in b_first)
        a_rp, a_col = A.row_ptr[i], A.col_ind[i]
        res = esc._esc_core(entry_rows(a_rp, a_col.shape[0]), a_col,
                            A.values[i], A.nnz[i], *b_on[dev],
                            e_cap=int(e_cap), out_cap=int(out_cap),
                            m=m_loc, k=k, n=n)
        for lst, x in zip(out, res):
            lst.append(x)
    return ShardedCSR(row_ptr=out[0], col_ind=out[1], values=out[2],
                      nnz=out[3], row_start=A.row_start, shape=(m, n),
                      shards=A.shards)


def plan_dist_spgemm(A: CSR, B: CSR, num_shards: int,
                     *, balance: str = "rows") -> Tuple[int, int]:
    """Per-shard (e_cap, out_cap): max expansion / output bound over row
    blocks. Guards the same int32 position arithmetic the single-device
    planner does (esc.py): this is the planner plan_spgemm's overflow
    errors redirect users to, so it must not itself wrap."""
    bounds = _row_boundaries(A, num_shards, balance, B)
    rp = A.row_ptr.cpu().numpy().astype(np.int64)
    csum = _entry_flops_csum(A, B)
    # per-row flops -> per-row output bound min(flops, n)
    per_row = csum[rp[1:]] - csum[rp[:-1]]
    ocsum = np.concatenate(
        [[0], np.cumsum(np.minimum(per_row, B.ncols), dtype=np.int64)])
    e_max, o_max = 1, 1
    for d in range(num_shards):
        e0, e1 = int(rp[bounds[d]]), int(rp[bounds[d + 1]])
        e_max = max(e_max, int(csum[e1] - csum[e0]))
        o_max = max(o_max, int(ocsum[bounds[d + 1]] - ocsum[bounds[d]]))
    i32max = np.iinfo(np.int32).max
    if cfg.bucket_capacity(e_max) > i32max - 1:
        raise ValueError(
            f"a shard's expansion ({e_max}) overflows int32 positions; "
            "use more shards or balance='flops'")
    return cfg.bucket_capacity(e_max), cfg.bucket_capacity(o_max)


def gather_result(C: ShardedCSR) -> CSR:
    """Host-side: fuse a row-sharded result (every shard held here) back
    into one global CSR, on the device of C's first shard."""
    D = C.num_shards
    if len(C.shards) != D:
        raise ValueError(f"{len(C.shards)} of {D} shards held here: use "
                         "multihost.replicate_to_hosts across processes")
    m, n = C.shape
    rp, col, val, nnz = (stacked(x) for x in (C.row_ptr, C.col_ind,
                                              C.values, C.nnz))
    row_start = np.asarray(C.row_start)
    g_rp = np.zeros(m + 1, np.int32)
    cols_out, vals_out = [], []
    total = 0
    for d in range(D):
        r0 = int(row_start[d])
        r1 = int(row_start[d + 1]) if d + 1 < D else m
        g_rp[r0:r1 + 1] = rp[d, :r1 - r0 + 1] + total
        cols_out.append(col[d, :nnz[d]])
        vals_out.append(val[d, :nnz[d]])
        total += int(nnz[d])
    return CSR.from_numpy(g_rp, np.concatenate(cols_out),
                          np.concatenate(vals_out), total, (m, n),
                          device=C.row_ptr[0].device)
