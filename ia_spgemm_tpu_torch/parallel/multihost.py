"""Multi-process execution of the distributed SpGEMM routes (PyTorch port
of ``ia_spgemm_tpu.parallel.multihost``), on ``torch.distributed``.

The reference is a single process (SURVEY.md §2.7). Here the routes of
``parallel/distributed.py`` (all-gathered B) and ``parallel/ring.py``
(the ring) run over a mesh that spans processes: each process holds its
own shards, B's blocks are all-gathered (``mesh.gather_shards``) or sent
round the ring point to point. The backend is NCCL when each process
owns its own card and gloo for CPU shards. NCCL refuses two processes on
one card, so on a one-card machine the processes share it over gloo,
whose collectives take host copies of the card's tensors; the caller
chooses that by the backend's name, and it is never taken after an NCCL
failure.

What a multi-process mesh changes:
- no process holds every shard, so reading a sharded result back is
  either per process (``local_csr_blocks`` / ``local_ell_rows``) or an
  explicit collective (``replicate_to_hosts``);
- ``initialize`` must run before the mesh is made.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterator, NamedTuple

import numpy as np
import torch

DEFAULT_TIMEOUT_S = 120.0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None,
               timeout_s: float | None = None) -> None:
    """Join this process to the group.

    Falls back to the IA_SPGEMM_COORDINATOR (host:port of process 0) /
    IA_SPGEMM_NUM_PROCS / IA_SPGEMM_PROC_ID / IA_SPGEMM_BACKEND
    variables. backend: "nccl" (one card per process, the default where
    there is a card) or "gloo" (CPU shards, or processes sharing a
    card). A peer that does not join within timeout_s (default
    DEFAULT_TIMEOUT_S) fails the call, and later collectives, rather
    than hanging. Idempotent once the group is up."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("IA_SPGEMM_COORDINATOR")
    if num_processes is None and "IA_SPGEMM_NUM_PROCS" in env:
        num_processes = int(env["IA_SPGEMM_NUM_PROCS"])
    if process_id is None and "IA_SPGEMM_PROC_ID" in env:
        process_id = int(env["IA_SPGEMM_PROC_ID"])
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("initialize needs the coordinator's host:port, the "
                         "process count and this process's id (arguments "
                         "or IA_SPGEMM_* variables)")
    backend = (backend or env.get("IA_SPGEMM_BACKEND")
               or ("nccl" if torch.cuda.is_available() else "gloo"))
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    addr = coordinator_address.removeprefix("tcp://")
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(
            seconds=timeout_s or DEFAULT_TIMEOUT_S))


class LocalCsrBlock(NamedTuple):
    shard: int            # global shard index d
    row_start: int        # global row of the block's first row
    nrows: int            # REAL rows in this block (padding excluded)
    row_ptr: np.ndarray   # (m_loc+1,) local offsets
    col_ind: np.ndarray   # (nnz,), trimmed to the block's real entries
    values: np.ndarray    # (nnz,)


def local_csr_blocks(C, row_starts: np.ndarray | None = None
                     ) -> Iterator[LocalCsrBlock]:
    """This process's row blocks of a ShardedCSR result, on the host.
    ``row_starts``: all D global block starts (default C.row_start,
    which every process holds)."""
    D, m = C.num_shards, C.shape[0]
    if row_starts is None:
        row_starts = all_row_starts(C)
    for d, rp, col, val, nnz in zip(C.shards, C.row_ptr, C.col_ind,
                                    C.values, C.nnz):
        r0 = int(row_starts[d])
        r1 = int(row_starts[d + 1]) if d + 1 < D else m
        nnz = int(nnz)
        yield LocalCsrBlock(shard=d, row_start=r0, nrows=r1 - r0,
                            row_ptr=rp.cpu().numpy(),
                            col_ind=col[:nnz].cpu().numpy(),
                            values=val[:nnz].cpu().numpy())


class LocalEllRows(NamedTuple):
    shard: int
    row_ids: np.ndarray   # (m_loc,) global row ids, -1 = padding
    col_ind: np.ndarray   # (m_loc, K), -1 = empty slot
    values: np.ndarray    # (m_loc, K)
    nnz_row: np.ndarray   # (m_loc,)


def local_ell_rows(C) -> Iterator[LocalEllRows]:
    """This process's rows of a ShardedELL result, on the host. Purely
    local: row_map already carries global row ids."""
    for d, col, val, nr, rm in zip(C.shards, C.col_ind, C.values,
                                   C.nnz_row, C.row_map):
        yield LocalEllRows(shard=d, row_ids=rm.cpu().numpy(),
                           col_ind=col.cpu().numpy(),
                           values=val.cpu().numpy(),
                           nnz_row=nr.cpu().numpy())


def all_row_starts(C) -> np.ndarray:
    """All D global block starts of a ShardedCSR. The JAX package
    all-gathers its sharded row_start; here every process partitioned
    the same matrix, so each holds them all and no collective runs."""
    return np.asarray(C.row_start)


def replicate_to_hosts(C):
    """The whole row-sharded result on EVERY process, fused into one
    global CSR on the device of this process's first shard
    (``distributed.gather_result``). COLLECTIVE across processes: all
    must call it together. For large results prefer consuming
    ``local_csr_blocks`` in place."""
    from ia_spgemm_tpu_torch.parallel import distributed
    from ia_spgemm_tpu_torch.parallel.mesh import Mesh, gather_shards

    if len(C.shards) == C.num_shards:
        return distributed.gather_result(C)
    import torch.distributed as dist
    dev = C.row_ptr[0].device
    mesh = Mesh(tuple(t.device for t in C.row_ptr), num_shards=C.num_shards,
                first_shard=C.shards[0], group=dist.group.WORLD)
    full = [list(gather_shards(mesh, x, dev).unbind(0))
            for x in (C.row_ptr, C.col_ind, C.values, C.nnz)]
    return distributed.gather_result(distributed.ShardedCSR(
        *full, row_start=C.row_start, shape=C.shape))


def _selftest(argv: list[str]) -> None:
    """Worker of the multi-process self-test: both distributed routes on
    a random matrix over every process's shards, each local block held
    to a locally computed scipy oracle.

        python -m ia_spgemm_tpu_torch.parallel.multihost PID NPROC PORT \
            [cpu|cuda [gloo|nccl]]

    with IA_SPGEMM_SHARDS_PER_DEVICE shards per process (the tests: 2
    processes x 2 CPU shards; chip_smoke.py: 2 x 2 shards of one card
    over gloo)."""
    pid, nproc, port = int(argv[0]), int(argv[1]), argv[2]
    device = argv[3] if len(argv) > 3 else "cpu"
    backend = argv[4] if len(argv) > 4 else "gloo"
    initialize(f"127.0.0.1:{port}", nproc, pid, backend=backend)

    import scipy.sparse as sp
    import torch.distributed as dist

    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.parallel import distributed, ring
    from ia_spgemm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device_type=device)
    D = mesh.num_shards
    a = sp.random(96, 96, density=0.08, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(7))
    c_ref = (a @ a).toarray()
    A = CSR.from_scipy(a, device=mesh.devices[0])

    # all-gather route, flops-balanced (uneven) partitions
    e_cap, out_cap = distributed.plan_dist_spgemm(A, A, D, balance="flops")
    As = distributed.partition_rows(A, D, balance="flops", B=A, mesh=mesh)
    Bs = distributed.partition_rows(A, D, mesh=mesh)
    C = distributed.dist_spgemm(As, Bs, mesh, e_cap=e_cap, out_cap=out_cap)
    err, nblocks = 0.0, 0
    for blk in local_csr_blocks(C):
        dense = np.zeros((blk.nrows, A.ncols), np.float64)
        for r in range(blk.nrows):
            for t in range(blk.row_ptr[r], blk.row_ptr[r + 1]):
                if blk.col_ind[t] < A.ncols:
                    dense[r, blk.col_ind[t]] += blk.values[t]
        err = max(err, float(np.abs(
            dense - c_ref[blk.row_start:blk.row_start + blk.nrows]).max()))
        nblocks += 1
    assert nblocks == len(mesh.devices) and err < 1e-4, (nblocks, err)
    print(f"[p{pid}] dist ok: {nblocks} of {D} blocks on "
          f"{mesh.devices[0]}, err {err:.2e}", flush=True)

    # replicate_to_hosts: the full result on every process
    Cg = replicate_to_hosts(C)
    err_g = float(np.abs(Cg.to_scipy().toarray() - c_ref).max())
    assert err_g < 1e-4, err_g

    # the ring, with contiguous and with flops-balanced (permuted) B
    A_ell = convert.csr_to_ell(A, check_guard=False)
    plan = ring.plan_ring(A_ell, A_ell, D)
    As_e = ring.partition_rows_ell(A_ell, D, mesh=mesh)
    err2 = 0.0
    for balance in ("rows", "flops"):
        Bs_e = ring.partition_rows_ell(A_ell, D, mesh=mesh, balance=balance)
        Ce = ring.ring_spgemm(As_e, Bs_e, mesh, plan)
        for rows in local_ell_rows(Ce):
            for r in range(rows.col_ind.shape[0]):
                g = int(rows.row_ids[r])
                if g < 0:
                    continue
                dense = np.zeros(A.ncols, np.float64)
                for t in range(int(rows.nnz_row[r])):
                    c = int(rows.col_ind[r, t])
                    if 0 <= c < A.ncols:
                        dense[c] += rows.values[r, t]
                err2 = max(err2, float(np.abs(dense - c_ref[g]).max()))
    assert err2 < 1e-4, err2
    print(f"[p{pid}] ring ok: err {err2:.2e}", flush=True)
    dist.destroy_process_group()
    print(f"[p{pid}] MULTIPROC_OK", flush=True)


if __name__ == "__main__":
    import sys

    _selftest(sys.argv[1:])
