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


def _args(argv: list[str]):
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m ia_spgemm_tpu_torch.parallel.multihost",
        description="one worker of the multi-process self-test")
    p.add_argument("pid", type=int)
    p.add_argument("nproc", type=int)
    p.add_argument("port")
    p.add_argument("device", nargs="?", default="cuda",
                   choices=("cuda", "cpu"))
    p.add_argument("backend", nargs="?", default="gloo",
                   choices=("gloo", "nccl"))
    p.add_argument("--matrix", default="small", choices=("small", "headline"))
    p.add_argument("--rdma", default="auto", choices=("auto", "on", "off"))
    p.add_argument("--devices", default=None,
                   help="this process's shard devices, comma-separated "
                        "(e.g. cuda:2,cuda:3); default: every visible "
                        "device, IA_SPGEMM_SHARDS_PER_DEVICE times each")
    return p.parse_args(argv)


def _selftest(argv: list[str]) -> None:
    """Worker of the multi-process self-test: both distributed routes on
    a random 96 x 96 matrix over every process's shards, each local block
    held to a locally computed scipy oracle; with ``--matrix headline``
    then the ring on the headline matrix at full width
    (``_headline_ring``).

        python -m ia_spgemm_tpu_torch.parallel.multihost PID NPROC PORT \
            [cuda|cpu] [gloo|nccl] [--matrix small|headline] \
            [--rdma auto|on|off] [--devices cuda:I,cuda:J,...]

    The device is the card unless cpu is named (without a card it
    raises), the backend gloo unless nccl is named; --rdma is every ring
    call's use_rdma (auto: K13 wherever ``rdma_available``). The shards
    are every visible device IA_SPGEMM_SHARDS_PER_DEVICE times (the
    tests: 2 processes x 2 CPU shards; chip_smoke.py: 2 x 2 and 4 x 1
    shards of one card over gloo, and 2 processes x every card where
    there are several), or --devices. On cards K13 must run across the
    processes (``rdma_available``): the self-test fails where it
    cannot."""
    args = _args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU is available: pass cpu to run the "
                           "plain versions on the host")
    pid, device = args.pid, args.device
    use_rdma = {"auto": "auto", "on": True, "off": False}[args.rdma]
    initialize(f"127.0.0.1:{args.port}", args.nproc, pid,
               backend=args.backend)

    import scipy.sparse as sp
    import torch.distributed as dist

    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.parallel import distributed, rdma_ring, ring
    from ia_spgemm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device_type=device, devices=(
        None if args.devices is None else args.devices.split(",")))
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
    gate = rdma_ring.rdma_available(mesh)
    assert gate or device == "cpu", "K13 cannot run across these processes"
    A_ell = convert.csr_to_ell(A, check_guard=False)
    plan = ring.plan_ring(A_ell, A_ell, D)
    As_e = ring.partition_rows_ell(A_ell, D, mesh=mesh)
    if not gate:    # K13 cannot run here: use_rdma=True must raise
        try:
            ring.ring_spgemm(As_e, As_e, mesh, plan, use_rdma=True)
        except ValueError as e:
            assert "use_rdma=True" in str(e), e
        else:
            raise AssertionError("use_rdma=True ran without K13")
    err2 = 0.0
    for balance in ("rows", "flops"):
        Bs_e = ring.partition_rows_ell(A_ell, D, mesh=mesh, balance=balance)
        Ce = ring.ring_spgemm(As_e, Bs_e, mesh, plan, use_rdma=use_rdma)
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
    print(f"[p{pid}] ring ok: err {err2:.2e}, K13 across processes: "
          f"{gate}", flush=True)
    if args.matrix == "headline":
        _headline_ring(mesh, pid, use_rdma, device)
    rdma_ring.release_shared()
    _synchronize(mesh)
    dist.barrier()
    dist.destroy_process_group()
    print(f"[p{pid}] MULTIPROC_OK", flush=True)


def _synchronize(mesh) -> None:
    """Waits for the queued work of every card of this process's
    shards."""
    for d in dict.fromkeys(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def hop_bound_ms(cards, nbytes: int, hbm_bytes_per_s: float,
                 link_bytes_per_s: float) -> float:
    """The least time of one ring step: ``cards``, the card of each
    global shard (any hashable identity), each shard sending its block
    of ``nbytes`` to the previous one. Each card reads the blocks it
    sends and writes the blocks it receives once, at hbm_bytes_per_s;
    a block between two cards leaves its card and enters the other once,
    at link_bytes_per_s each way (NVLink, all to all). The busiest card
    and direction bound the step."""
    from collections import Counter
    hbm, out, into = Counter(), Counter(), Counter()
    D = len(cards)
    for d in range(D):
        src, dst = cards[(d + 1) % D], cards[d]
        hbm[src] += nbytes
        hbm[dst] += nbytes
        if src != dst:
            out[src] += nbytes
            into[dst] += nbytes
    return 1e3 * max(max(hbm.values()) / hbm_bytes_per_s,
                     max([*out.values(), *into.values(), 0])
                     / link_bytes_per_s)


HOPS = 20          # hops per timing window of _headline_ring
RING_CALLS = 5     # timed ring calls of _headline_ring
ORACLE_TOL = 1e-4  # against scipy, relative to max |C| of the rows held


def _rows_against_scipy(C, a64):
    """This process's rows of C against scipy's float64 rows of A @ A:
    the pattern exactly, values within ORACLE_TOL of their max |C|.
    Returns (rows, nnz, max |dval|, checksum's relative error)."""
    nrows = nnz = 0
    err = got_sum = want_sum = 0.0
    for rows in local_ell_rows(C):
        ok = rows.row_ids >= 0
        nr = rows.nnz_row[ok].astype(np.int64)
        mask = np.arange(rows.col_ind.shape[1])[None, :] < nr[:, None]
        cols = rows.col_ind[ok][mask]
        vals = rows.values[ok][mask].astype(np.float64)
        want = (a64[rows.row_ids[ok]] @ a64).tocsr().sorted_indices()
        if not (np.array_equal(nr, np.diff(want.indptr))
                and np.array_equal(cols, want.indices)):
            raise AssertionError(f"shard {rows.shard}: the pattern differs "
                                 "from scipy's")
        scale = max(1.0, float(np.abs(want.data).max(initial=0.0)))
        e = float(np.abs(vals - want.data).max(initial=0.0))
        if not e <= ORACLE_TOL * scale:
            raise AssertionError(f"shard {rows.shard}: max |dval| {e} over "
                                 f"{ORACLE_TOL} x {scale}")
        nrows += int(ok.sum())
        nnz += int(nr.sum())
        err = max(err, e)
        got_sum += float(vals.sum())
        want_sum += float(want.data.sum())
    rel = abs(got_sum - want_sum) / max(1.0, abs(want_sum))
    if not rel <= ORACLE_TOL:
        raise AssertionError(f"checksum relative error {rel}")
    return nrows, nnz, err, rel


def _headline_ring(mesh, pid: int, use_rdma, device: str) -> None:
    """The ring on the headline matrix (``bench.headline.build_matrix``,
    m = 32768) over every process's shards, use_rdma as given: this
    process's K13 / K4 launches in one call (K13 in every one of the
    D - 1 steps where it runs), its rows against scipy's A @ A, host ms
    per call between synchronisations of every process (RING_CALLS
    calls), and one hop of the headline's B blocks through K13 against
    the plain hop bit for bit, with ms per hop of each over HOPS hops
    and, in process 0, the kernel's device time from torch.profiler,
    beside the hop's bound on an H100 (``hop_bound_ms``, from every
    process's cards). Prints one ``{"multiproc": ...}`` JSON line."""
    import json
    import time

    import torch.distributed as dist

    from ia_spgemm_tpu_torch.bench.headline import build_matrix
    from ia_spgemm_tpu_torch.bench.kernels import PEAK_BYTES_PER_S
    from ia_spgemm_tpu_torch.bench.scaling import H100_NVLINK_BYTES_PER_S
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    from ia_spgemm_tpu_torch.parallel import rdma_ring as RR
    from ia_spgemm_tpu_torch.parallel import ring
    from ia_spgemm_tpu_torch.parallel.mesh import card_identities

    def synced():
        """Every process's queued work done, every process here."""
        _synchronize(mesh)
        dist.barrier()

    D = mesh.num_shards
    a64 = build_matrix()
    A = convert.csr_to_ell(CSR.from_scipy(a64.astype(np.float32),
                                          device=mesh.devices[0]),
                           check_guard=False)
    plan = ring.plan_ring(A, A, D)
    S = ring.partition_rows_ell(A, D, mesh=mesh)
    k13 = (RR.rdma_available(mesh) if use_rdma == "auto"
           else bool(use_rdma))
    call = lambda: ring.ring_spgemm(S, S, mesh, plan,  # noqa: E731
                                    use_rdma=use_rdma)

    synced()
    K.reset_launch_counts()
    RR.reset_launch_counts()
    C = call()
    _synchronize(mesh)
    launches = {**K.launch_counts(), **RR.launch_counts()}
    on_card = device == "cuda"     # the host runs the plain versions
    if launches["K13"] != (D - 1 if k13 else 0) or launches["K4"] != (
            len(mesh.devices) if on_card else 0):
        raise AssertionError(f"launches {launches} in a ring of {D} shards "
                             f"({len(mesh.devices)} here), K13 {k13}")
    nrows, nnz, err, rel = _rows_against_scipy(C, a64)
    ring_ms = []
    for _ in range(RING_CALLS):
        synced()
        t0 = time.perf_counter()
        call()
        synced()
        ring_ms.append((time.perf_counter() - t0) * 1e3)

    blocks = (S.col_ind, S.values)
    plain = RR.ring_hop_processes_plain(mesh, *blocks)
    cards = [c for i in card_identities(mesh) for c in i["cards"]]
    block_bytes = sum(b[0].numel() * b[0].element_size() for b in blocks)

    def per_hop(hop):
        synced()
        t0 = time.perf_counter()
        x = blocks
        for i in range(HOPS):
            x = hop(i, x)
        synced()
        return (time.perf_counter() - t0) * 1e3 / HOPS

    info = {"pid": pid, "processes": dist.get_world_size(),
            "shards": D, "local_shards": len(mesh.devices),
            "device": str(mesh.devices[0]),
            "devices": [str(d) for d in mesh.devices], "k13": k13,
            "cards": len(set(cards)), "block_bytes": block_bytes,
            "bound_ms_hop": (
                hop_bound_ms(cards, block_bytes, PEAK_BYTES_PER_S,
                             H100_NVLINK_BYTES_PER_S)
                if device == "cuda" else None),
            "launches": launches, "rows": nrows, "nnz": nnz,
            "max_abs_err": err, "checksum_rel_err": rel,
            "ring_ms": ring_ms, "ring_ms_median": float(np.median(ring_ms)),
            "plain_hop_ms": per_hop(
                lambda i, x: RR.ring_hop_processes_plain(mesh, *x))}
    if k13:
        sets = RR.shared_receivers(mesh, *blocks)
        got = RR.ring_hop_xproc(mesh, *blocks, out=sets[0])
        RR.check_hops(sets[0])
        if not all(torch.equal(g, w) for ga, wa in zip(got, plain)
                   for g, w in zip(ga, wa)):
            raise AssertionError("K13 across processes differs from the "
                                 "plain hop")
        xhop = lambda i, x: RR.ring_hop_xproc(  # noqa: E731
            mesh, *x, out=sets[i % 2])
        info["hop_bitwise_equal"] = True
        info["hop_ms"] = per_hop(xhop)
        info["kernel_us"] = _profiled_hop_us(xhop, blocks, pid, synced)
        RR.check_hops(sets[0])
    print(json.dumps({"multiproc": info}), flush=True)
    print(f"[p{pid}] headline ring ok: {nrows} rows, nnz {nnz}, max err "
          f"{err:.2e}, K13 launches {launches['K13']} in {D - 1} steps, "
          f"shards on {sorted(set(info['devices']))}", flush=True)


def _profiled_hop_us(hop, blocks, pid: int, synced):
    """Device us per launch of the cross-process K13 over HOPS hops that
    every process makes together; process 0 traces them (the others wait
    at a barrier while its profiler starts). None where it saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        synced()
        x = blocks
        for i in range(HOPS):
            x = hop(i, x)
        synced()

    if pid != 0:
        run()
        return None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    durs = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and "k13_ring_hop_xproc" in e.name]
    return sum(durs) / len(durs) if durs else None


if __name__ == "__main__":
    import sys

    _selftest(sys.argv[1:])
