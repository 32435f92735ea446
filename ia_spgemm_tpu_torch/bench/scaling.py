"""nnz/s scaling of the distributed SpGEMM paths (PyTorch port of
``ia_spgemm_tpu.bench.scaling``).

On several cards this measures the real thing; where shards share a
card (``IA_SPGEMM_SHARDS_PER_DEVICE``) or the CPU, it still runs the
whole sharded program, and every report says so with ``simulated:
true``: shards on one device run one after another, so the curve prices
the serialised work, not a speed-up.

Scaling protocol (weak or strong):
  strong: fixed global problem, split over D shards;
  weak:   per-shard rows held constant, global problem grows with D.
Efficiency(D) = throughput(D) / (D * throughput(1)): 1.0 at D = 1 by
definition, clamped to (0, 1] above.

    python -m ia_spgemm_tpu_torch.bench.scaling [--cpu] [--dist | --weak]
        [--m M] [--iters N] [--write OUT.json] [--d1-from D1.json]

A ring report whose shards each had a card of their own carries its
D = 1 point as ``d1_real_chip``; ``--d1-from`` reads that point from an
earlier report and prices the link from its time (``import_d1``).

``--cpu`` runs on the host with 8 shards (unless
IA_SPGEMM_SHARDS_PER_DEVICE says otherwise); on the card the shard
count per card comes from IA_SPGEMM_SHARDS_PER_DEVICE.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Sequence

import numpy as np
import torch

from ia_spgemm_tpu_torch.formats import convert
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.ops.flops import get_flop
from ia_spgemm_tpu_torch.parallel import ring
from ia_spgemm_tpu_torch.parallel.mesh import make_mesh, visible_devices

# NVIDIA's H100 SXM data sheet (not measurements): NVLink 900 GB/s to the
# other cards of the host, 450 GB/s each way; device memory 3.35 TB/s.
# The link rate prices the wire that a one-card run cannot measure.
H100_NVLINK_BYTES_PER_S = 4.5e11
H100_HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class ScalingPoint:
    devices: int
    nnz_out: int
    flops: int
    time_ms: float
    nnz_per_s: float
    gflops: float
    efficiency: float  # vs. linear scaling from the 1-shard point


def _time_ms(fn, devices, iters: int = 3, stat: str = "median") -> float:
    """ms per fn() after one warm-up call, the median (or min) of iters
    calls: CUDA events when the work lies on one card; the host clock
    between synchronisations of every card when it spans several (an
    event on one card does not see the others' work); the host clock on
    the CPU."""
    devs = sorted({torch.device(d) for d in (
        devices if isinstance(devices, (list, tuple)) else [devices])},
        key=str)
    cards = [d for d in devs if d.type == "cuda"]
    fn()
    ts = []
    for _ in range(iters):
        for d in cards:
            torch.cuda.synchronize(d)
        if len(cards) == 1:
            with torch.cuda.device(cards[0]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            for d in cards:
                torch.cuda.synchronize(d)
            ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.min(ts) if stat == "min" else np.median(ts))


def _efficiency(t1, d: int, t) -> float:
    """t1 / (d * t): 1.0 at d = 1, clamped to (0, 1] above."""
    return 1.0 if d == 1 else min(1.0, t1 / (d * t))


def _simulated(out: dict, devs) -> dict:
    """Mark a report simulated when a point had more shards than
    distinct devices (shards sharing a device run one after another)."""
    out["simulated"] = any(p["devices"] > len(set(devs))
                           for p in out["points"])
    return out


def measure_ring_scaling(A: CSR, device_counts: Sequence[int] = (1, 2, 4, 8),
                         iters: int = 3) -> List[ScalingPoint]:
    """Strong scaling of ring_spgemm C = A @ A over growing meshes on
    A's device type."""
    dtype = A.device.type
    n_avail = len(visible_devices(dtype))
    flops = get_flop(A, A)
    A_ell = convert.csr_to_ell(A, check_guard=False)
    points: List[ScalingPoint] = []
    base = None
    for d in device_counts:
        if d > n_avail:
            break
        mesh = make_mesh(d, device_type=dtype)
        As = ring.partition_rows_ell(A_ell, d, mesh=mesh)
        plan = ring.plan_ring(A_ell, A_ell, d)
        if not plan.viable:
            break

        def run():
            return ring.ring_spgemm(As, As, mesh, plan)

        ms = _time_ms(run, mesh.devices, iters)
        nnz_out = sum(int(x.sum()) for x in run().nnz_row)
        nnz_per_s = nnz_out / (ms / 1e3)
        if base is None:
            base = nnz_per_s
        points.append(ScalingPoint(
            devices=d, nnz_out=nnz_out, flops=flops, time_ms=ms,
            nnz_per_s=nnz_per_s, gflops=2.0 * flops / (ms * 1e6),
            efficiency=1.0 if d == 1 else min(1.0,
                                              nnz_per_s / (d * base))))
    return points


def _local_program(As, s: int, *, e_cap: int, out_cap: int, k: int, n: int):
    """Shard s's own work in the all-gather route, alone on its device:
    the reassembly of every B block (which the all_gather makes every
    shard repeat; here B = A) and the ESC engine on its rows."""
    from ia_spgemm_tpu_torch.ops import esc
    from ia_spgemm_tpu_torch.parallel import distributed as dist
    from ia_spgemm_tpu_torch.utils.scans import entry_rows

    dev = As.row_ptr[s].device
    g = [torch.stack([t.to(dev) for t in x])
         for x in (As.row_ptr, As.col_ind, As.values, As.nnz)]
    rs = torch.from_numpy(np.asarray(As.row_start)).to(dev)
    m_loc = As.rows_per_shard

    def run():
        b_rp, b_col, b_val, _ = dist._assemble_global_csr(
            *g, n_cols=n, row_start=rs, n_rows=k)
        a_rp, a_col = As.row_ptr[s], As.col_ind[s]
        return esc._esc_core(entry_rows(a_rp, a_col.shape[0]), a_col,
                             As.values[s], As.nnz[s], b_rp, b_col, b_val,
                             e_cap=e_cap, out_cap=out_cap, m=m_loc, k=k,
                             n=n)
    return run


def _block_bytes(As) -> int:
    """Bytes of one shard's B block (row pointers, columns, values)."""
    return sum(x[0].numel() * x[0].element_size()
               for x in (As.row_ptr, As.col_ind, As.values))


def measure_dist_scaling(A: CSR, device_counts: Sequence[int] = (1, 2, 4, 8),
                         iters: int = 3, balance: str = "flops",
                         link_bytes_per_s: float = H100_NVLINK_BYTES_PER_S
                         ) -> dict:
    """Scaling decomposition of the all-gather (dist) route, C = A @ A.

    Where shards share a device, the mesh's time at D > 1 is the sum of
    the shards' work, not a parallel speed-up. What such a run measures:

      per_shard_ms[d]   each shard's own program (B reassembly + ESC)
                        alone on its device; on D cards these run at
                        once, so the parallel compute time is
                        max_d per_shard_ms, and
      efficiency_measured_compute(D) = t1 / (D * max_d per_shard_ms)
                        is the load balance x work inflation, the wire
                        left out;
      mesh_serialized_ms  the whole dist_spgemm (gather included), for
                        the check mesh ~ sum of shards;
      comm              bytes over link_bytes_per_s (the data sheet's
                        NVLink rate), reported apart, never folded into
                        the measured numbers."""
    from ia_spgemm_tpu_torch.parallel import distributed as dist

    dtype = A.device.type
    devs = visible_devices(dtype)
    flops = get_flop(A, A)
    m, n = A.shape
    out = {"metric": "dist_spgemm_scaling", "backend": dtype,
           "balance": balance, "flops": int(flops), "points": []}
    t1_ms = None
    rerun_t1 = None
    for d in device_counts:
        if d > len(devs):
            break
        mesh = make_mesh(d, device_type=dtype)
        As = dist.partition_rows(A, d, balance=balance, B=A, mesh=mesh)
        e_cap, out_cap = dist.plan_dist_spgemm(A, A, d, balance=balance)
        per_shard = []
        for s in range(d):
            run_s = _local_program(As, s, e_cap=e_cap, out_cap=out_cap,
                                   k=m, n=n)
            # min over iters: robust to a neighbour's load between the
            # D = 1 and D > 1 points
            per_shard.append(_time_ms(run_s, As.row_ptr[s].device, iters,
                                      stat="min"))
            if d == 1:
                rerun_t1 = (lambda f=run_s, dv=As.row_ptr[0].device:
                            _time_ms(f, dv, iters, stat="min"))
        max_ms, sum_ms = max(per_shard), sum(per_shard)

        def mesh_run():
            return dist.dist_spgemm(As, As, mesh, e_cap=e_cap,
                                    out_cap=out_cap)

        mesh_ms = _time_ms(mesh_run, mesh.devices, iters)
        nnz_out = sum(int(x) for x in mesh_run().nnz)
        if t1_ms is None:
            t1_ms = max_ms
        # wire: each shard ships its B block once per all_gather round
        blk_bytes = _block_bytes(As)
        comm_ms = 0.0 if d == 1 else \
            (d - 1) * blk_bytes / link_bytes_per_s * 1e3
        t_par_model = max_ms + comm_ms
        out["points"].append({
            "devices": d, "per_shard_ms": per_shard,
            "max_shard_ms": max_ms, "sum_shard_ms": sum_ms,
            "mesh_serialized_ms": mesh_ms, "nnz_out": nnz_out,
            "comm_ms_modeled_per_device": comm_ms,
            "comm_bytes_per_link": 0 if d == 1 else blk_bytes * (d - 1),
            "projected_nnz_per_s": nnz_out / (t_par_model / 1e3),
            "_max_shard_raw": max_ms, "_comm_raw": comm_ms})
    # the D = 1 baseline once more after the last point: drift between
    # points is the main noise on a shared host; the min of the two can
    # only LOWER the efficiencies
    if out["points"] and rerun_t1 is not None:
        t1_best = min(t1_ms, rerun_t1())
        out["baseline_t1_ms_first"] = t1_ms
        out["baseline_t1_ms_best"] = t1_best
        for p in out["points"]:
            d, mx = p["devices"], p.pop("_max_shard_raw")
            comm = p.pop("_comm_raw")
            p["efficiency_measured_compute"] = _efficiency(t1_best, d, mx)
            p["efficiency_with_modeled_wire"] = _efficiency(
                t1_best, d, mx + comm)
    return _simulated(out, devs)


def measure_weak_scaling(base_m: int = 4096,
                         device_counts: Sequence[int] = (1, 2, 4, 8),
                         iters: int = 3, band: int = 4,
                         extra_per_row: int = 8, device_type: str = "cuda",
                         link_bytes_per_s: float = H100_NVLINK_BYTES_PER_S
                         ) -> dict:
    """WEAK scaling of the dist route: base_m rows per shard, the global
    problem growing with D. Every D runs the same per-shard row count
    and nnz distribution, so the D = 1 shard bounds any D > 1 shard
    (whose B reassembly covers a D times larger B) from below and

        eff_weak(D) = t_shard(1) / (max_d t_shard(D) + t_gather(D))

    is <= 1 by construction, up to timer noise (then clamped). The
    gather of every shard's B block onto one device is measured; the
    wire time of the same volume at link_bytes_per_s is reported apart."""
    from ia_spgemm_tpu_torch.bench.headline import build_matrix
    from ia_spgemm_tpu_torch.parallel import distributed as dist
    from ia_spgemm_tpu_torch.parallel.mesh import gather_shards

    devs = visible_devices(device_type)
    out = {"metric": "dist_spgemm_weak_scaling", "backend": device_type,
           "rows_per_device": base_m, "points": []}
    t1_ms = None
    rerun_t1 = None
    for d in device_counts:
        if d > len(devs):
            break
        m = base_m * d
        a = build_matrix(m=m, band=band, extra_per_row=extra_per_row)
        A = CSR.from_scipy(a.astype(np.float32), device=devs[0])
        mesh = make_mesh(d, device_type=device_type)
        As = dist.partition_rows(A, d, balance="flops", B=A, mesh=mesh)
        e_cap, out_cap = dist.plan_dist_spgemm(A, A, d, balance="flops")
        per_shard = []
        for s in range(d):
            run_s = _local_program(As, s, e_cap=e_cap, out_cap=out_cap,
                                   k=m, n=A.ncols)
            per_shard.append(_time_ms(run_s, As.row_ptr[s].device, iters,
                                      stat="min"))
            if d == 1:
                rerun_t1 = (lambda f=run_s, dv=As.row_ptr[0].device:
                            _time_ms(f, dv, iters, stat="min"))
        max_ms = max(per_shard)
        ag_ms = 0.0
        blk_bytes = _block_bytes(As)
        if d > 1:
            ag_ms = _time_ms(lambda: [gather_shards(mesh, x, mesh.devices[0])
                                      for x in (As.row_ptr, As.col_ind,
                                                As.values)],
                             mesh.devices, iters, stat="min")
        wire = 0 if d == 1 else blk_bytes * (d - 1)
        if t1_ms is None:
            t1_ms = max_ms
        out["points"].append({
            "devices": d, "global_rows": m, "flops": get_flop(A, A),
            "per_shard_ms": per_shard, "max_shard_ms": max_ms,
            "allgather_measured_ms": ag_ms,
            "allgather_bytes_per_link": wire,
            "comm_link_projected_ms": wire / link_bytes_per_s * 1e3,
            "time_ms": max_ms + ag_ms})
    if out["points"] and rerun_t1 is not None:
        t1_end = rerun_t1()
        t1_best = min(t1_ms, t1_end)
        out["baseline_t1_ms_first"] = t1_ms
        out["baseline_t1_ms_last"] = t1_end
        out["baseline_drift"] = max(t1_ms, t1_end) / t1_best
        for p in out["points"]:
            # no factor D: every shard's work is the D = 1 shard's
            one = p["devices"] == 1
            p["efficiency_weak"] = 1.0 if one else min(1.0, t1_best / (
                p["max_shard_ms"] + p["allgather_measured_ms"]))
            p["efficiency_weak_link_projected"] = 1.0 if one else min(
                1.0, t1_best / (p["max_shard_ms"]
                                + p["comm_link_projected_ms"]))
    return _simulated(out, devs)


def model_ring_efficiency(A, device_counts: Sequence[int] = (1, 2, 4, 8),
                          *, t1_ms: float,
                          link_bytes_per_s: float = H100_NVLINK_BYTES_PER_S,
                          overlap: bool = True) -> List[dict]:
    """Analytic comm-volume / link model of the ring SpGEMM.

    The ring (parallel/ring.py) row-partitions A and rotates B's blocks
    D - 1 times; each step every shard sends its resident B block
    (padded ELL: a 4-byte column and a value per slot) to its neighbour,
    so every link carries sizeof_ell(B) / D bytes per step at once:

        t_comm(D)    = (D-1) * sizeof_ell(B)/D / link_bw
        t_compute(D) = t1/D            (row-partitioned expand + sort)
        t(D)         = max(compute, comm)   when the hop overlaps
                       compute + comm       when it does not
        eff(D)       = t1 / (D * t(D))

    t1_ms must come from a measured one-shard run of the same program.
    A may be a CSR or an ELL."""
    if hasattr(A, "max_nnz_per_row"):
        kb = int(A.max_nnz_per_row)
    else:
        kb = int(np.diff(A.row_ptr.cpu().numpy()).max(initial=0))
    b_bytes = A.nrows * kb * (4 + A.values.element_size())
    out = []
    for d in device_counts:
        comm_ms = 0.0 if d == 1 else \
            (d - 1) * (b_bytes / d) / link_bytes_per_s * 1e3
        compute_ms = t1_ms / d
        t_ms = max(compute_ms, comm_ms) if overlap \
            else compute_ms + comm_ms
        out.append({
            "devices": d, "compute_ms": compute_ms, "comm_ms": comm_ms,
            "time_ms": t_ms, "efficiency": t1_ms / (d * t_ms),
            "comm_bytes_per_link": int(0 if d == 1 else b_bytes / d)})
    return out


def report(points: List[ScalingPoint], device_type: str,
           simulated: bool | None = None) -> dict:
    """The ring scaling JSON: simulated unless every point's shards had
    cards of their own."""
    n_cards = len(set(visible_devices(device_type)))
    if simulated is None:
        simulated = any(p.devices > n_cards for p in points)
    name = (torch.cuda.get_device_name(0) if device_type == "cuda"
            else "cpu")
    return {"metric": "ring_spgemm_scaling", "simulated": simulated,
            "backend": device_type, "device_name": name,
            "points": [dataclasses.asdict(p) for p in points]}


def import_d1(rep: dict, path: str, A, device_counts) -> dict:
    """--d1-from: carry a card run's D = 1 point (``d1_real_chip`` of an
    earlier report) into rep, with the link-priced curve from its time
    (``model_h100_nvlink_from_d1``). A missing or garbled file, or one
    without the point, is recorded as ``d1_import_error`` and does not
    lose the report."""
    import json
    try:
        with open(path) as f:
            d1 = json.load(f).get("d1_real_chip")
    except (OSError, ValueError, AttributeError) as e:
        rep["d1_import_error"] = f"{type(e).__name__}: {e}"
        return rep
    if not d1:
        rep["d1_import_error"] = (
            f"{path} has no d1_real_chip entry (measurement pass did not "
            "run on the chip)")
        return rep
    rep["d1_real_chip"] = d1
    rep["model_h100_nvlink_from_d1"] = model_ring_efficiency(
        A, device_counts, t1_ms=float(d1["time_ms"]))
    return rep


def _arg(argv, flag, default=None):
    return argv[argv.index(flag) + 1] if flag in argv else default


def main(argv=None) -> int:
    import json
    import sys

    from ia_spgemm_tpu_torch.bench.headline import build_matrix
    from ia_spgemm_tpu_torch.parallel.mesh import SHARDS_PER_DEVICE_ENV

    argv = sys.argv[1:] if argv is None else argv
    device_type = "cpu" if "--cpu" in argv else "cuda"
    if device_type == "cpu":
        os.environ.setdefault(SHARDS_PER_DEVICE_ENV, "8")
    elif not torch.cuda.is_available():
        print("scaling: no CUDA GPU (use --cpu)", file=sys.stderr)
        return 1
    iters = int(_arg(argv, "--iters", 3))
    m = int(_arg(argv, "--m", 8192))
    a = build_matrix(m=m, band=4, extra_per_row=8)
    A = CSR.from_scipy(a.astype(np.float32), device=device_type)
    if "--weak" in argv:
        rep = measure_weak_scaling(iters=iters, device_type=device_type)
    elif "--dist" in argv:
        rep = measure_dist_scaling(A, iters=iters)
    else:
        pts = measure_ring_scaling(A, iters=iters)
        rep = report(pts, device_type)
        if pts:
            # the link-priced curve beside the measured one: the same
            # program with the wire priced at the data sheet's NVLink
            # rate, from this run's one-shard time
            rep["model_h100_nvlink"] = model_ring_efficiency(
                A, sorted({p.devices for p in pts} | {8, 16, 32}),
                t1_ms=pts[0].time_ms)
            if not rep["simulated"]:
                # each shard had a card of its own: the D = 1 point is a
                # card's measurement, which --d1-from reads back
                rep["d1_real_chip"] = {**dataclasses.asdict(pts[0]),
                                       "simulated": False}
        if _arg(argv, "--d1-from"):
            import_d1(rep, _arg(argv, "--d1-from"), A,
                      sorted({p.devices for p in pts} | {8, 16, 32}))
    out = json.dumps(rep)
    print(out)
    path = _arg(argv, "--write")
    if path:
        with open(path, "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
