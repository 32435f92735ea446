"""Benchmark harness (PyTorch port of ``ia_spgemm_tpu.bench.harness``):
per-algorithm timing, watchdog, memory, checksum, GFLOPS, speedup and
the MatNet verdict.

Reference methodology (main.cpp:709-1000): per algorithm run_time (ms),
trans_time (format conversion and planning, ms), memory_size (bytes of C
in its format, the sizeof* formulas), verified_sum (sum of C's values),
GFLOPS = 2*flops/(ms*1e6) with flops = GetFlop(A, B) (main.cpp:989),
speedup = t_baseline / t_alg (main.cpp:968-979), and every verified_sum
checked against the baseline's (1e-4 relative in float32; the bf16
``serve`` row at SERVE_CHECKSUM_TOL).

- Viability: a format its guard rejects (the reference's choice=false,
  dia/common_dia.h:56), or a route that cannot take the input, is
  reported as skipped, with the JAX package's guards and budgets.
- Watchdog: an algorithm is abandoned past timeout_scale x the
  baseline's runtime (at least 5 s; main.cpp:43-93,770-793), the first
  run (which builds the kernels) past COMPILE_BUDGET_S. In process it
  runs in a worker thread the harness stops waiting on; a kernel already
  on the card runs to its end, as a dispatched TPU program did. With
  ``isolate=True`` each row runs in its own process (bench/isolated.py),
  which the harness kills at the budget, freeing the card.
- Values keep the matrices' type: float64 CSRs run the rows that take
  them (bitonic, csr, esc, ...) in float64 and are held to 1e-9 of the
  baseline.
- Times: on a CUDA device the median of CUDA-event intervals around each
  run (device time of the enqueued work); on the CPU the median host
  wall time. Warm-up runs are untimed.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ia_spgemm_tpu_torch import config as cfg
from ia_spgemm_tpu_torch.formats import convert
from ia_spgemm_tpu_torch.formats.types import CSR, BlockCSR
from ia_spgemm_tpu_torch.ops.flops import get_flop

ALGORITHMS = ("baseline", "csr", "dia", "ell", "coo")   # reference menu
# every row the harness runs (the JAX package's menu but for the
# distributed modes, which are CLI modes there too)
PORTED_ALGORITHMS = ALGORITHMS + ("esc", "bitonic", "compensated", "dense",
                                  "dense_row", "hash", "serve")

# serve-lane checksum gate: bf16-rounded products carry <= 2^-9 relative
# error each (float32 sums), so its verified_sum is held to this bound
SERVE_CHECKSUM_TOL = 2e-2

# Budget of an algorithm's first run, which includes building the CUDA
# kernels at first use (nvcc, seconds) and the first launch.
COMPILE_BUDGET_S = 300.0


@dataclasses.dataclass
class AlgorithmResult:
    name: str
    ok: bool = False
    skipped: bool = False           # viability guard rejected the input
    timed_out: bool = False
    run_time_ms: float = 0.0
    trans_time_ms: float = 0.0
    memory_bytes: float = 0.0       # size of C in this algorithm's format
    verified_sum: float = 0.0
    gflops: float = 0.0
    speedup: float = 0.0
    error: str = ""


@dataclasses.dataclass
class BenchReport:
    matrix_a: str
    matrix_b: str
    shape_a: tuple
    shape_b: tuple
    nnz_a: int
    nnz_b: int
    flops: int
    results: List[AlgorithmResult] = dataclasses.field(default_factory=list)
    winner: str = ""
    matnet_pick: str = ""
    matnet_correct: Optional[bool] = None

    def by_name(self, name: str) -> Optional[AlgorithmResult]:
        for r in self.results:
            if r.name == name:
                return r
        return None


def time_ms(fn: Callable, device: torch.device, warmup: int = 1,
            iters: int = 3) -> float:
    """Median ms of fn(): CUDA events on a CUDA device, host wall time
    otherwise."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _run_with_timeout(fn: Callable, timeout_s: Optional[float]):
    """Run fn in a worker thread; abandon it past timeout_s (the
    watchdog). Returns (result, timed_out)."""
    if timeout_s is None or timeout_s <= 0:
        return fn(), False
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(fn)
    try:
        return fut.result(timeout=timeout_s), False
    except concurrent.futures.TimeoutError:
        ex.shutdown(wait=False, cancel_futures=True)
        return None, True
    finally:
        ex.shutdown(wait=False)


def _synced(x, device: torch.device):
    """x, once the device has finished the work enqueued so far."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return x


def _scipy_baseline(A: CSR, B: CSR, iters: int):
    """scipy.sparse CSR x CSR on the host, the role MKL plays in the
    reference (main.cpp:709-765)."""
    a = A.to_scipy().astype(A.values.cpu().numpy().dtype)
    b = B.to_scipy().astype(B.values.cpu().numpy().dtype)
    c = a @ b
    t = time_ms(lambda: a @ b, torch.device("cpu"), warmup=0, iters=iters)
    return t, float(c.sum()), c.nnz


def run_benchmark(A: CSR, B: CSR,
                  algorithms: Sequence[str] = ALGORITHMS,
                  *,
                  matrix_a: str = "A", matrix_b: str = "B",
                  config: cfg.SpGEMMConfig = cfg.DEFAULT_CONFIG,
                  matnet_pick: Optional[str] = None,
                  iters: int = 3, isolate: bool = False,
                  isolate_device: Optional[str] = None) -> BenchReport:
    """Benchmark every algorithm computing C = A @ B, reference-style, on
    the device A and B live on. An algorithm that fails (an unknown name
    included) is reported with its error, not raised.

    isolate=True runs each row but the baseline in a killable subprocess
    on isolate_device ("cuda" or "cpu"; default A's device type), with
    the row's watchdog budget (bench/isolated.py): a row that times out
    is killed with its process and cannot hold the card for the rows
    after it."""
    flops = get_flop(A, B)
    report = BenchReport(matrix_a=matrix_a, matrix_b=matrix_b,
                         shape_a=A.shape, shape_b=B.shape,
                         nnz_a=int(A.nnz), nnz_b=int(B.nnz), flops=flops)
    baseline_ms = baseline_sum = timeout_s = None
    for name in algorithms:
        res = AlgorithmResult(name=name)
        report.results.append(res)
        try:
            if name == "baseline":
                ms, vsum, nnz_c = _scipy_baseline(A, B, iters)
                res.ok = True
                res.run_time_ms = ms
                res.verified_sum = vsum
                res.memory_bytes = convert.sizeof_csr(A.nrows, nnz_c)
                baseline_ms, baseline_sum = ms, vsum
                # watchdog budget for everything after the baseline
                # (main.cpp:510,751: 20 x the baseline's runtime)
                timeout_s = max(config.timeout_scale * ms / 1e3, 5.0)
                continue
            # a menu without a leading baseline gets the fixed budget, so
            # the watchdog never disarms
            budget_s = timeout_s if timeout_s is not None \
                else config.default_timeout_s
            if isolate:
                from ia_spgemm_tpu_torch.bench.isolated import (
                    bench_algorithm_isolated)
                report.results[-1] = bench_algorithm_isolated(
                    A, B, name, timeout_s=budget_s, iters=iters,
                    device=isolate_device)
                continue
            _bench_one(name, A, B, config, budget_s, res, iters)
        except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
            res.error = f"{type(e).__name__}: {e}"

    for res in report.results:
        if res.ok and res.run_time_ms > 0:
            res.gflops = 2.0 * flops / (res.run_time_ms * 1e6)
            if baseline_ms:
                res.speedup = baseline_ms / res.run_time_ms
    ok = [r for r in report.results if r.ok and r.run_time_ms > 0]
    if ok:
        report.winner = max(ok, key=lambda r: r.speedup or
                            (1.0 / r.run_time_ms)).name
    if baseline_sum is not None:
        # the oracle sums in float64; the kernels run in the matrix dtype
        tol = 1e-9 if A.dtype == torch.float64 else 1e-4
        for res in report.results:
            if not res.ok or res.name == "baseline":
                continue
            rtol = SERVE_CHECKSUM_TOL if res.name == "serve" else tol
            if abs(res.verified_sum - baseline_sum) > rtol * max(
                    1.0, abs(baseline_sum)):
                res.error = (f"checksum mismatch vs baseline: "
                             f"{res.verified_sum} != {baseline_sum}")
    if matnet_pick is not None:
        report.matnet_pick = matnet_pick
        report.matnet_correct = matnet_pick == report.winner
    return report


# ------------------------------------------------------------------ rows
# Each row returns (convert_fn or None, compute) or None when its guard
# skips the input; convert_fn's work (format conversion, planning) is
# timed as trans time, compute(converted) is the timed run.

def _ell_probe(A: CSR, ratio: float):
    """The ELL guard from the planner's K alone."""
    K = convert.plan_ell_width(A)
    return K if convert.ell_viable(A.nrows, int(A.nnz), K, ratio) else None


def _dia_probe(A: CSR, ratio: float):
    nd = len(convert.plan_dia_offsets(A))
    return nd if convert.dia_viable(A.nrows, A.ncols, int(A.nnz), nd,
                                    ratio) else None


def _ells(A: CSR, B: CSR):
    return (convert.csr_to_ell(A, check_guard=False),
            convert.csr_to_ell(B, check_guard=False))


def _bitonic_row(A: CSR, B: CSR, config):
    """Flat plan when viable, else the width-class route (BlockCSR out);
    CSR -> ELL and the class plan are conversion."""
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    kb = convert.plan_ell_width(B)
    flat_plan = bt.plan_bitonic_dims(A.nrows, convert.plan_ell_width(A), kb)
    lens = np.diff(A.row_ptr.cpu().numpy())
    if not (flat_plan.viable or bt.multiclass_viable(lens, kb)):
        return None

    def convert_fn():
        A_ell, B_ell = _ells(A, B)
        if flat_plan.viable:
            return ("flat", A_ell, B_ell)
        return ("mc", bt.multiclass_planned(A_ell, B_ell, assemble="bcsr"))

    def compute(ab):
        if ab[0] == "flat":
            return bt.spgemm_bitonic(ab[1], ab[2], flat_plan)
        return ab[1]() if ab[1] is not None else None
    return convert_fn, compute


def _csr_row(A: CSR, B: CSR, config):
    """The production auto route (esc.plan_csr_auto); its planning is
    conversion."""
    from ia_spgemm_tpu_torch.ops import esc
    return ((lambda: esc.plan_csr_auto(A, B,
                                       bucket=config.bucket_capacities)),
            (lambda rc: rc[1]()))


def _esc_row(A: CSR, B: CSR, config):
    """The ESC engine without the tiled route: the slab engine (SlabCSR
    out), slab + global for heavy rows, else the global engine."""
    from ia_spgemm_tpu_torch.ops import esc
    from ia_spgemm_tpu_torch.ops import slab
    scall = slab.plan_slab_csr(A, B)
    if scall is None:
        scall = slab.plan_slab_hybrid(A, B)
    if scall is not None:
        return None, lambda _: scall()
    plan = esc.plan_spgemm(A, B, bucket=config.bucket_capacities)
    return None, lambda _: esc.spgemm_csr(A, B, plan, engine="global")


def _compensated_row(A: CSR, B: CSR, config):
    """Float64-grade sums from float32 operands; skipped where the
    compensated path cannot run (it does not slice)."""
    from ia_spgemm_tpu_torch.ops import esc
    if (A.dtype != torch.float32
            or (A.nrows + 1) * (B.ncols + 1) >= 2**31):
        return None
    plan = esc.plan_spgemm(A, B, bucket=config.bucket_capacities)
    if plan.slabs is not None:
        return None
    return None, lambda _: esc.spgemm_csr_compensated(A, B, plan)


def _coo_row(A: CSR, B: CSR, config):
    from ia_spgemm_tpu_torch.ops import esc
    if not convert.coo_viable(A.nrows, int(A.nnz), config.size_guard_ratio):
        return None
    plan = esc.plan_spgemm(A, B, bucket=config.bucket_capacities)
    return ((lambda: (convert.csr_to_coo(A), convert.csr_to_coo(B))),
            (lambda ab: esc.spgemm_coo(ab[0], ab[1], plan)))


def _ell_row(A: CSR, B: CSR, config):
    from ia_spgemm_tpu_torch.ops import ell
    ratio = config.size_guard_ratio
    if _ell_probe(A, ratio) is None or _ell_probe(B, ratio) is None:
        return None
    return (lambda: _ells(A, B)), (lambda ab: ell.spgemm_ell(*ab))


def _dia_row(A: CSR, B: CSR, config):
    """Skipped by the size guard or by the compute budget, which rejects
    before dispatch (dia.DIA_PAIR_FLOP_BUDGET)."""
    from ia_spgemm_tpu_torch.ops import dia
    ratio = config.size_guard_ratio
    nda, ndb = _dia_probe(A, ratio), _dia_probe(B, ratio)
    if nda is None or ndb is None or not dia.dia_compute_viable(
            nda, ndb, A.nrows):
        return None
    return ((lambda: (convert.csr_to_dia(A, check_guard=False),
                      convert.csr_to_dia(B, check_guard=False))),
            (lambda ab: dia.spgemm_dia(*ab)))


def _dense_budget_ok(elems: int, A: CSR, config) -> bool:
    return elems * A.values.element_size() <= config.dense_bytes_budget


def _dense_matmul_row(A: CSR, B: CSR, config):
    """A, B and C all densify: the device-memory budget guards it."""
    from ia_spgemm_tpu_torch.ops import dense
    if not _dense_budget_ok(A.nrows * A.ncols + B.nrows * B.ncols
                                + A.nrows * B.ncols, A, config):
        return None
    return ((lambda: (convert.csr_to_dense(A), convert.csr_to_dense(B))),
            (lambda ab: dense.spgemm_dense(*ab)))


def _dense_row_row(A: CSR, B: CSR, config):
    """K11: B and C densify (the budget), n within MAX_N_F32, A
    ELL-viable."""
    from ia_spgemm_tpu_torch.ops import dense_row as dr
    if (B.ncols > dr.MAX_N_F32
            or not _dense_budget_ok(B.nrows * B.ncols
                                        + A.nrows * B.ncols, A, config)
            or _ell_probe(A, config.size_guard_ratio) is None):
        return None
    return ((lambda: (convert.csr_to_ell(A, check_guard=False),
                      convert.csr_to_dense(B))),
            (lambda ab: dr.spgemm_dense_row(*ab)))


def _hash_row(A: CSR, B: CSR, config):
    """K12: float32 only, both operands ELL-viable, the tables within the
    JAX package's budget (hash_viable)."""
    from ia_spgemm_tpu_torch.ops import hash_spgemm as hs
    ratio = config.size_guard_ratio
    lens_a = np.diff(A.row_ptr.cpu().numpy())
    lens_b = np.diff(B.row_ptr.cpu().numpy())
    if (A.dtype != torch.float32
            or _ell_probe(A, ratio) is None or _ell_probe(B, ratio) is None
            or not hs.hash_viable(int(lens_a.max(initial=0)),
                                  int(lens_b.max(initial=0)), B.ncols)):
        return None
    return (lambda: _ells(A, B)), (lambda ab: hs.spgemm_hash(*ab))


def _serve_row(A: CSR, B: CSR, config):
    """K7, the bf16 + sparse serving lane: products round to bfloat16 and
    travel with their column in one int32 key; the output keeps
    survivors at their sorted slots (compact=False). Needs the flat
    plan's expand-from-gather path (per-product relative error <= 2^-9,
    float32 sums: checksum gate SERVE_CHECKSUM_TOL)."""
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    ka = convert.plan_ell_width(A)
    kb = convert.plan_ell_width(B)
    plan = bt.plan_bitonic_dims(A.nrows, ka, kb)
    lanes = max(128, 4 * plan.run)
    ka_eff = ka * plan.chunks
    if (A.dtype != torch.float32 or B.ncols > 32768 or not plan.viable
            or plan.width > bt.TRANSPOSED_MAX_WIDTH
            or ka_eff * plan.run > plan.width
            or ka_eff * lanes > bt._EXPAND_TILE_ELEMS):
        return None
    return (lambda: _ells(A, B)), (lambda ab: bt.spgemm_bitonic(
        ab[0], ab[1], plan, value_mode="bf16", compact=False))


_ROWS = {"bitonic": _bitonic_row, "csr": _csr_row, "esc": _esc_row,
         "compensated": _compensated_row, "coo": _coo_row, "ell": _ell_row,
         "dia": _dia_row, "dense": _dense_matmul_row,
         "dense_row": _dense_row_row, "hash": _hash_row, "serve": _serve_row}


def _memory_bytes(name: str, C) -> float:
    """Bytes of C in the row's format (the reference's sizeof*)."""
    if isinstance(C, BlockCSR):
        return float(C.padded_bytes())
    if name in ("csr", "esc", "compensated"):
        return convert.sizeof_csr(C.nrows, int(C.nnz))
    if name == "coo":
        return convert.sizeof_coo(C.nrows, int(C.nnz))
    if name in ("ell", "bitonic"):
        return convert.sizeof_ell(C.nrows, C.max_nnz_per_row)
    if name == "hash":
        # the table carries load-factor padding: report the canonical ELL
        # footprint of the widest real row
        return convert.sizeof_ell(C.nrows, max(int(C.nnz_row.max()), 1))
    if name == "dia":
        return convert.sizeof_dia(C.nrows, C.ncols, C.num_diagonals)
    if name in ("dense", "dense_row"):
        return 8.0 * C.nrows * C.ncols
    return 0.0


def _bench_one(name: str, A: CSR, B: CSR, config: cfg.SpGEMMConfig,
               timeout_s: Optional[float], res: AlgorithmResult,
               iters: int):
    """Convert (timed as trans time), first run and one steady run under
    the watchdog (none when timeout_s is None: an isolated worker, which
    its parent kills), then the timed runs; C's checksum and size."""
    if name not in _ROWS:
        raise ValueError(f"unknown algorithm {name!r}")
    row = _ROWS[name](A, B, config)
    if row is None:
        res.skipped = True
        return None
    convert_fn, compute = row
    dev = A.device
    converted = None
    if convert_fn is not None:
        converted = _synced(convert_fn(), dev)
        res.trans_time_ms = time_ms(convert_fn, dev, warmup=0,
                                    iters=max(iters, 1))
    C, timed_out = _run_with_timeout(
        lambda: _synced(compute(converted), dev),
        None if timeout_s is None else max(timeout_s, COMPILE_BUDGET_S))
    if timed_out:
        res.timed_out = True
        return None
    if C is None:
        # the width-class probe is an upper bound; the route may decline
        res.skipped = True
        return None
    _, timed_out = _run_with_timeout(
        lambda: _synced(compute(converted), dev), timeout_s)
    if timed_out:
        res.timed_out = True
        return None
    res.run_time_ms = time_ms(lambda: compute(converted), dev, warmup=0,
                              iters=iters)
    res.verified_sum = float(C.checksum())
    res.memory_bytes = _memory_bytes(name, C)
    res.ok = True
    return C
