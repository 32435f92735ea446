"""Benchmark harness (PyTorch port of ``ia_spgemm_tpu.bench.harness``,
the ``baseline``, ``bitonic``, ``csr``, ``esc`` and ``compensated`` rows).

Reference methodology (main.cpp:709-1000): per algorithm run_time (ms),
trans_time (format conversion and planning, ms), memory_size (bytes of C
in its format), verified_sum (sum of C's values), GFLOPS =
2*flops/(ms*1e6) with flops = GetFlop(A, B) (main.cpp:989), speedup =
t_baseline / t_alg (main.cpp:968-979), and every verified_sum checked
against the baseline's.

Times: on a CUDA device, the median of CUDA-event intervals around each
run (device time of the enqueued work); on the CPU, the median host wall
time. The warm-up run is untimed. Planning that the JAX package counts as
conversion (the bitonic and csr rows) is timed as trans time. Algorithms
not in PORTED_ALGORITHMS raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ia_spgemm_tpu_torch.formats import convert
from ia_spgemm_tpu_torch.formats.types import CSR, BlockCSR
from ia_spgemm_tpu_torch.ops.flops import get_flop

PORTED_ALGORITHMS = ("baseline", "bitonic", "csr", "esc", "compensated")


@dataclasses.dataclass
class AlgorithmResult:
    name: str
    ok: bool = False
    skipped: bool = False           # no viable plan for this input
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


def _scipy_baseline(A: CSR, B: CSR, iters: int):
    """scipy.sparse CSR x CSR on the host, the role MKL plays in the
    reference (main.cpp:709-765)."""
    a = A.to_scipy().astype(A.values.cpu().numpy().dtype)
    b = B.to_scipy().astype(B.values.cpu().numpy().dtype)
    c = a @ b
    t = time_ms(lambda: a @ b, torch.device("cpu"), warmup=0, iters=iters)
    return t, float(c.sum()), c.nnz


def run_benchmark(A: CSR, B: CSR,
                  algorithms: Sequence[str] = PORTED_ALGORITHMS,
                  *,
                  matrix_a: str = "A", matrix_b: str = "B",
                  iters: int = 3) -> BenchReport:
    """Benchmark every algorithm computing C = A @ B, reference-style, on
    the device A and B live on. An algorithm that fails is reported with
    its error, not raised."""
    unported = [n for n in algorithms if n not in PORTED_ALGORITHMS]
    if unported:
        raise NotImplementedError(
            f"algorithms {unported} are not ported yet (ported: "
            f"{', '.join(PORTED_ALGORITHMS)})")
    flops = get_flop(A, B)
    report = BenchReport(matrix_a=matrix_a, matrix_b=matrix_b,
                         shape_a=A.shape, shape_b=B.shape,
                         nnz_a=int(A.nnz), nnz_b=int(B.nnz), flops=flops)
    baseline_ms = baseline_sum = None
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
                continue
            _bench_one(name, A, B, res, iters)
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
            if res.ok and res.name != "baseline" and abs(
                    res.verified_sum - baseline_sum) > tol * max(
                    1.0, abs(baseline_sum)):
                res.error = (f"checksum mismatch vs baseline: "
                             f"{res.verified_sum} != {baseline_sum}")
    return report


def _bitonic_row(A: CSR, B: CSR):
    """The bitonic row: flat plan when viable, else the width-class route
    (BlockCSR out); CSR -> ELL and the class plan are conversion."""
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    kb = convert.plan_ell_width(B)
    flat_plan = bt.plan_bitonic_dims(A.nrows, convert.plan_ell_width(A), kb)
    lens = np.diff(A.row_ptr.cpu().numpy())
    if not (flat_plan.viable or bt.multiclass_viable(lens, kb)):
        return None

    def convert_fn():
        A_ell = convert.csr_to_ell(A, check_guard=False)
        B_ell = convert.csr_to_ell(B, check_guard=False)
        if flat_plan.viable:
            return ("flat", A_ell, B_ell)
        return ("mc", bt.multiclass_planned(A_ell, B_ell, assemble="bcsr"))

    def compute(ab):
        if ab[0] == "flat":
            return bt.spgemm_bitonic(ab[1], ab[2], flat_plan)
        return ab[1]() if ab[1] is not None else None
    return convert_fn, compute


def _csr_row(A: CSR, B: CSR):
    """The production auto route (esc.plan_csr_auto); its planning is
    conversion."""
    from ia_spgemm_tpu_torch.ops import esc
    return (lambda: esc.plan_csr_auto(A, B)), (lambda rc: rc[1]())


def _esc_row(A: CSR, B: CSR):
    """The ESC engine without the tiled route: the slab engine (SlabCSR
    out), slab + global for heavy rows, else the global engine."""
    from ia_spgemm_tpu_torch.ops import esc
    from ia_spgemm_tpu_torch.ops import slab
    scall = slab.plan_slab_csr(A, B)
    if scall is None:
        scall = slab.plan_slab_hybrid(A, B)
    if scall is not None:
        return None, lambda _: scall()
    plan = esc.plan_spgemm(A, B)
    return None, lambda _: esc.spgemm_csr(A, B, plan, engine="global")


def _compensated_row(A: CSR, B: CSR):
    """Float64-grade sums from float32 operands; skipped where the
    compensated path cannot run (it does not slice)."""
    from ia_spgemm_tpu_torch.ops import esc
    if (A.dtype != torch.float32
            or (A.nrows + 1) * (B.ncols + 1) >= 2**31):
        return None
    plan = esc.plan_spgemm(A, B)
    if plan.slabs is not None:
        return None
    return None, lambda _: esc.spgemm_csr_compensated(A, B, plan)


_ROWS = {"bitonic": _bitonic_row, "csr": _csr_row, "esc": _esc_row,
         "compensated": _compensated_row}


def _bench_one(name: str, A: CSR, B: CSR, res: AlgorithmResult,
               iters: int):
    """Plan (conversion, timed as trans time where the row has one), run
    (timed), then C's checksum and size in its format."""
    row = _ROWS[name](A, B)
    if row is None:
        res.skipped = True
        return None
    convert_fn, compute = row
    converted = None
    if convert_fn is not None:
        converted = convert_fn()
        res.trans_time_ms = time_ms(convert_fn, A.device, warmup=0,
                                    iters=max(iters, 1))
    C = compute(converted)
    if C is None:
        res.skipped = True
        return None
    res.run_time_ms = time_ms(lambda: compute(converted), A.device,
                              warmup=0, iters=iters)
    res.verified_sum = float(C.checksum())
    if isinstance(C, BlockCSR):
        res.memory_bytes = float(C.padded_bytes())
    elif name == "bitonic":
        res.memory_bytes = convert.sizeof_ell(C.nrows, C.max_nnz_per_row)
    else:
        res.memory_bytes = convert.sizeof_csr(C.nrows, int(C.nnz))
    res.ok = True
    return C
