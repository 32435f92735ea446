"""Per-kernel roofline analysis (PyTorch port of
``ia_spgemm_tpu.bench.roofline``).

The reference only reports wall-clock time and GFLOPS (main.cpp:981-
991); here each kernel gets an analytic cost model (useful flops and the
least memory traffic) and a measured time then yields achieved GFLOPS,
GB/s and the distance to the card's roof. The cost models are the JAX
package's, byte for byte and operation for operation.

The card's peaks come from its name (``detect_chip``): NVIDIA's H100
data sheet, SXM (HBM3, 3.35 TB/s, 67 TFLOP/s float32 outside the tensor
cores, 989 TFLOP/s bf16 dense) or PCIe (2.0 TB/s, 51 TFLOP/s, 756
TFLOP/s). They are data-sheet figures at the full power limit, not
measurements; a card set below it (``nvidia-smi``'s power.limit) runs
slower under load. An unknown card raises rather than borrowing
another's peaks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbs: float          # memory bandwidth, GB/s
    peak_f32_gflops: float  # float32 outside the tensor cores
    peak_bf16_gflops: float  # bf16 tensor cores, dense


# NVIDIA H100 data sheet (SXM5 and PCIe parts, dense rates)
H100_SXM = ChipSpec(name="h100_sxm", hbm_gbs=3350.0,
                    peak_f32_gflops=67_000.0, peak_bf16_gflops=989_000.0)
H100_PCIE = ChipSpec(name="h100_pcie", hbm_gbs=2000.0,
                     peak_f32_gflops=51_000.0, peak_bf16_gflops=756_000.0)


def detect_chip(device=None) -> ChipSpec:
    """The peaks of the card `device` (default: the current card), by
    its name: "PCIe" names the PCIe part, "SXM" or "HBM3" (as in "NVIDIA
    H100 80GB HBM3") the SXM part. Raises for another card or none."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("detect_chip: no CUDA GPU; pass a ChipSpec")
    name = torch.cuda.get_device_name(device)
    if "H100" in name:
        if "PCIe" in name:
            return H100_PCIE
        if "SXM" in name or "HBM3" in name:
            return H100_SXM
    raise ValueError(f"detect_chip: no peaks known for {name!r}; pass a "
                     "ChipSpec")


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Analytic cost of one kernel invocation."""
    flops: float      # useful flops (2 per intermediate product for SpGEMM)
    bytes: float      # minimum memory traffic (read + write)


def cost_esc(expansion: int, nnz_a: int, nnz_b: int, nnz_c: int,
             value_bytes: int = 4, index_bytes: int = 4) -> KernelCost:
    """ESC pipeline: reads A, B once; the expanded (key, value) stream is
    written + re-read by the sort passes. Modeled with the minimum: one
    materialization + one sort pass + output write (real bitonic sorts do
    log2 n passes — the roofline reports distance to THIS floor, which is
    what a perfect single-pass kernel could hit)."""
    entry = value_bytes + index_bytes
    read_inputs = (nnz_a + nnz_b) * entry
    stream = expansion * entry * 2 * 2          # write+read, expand & sort
    out = nnz_c * entry
    return KernelCost(flops=2.0 * expansion,
                      bytes=read_inputs + stream + out)


def cost_dense(m: int, k: int, n: int, value_bytes: int = 4) -> KernelCost:
    return KernelCost(flops=2.0 * m * k * n,
                      bytes=(m * k + k * n + m * n) * value_bytes)


def cost_dense_row(m: int, k_width: int, n: int, nnz_a: int,
                   value_bytes: int = 4) -> KernelCost:
    """Dense-row accumulator: every A entry pulls one aligned 8-row group
    of B (8n values) and writes C once."""
    return KernelCost(flops=2.0 * nnz_a * n,
                      bytes=(nnz_a * 8 * n + m * n) * value_bytes)


def cost_dia(m: int, nd_a: int, nd_b: int, nd_c: int,
             value_bytes: int = 4) -> KernelCost:
    """Minimum traffic: read both diagonal tables once, write C's once
    (the scan re-reads C per pair; this is the perfect-cache floor)."""
    return KernelCost(flops=2.0 * m * nd_a * nd_b,
                      bytes=m * (nd_a + nd_b + nd_c) * value_bytes)


def cost_bitonic(m: int, width: int, nnz_a: int,
                 value_bytes: int = 4, index_bytes: int = 4) -> KernelCost:
    """Row-local bitonic SpGEMM: the expand gather reads one packed B run
    per A entry and writes the (m, width) product buffer; the sort kernel
    reads it once, sorts on chip, writes the (m, width) ELL result."""
    entry = value_bytes + index_bytes
    buf = m * width * entry
    return KernelCost(flops=2.0 * m * width,
                      bytes=nnz_a * entry + buf * 3)


def cost_multiclass(class_rows, nnz_a: int, nnz_c: int,
                    value_bytes: int = 4,
                    index_bytes: int = 4) -> KernelCost:
    """Width-class bitonic SpGEMM (ops/bitonic.py multiclass): same 3-pass
    product-buffer structure as cost_bitonic but each class row pays its
    OWN pow2 width, plus the nnz-scaled BlockCSR output gather.

    class_rows: iterable of (row_count, width) pairs from the plan."""
    entry = value_bytes + index_bytes
    buf = sum(c * w for c, w in class_rows) * entry
    flops = 2.0 * sum(c * w for c, w in class_rows)
    out = nnz_c * entry * 2            # class blocks written + gathered out
    return KernelCost(flops=flops,
                      bytes=nnz_a * entry + buf * 3 + out)


def cost_ell(m: int, ka: int, kb: int, kc: int,
             value_bytes: int = 4, index_bytes: int = 4) -> KernelCost:
    entry = value_bytes + index_bytes
    expanded = m * ka * kb
    return KernelCost(flops=2.0 * expanded,
                      bytes=(m * (ka + kb) + expanded * 2 * 2
                             + m * kc) * entry)


def analyze(time_ms: float, cost: KernelCost,
            chip: Optional[ChipSpec] = None,
            dtype_peak: str = "f32") -> Dict:
    """Measured time + cost model -> roofline position (chip: the
    current card's, detect_chip())."""
    chip = chip or detect_chip()
    secs = time_ms / 1e3
    achieved_gflops = cost.flops / secs / 1e9 if secs > 0 else 0.0
    achieved_gbs = cost.bytes / secs / 1e9 if secs > 0 else 0.0
    peak_gflops = (chip.peak_bf16_gflops if dtype_peak == "bf16"
                   else chip.peak_f32_gflops)
    intensity = cost.flops / cost.bytes if cost.bytes else 0.0
    ridge = peak_gflops / chip.hbm_gbs
    bound = "memory" if intensity < ridge else "compute"
    # speed-of-light time for this cost model
    sol_ms = max(cost.bytes / (chip.hbm_gbs * 1e9),
                 cost.flops / (peak_gflops * 1e9)) * 1e3
    return {
        "chip": chip.name,
        "time_ms": time_ms,
        "achieved_gflops": round(achieved_gflops, 3),
        "achieved_gbs": round(achieved_gbs, 3),
        "pct_hbm_peak": round(100.0 * achieved_gbs / chip.hbm_gbs, 2),
        "pct_compute_peak": round(100.0 * achieved_gflops / peak_gflops, 4),
        "arithmetic_intensity": round(intensity, 4),
        "bound": bound,
        "speed_of_light_ms": round(sol_ms, 4),
        "pct_of_sol": round(100.0 * sol_ms / time_ms, 2) if time_ms else 0.0,
    }
