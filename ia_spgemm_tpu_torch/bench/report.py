"""Structured reporting, the reference's printf block (main.cpp:981-1000)
as a table + JSON (PyTorch port of ia_spgemm_tpu.bench.report)."""

from __future__ import annotations

import dataclasses
import json

from ia_spgemm_tpu_torch.bench.harness import BenchReport

_HDR = ("Algorithm", "run_time(ms)", "trans_time(ms)", "memory(B)",
        "verified_sum", "Gflops", "Speedup", "status")


def format_table(report: BenchReport) -> str:
    lines = []
    lines.append("-" * 42)
    lines.append(f"A: {report.matrix_a} {report.shape_a} nnz={report.nnz_a}")
    lines.append(f"B: {report.matrix_b} {report.shape_b} nnz={report.nnz_b}")
    lines.append(f"intermediate products (GetFlop): {report.flops}")
    lines.append("-" * 42)
    lines.append("  ".join(f"{h:>14}" for h in _HDR))
    for r in report.results:
        status = ("ok" if r.ok else
                  "skipped" if r.skipped else
                  "timeout" if r.timed_out else
                  "failed")
        if r.error:
            status = "CHECKSUM!" if "checksum" in r.error else "error"
        lines.append("  ".join([
            f"{r.name:>14}",
            f"{r.run_time_ms:>14.4f}",
            f"{r.trans_time_ms:>14.4f}",
            f"{r.memory_bytes:>14.0f}",
            f"{r.verified_sum:>14.6g}",
            f"{r.gflops:>14.4f}",
            f"{r.speedup:>14.3f}",
            f"{status:>14}",
        ]))
        if r.error:
            lines.append(f"    ! {r.error}")
    lines.append("-" * 42)
    if report.winner:
        lines.append(f"Fastest algorithm: {report.winner}")
    if report.matnet_pick:
        # the reference's verdict line (main.cpp:994-999)
        verdict = ("Congratulate! MatNet Correct Prediction."
                   if report.matnet_correct
                   else "MatNet Incorrect Prediction.")
        lines.append(f"MatNet pick: {report.matnet_pick} — {verdict}")
    return "\n".join(lines)


def to_json(report: BenchReport) -> str:
    d = dataclasses.asdict(report)
    return json.dumps(d, default=str)
