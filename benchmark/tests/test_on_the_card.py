"""The benchmark on the card: a short run of each cell, and the control
at a cell's own size. Marked ``cuda``; each test looks for a card itself
and skips without one. Run on the card machine:

    python -m pytest benchmark/tests -m cuda -o addopts="" -q
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _cells():
    return [w["name"] for w in
            json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_of_the_cell_is_correct(workload, trace):
    _need_card()
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "3000000017", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"] or trace


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_the_control_fails_at_the_cells_size(workload):
    _need_card()
    import control
    from benchlib import reference, spec
    cell = spec.Cell(workload, ROOT)
    for _, row in control.readings(workload, [11], device="cuda"):
        assert not reference.judge(row["control"], cell.traffic["limits"])
