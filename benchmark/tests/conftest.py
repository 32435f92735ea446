"""Tiny cells for the benchmark's CPU tests: a copy of BENCHMARK.json with
a small configuration of each family, and the runner that drives
``run.main`` without a card."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

TINY = {"tiny_graph": {"family": "window_graph", "m": 400, "n": 400,
                       "nnz": 3000, "structure_seed": 0, "stub_cv": 0.8,
                       "stub_max": 10, "window": 30},
        "tiny_mesh": {"family": "hex_mesh", "m": 243, "n": 243,
                      "nnz": 9000, "structure_seed": 0, "grid": [3, 3, 9],
                      "dof": 3}}
def load_run():
    spec = importlib.util.spec_from_file_location("bench_run_under_test",
                                                  BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_root(tmp_path, mixes=("f32-stream", "f32-sync", "f64-stream")):
    """A root holding BENCHMARK.json with the tiny cells added (every
    metric that lists a cell of the same traffic mix lists them too) and
    their configuration files; the benchmark's own files are read from
    the repository."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix_of = {w["name"]: w["traffic"] for w in bench["workloads"]}
    (tmp_path / "benchmark" / "configs").mkdir(parents=True)
    for name, cfg in TINY.items():
        f = f"benchmark/configs/{name}.json"
        (tmp_path / f).write_text(json.dumps({"name": name, **cfg}))
        bench["configs"].append({"name": name, "source": "tiny", "file": f,
                                 "reduced": [], "why": "CPU test"})
        for mix in mixes:
            for m in bench["end_to_end"] + bench["per_layer"]:
                if any(mix_of.get(w) == mix
                       for w in m.get("workloads", ())):
                    m["workloads"].append(f"{name}.{mix}")
    for name in TINY:
        for mix in mixes:
            bench["workloads"].append({"name": f"{name}.{mix}",
                                       "config": name, "traffic": mix,
                                       "chips": 1, "why": "CPU test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)


@pytest.fixture(scope="module")
def bench_run():
    return load_run()


def run_line(bench_run, root, workload, capsys, seed=2**31 + 7,
             trace=0, wrap_call=None):
    """(rc, the last stdout line as JSON or None, stderr) of one CPU run."""
    rc = bench_run.main(["--workload", workload, "--seed", str(seed),
                         "--seconds", "0.3", "--trace", str(trace)],
                        device="cpu", root=root, wrap_call=wrap_call)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    try:
        last = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        last = None
    return rc, last, err
