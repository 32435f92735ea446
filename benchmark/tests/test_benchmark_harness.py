"""The harness end to end on the CPU at tiny sizes: the result line, a
cell added by files and entries alone, faults under the timed path that
must turn ``correct`` false, the bare-directory and no-card exits."""

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import BENCH, ROOT, run_line

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("mix", ["f32-stream", "f32-sync", "f64-stream"])
@pytest.mark.parametrize("config", ["tiny_graph", "tiny_mesh"])
def test_a_tiny_cell_prints_the_contracts_last_line(tiny, bench_run, capsys,
                                                    config, mix):
    rc, line, err = run_line(bench_run, tiny, f"{config}.{mix}", capsys)
    assert rc == 0
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {"setup_s"} | ({"gflops"} if "stream" in mix
                          else {"call_ms", "call_ms_p95"})
    assert set(line["metrics"]) == want     # peak_mem_gib: the card only
    assert line["device"]["platform"] == "cpu"
    for name, c in line["checks"].items():
        assert c["value"] is not None and c["value"] <= c["limit"], name
    # the numbers compared and their limits are stderr's last lines
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_a_traced_tiny_run_reports_per_layer_metrics(tiny, bench_run,
                                                     capsys):
    rc, line, _ = run_line(bench_run, tiny, "tiny_graph.f32-stream",
                           capsys, trace=1)
    assert rc == 0 and line["correct"] is True
    # off the card no device metric is read; the host's are
    assert set(line["metrics"]) == {"plan_s", "dispatch_ms.stream"}


def _tree_digest(folder):
    h = {}
    for p in sorted(folder.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h[str(p.relative_to(folder))] = hashlib.sha256(
                p.read_bytes()).hexdigest()
    return h


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A copy of the folder gains a configuration, a traffic mix and a
    per-layer metric as new files, and BENCHMARK.json gains entries; no
    file that was there is edited, and the new cell runs."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_digest(tmp_path / "benchmark")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = tmp_path / "benchmark"
    (new / "configs" / "small.json").write_text(json.dumps(
        {"name": "small", "family": "window_graph", "m": 500, "n": 500,
         "nnz": 4000, "structure_seed": 3, "stub_cv": 0.5, "stub_max": 12,
         "window": 40}))
    (new / "traffic" / "f32-stream2.json").write_text(json.dumps(
        {"loop": "stream", "dtype": "float32", "in_flight": 2,
         "control_dtype": "bfloat16",
         "limits": {"nnz_gap": 0, "pattern_gap": 0, "max_rel_err": 1e-5}}))
    (new / "metrics" / "issued.py").write_text(
        "def read(run):\n    return run.loop['issued']\n")
    bench["configs"].append({"name": "small", "source": "test",
                             "file": "benchmark/configs/small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "small.f32-stream2",
                               "config": "small", "traffic": "f32-stream2",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "issued", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry and host issue",
                               "moves": "setup_s",
                               "workloads": ["small.f32-stream2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run; "
            "sys.exit(run.main(sys.argv[1:], device='cpu'))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code, "--workload", "small.f32-stream2",
         "--seed", "5", "--seconds", "0.3", "--trace", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["issued"]["value"] >= 1
    after = _tree_digest(new)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        "configs/small.json", "traffic/f32-stream2.json", "metrics/issued.py"}


def _broken(kind):
    """wrap_call that puts a faulty product in the planned call's place:
    a CSR made from the sound result, or the sound BlockCSR with its raw
    arrays altered where the tiled route writes them."""
    from ia_spgemm_tpu_torch.formats.types import CSR

    def wrap(call, A):
        sound = call()
        if kind.startswith("block_"):
            return _broken_block(kind, sound)
        good = sound.to_scipy().tocsr()
        good.sort_indices()
        if kind == "state_unchanged":       # the input handed back
            bad = A.to_scipy()
        elif kind == "half_the_rows":       # half of the batch left out
            keep = np.arange(good.shape[0]) < good.shape[0] // 2
            bad = sp.diags(keep.astype(float)) @ good
        elif kind == "value_altered":       # an answer altered
            bad = good.copy()
            bad.data[len(bad.data) // 2] *= 1.01
        elif kind == "entry_dropped":
            bad = good.tolil()
            r = int(np.argmax(np.diff(good.indptr)))
            bad[r, good.indices[good.indptr[r]]] = 0
            bad = bad.tocsr()
            bad.eliminate_zeros()
        else:
            raise ValueError(kind)
        out = CSR.from_scipy(bad.astype(good.dtype), device="cpu")
        return lambda: out
    return wrap


def _broken_block(kind, sound):
    """The sound BlockCSR of the tiny product with one fault planted in
    its raw arrays; each fault is one that the result's own to_scipy()
    (a COO converted to CSR: rows sorted, repeats summed, valid slots
    told by column >= 0) hides."""
    bad = dataclasses.replace(sound, col_blocks=sound.col_blocks.clone(),
                              val_blocks=sound.val_blocks.clone(),
                              nnz_row=sound.nnz_row.clone())
    nnz_row = bad.nnz_row.numpy()
    r = int(np.argmax(nnz_row))             # the longest row
    s0 = int(bad.blk_ptr[r]) * 128
    col = bad.col_blocks.view(-1)
    val = bad.val_blocks.view(-1)
    if kind == "block_unsorted":            # two columns swapped
        col[[s0, s0 + 1]] = col[[s0 + 1, s0]]
        val[[s0, s0 + 1]] = val[[s0 + 1, s0]]
    elif kind == "block_repeated":          # an entry split in two
        # the row's first entry halved, its other half in the row's
        # first padding slot under the same column
        n = int(nnz_row[r])
        assert n % 128, "the longest row fills its span"
        col[s0 + n] = col[s0]
        val[s0 + n] = val[s0] / 2
        val[s0] = val[s0] / 2
        bad.nnz_row[r] = n + 1
    elif kind == "block_nnz_row":           # a row claims one entry less
        bad.nnz_row[r] = int(nnz_row[r]) - 1
    else:
        raise ValueError(kind)
    return lambda: bad


@pytest.mark.parametrize("kind", ["state_unchanged", "half_the_rows",
                                  "value_altered", "entry_dropped"])
@pytest.mark.parametrize("mix", ["f32-stream", "f32-sync", "f64-stream"])
def test_a_fault_under_the_timed_path_turns_correct_false(
        tiny, bench_run, capsys, kind, mix):
    rc, line, _ = run_line(bench_run, tiny, f"tiny_graph.{mix}",
                           capsys, wrap_call=_broken(kind))
    assert rc == 0
    assert line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("kind", ["block_unsorted", "block_repeated",
                                  "block_nnz_row"])
def test_a_fault_the_results_own_reader_hides_turns_correct_false(
        tiny, bench_run, capsys, kind):
    import torch
    from benchlib import inputs, spec
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.ops import esc
    # the fault is one that to_scipy() does not show
    cfg = json.loads((tiny / "benchmark/configs/tiny_graph.json")
                     .read_text())
    fam = spec.load_module(BENCH / "inputs" / f"{cfg['family']}.py", "f")
    a = inputs.generate(fam, cfg, 1).astype(np.float32)
    A = CSR.from_scipy(a, device="cpu")
    sound = esc.plan_csr_auto(A, A)[1]()
    assert type(sound).__name__ == "BlockCSR"
    bad = _broken_block(kind, sound)()
    if kind != "block_nnz_row":
        torch.testing.assert_close(
            torch.as_tensor(bad.to_scipy().toarray()),
            torch.as_tensor(sound.to_scipy().toarray()))
    rc, line, _ = run_line(bench_run, tiny, "tiny_graph.f32-stream",
                           capsys, wrap_call=_broken(kind))
    assert rc == 0
    assert line["correct"] is False and line["failed"] >= 1
    assert line["checks"]["pattern_gap"]["value"] > 0 or \
        line["checks"]["nnz_gap"]["value"] > 0


def test_a_forbidden_module_loaded_after_the_window_stops_the_result(
        tiny, bench_run, capsys, monkeypatch):
    """The guard looks just before the line is printed, so a module of
    JAX loaded by anything after the window (here the reference) stops
    the result: exit 3 and no result line."""
    square = bench_run.reference.square

    def loads_jax(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return square(*args, **kwargs)
    monkeypatch.setattr(bench_run.reference, "square", loads_jax)
    rc, line, err = run_line(bench_run, tiny, "tiny_graph.f32-stream",
                             capsys)
    assert rc == 3
    assert line is None or "correct" not in line
    assert "jax" in err.strip().splitlines()[-1]
