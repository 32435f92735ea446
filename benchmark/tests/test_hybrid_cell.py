"""The hybrid route's result in the benchmark: the HybridCSR reader (the
light rows' SlabCSR and the heavy rows' CSR, merged by row as stored),
a tiny web-crawl cell that the router sends to the hybrid, faults planted
in its raw arrays that must turn ``correct`` false, and the control
against the program on it."""

import dataclasses
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from benchlib import readout, reference, spec
from conftest import BENCH, run_line, tiny_root

# rows up to 1,100 entries: rows that meet the longest are heavy
TINY_WEB = {"family": "web_crawl", "m": 3000, "n": 3000, "nnz": 9000,
            "structure_seed": 0, "alpha": 1.5, "max_row": 1100,
            "site": 300, "window": 600, "nav_from": 8, "hub_share": 0.6}
CELL = "tiny_web.f32-stream"

# A = [[1,0,2,0],[0,3,0,0],[0,0,0,4],[5,0,0,6]]; A @ A by hand
A4 = sp.csr_matrix(np.array([[1, 0, 2, 0], [0, 3, 0, 0], [0, 0, 0, 4],
                             [5, 0, 0, 6]], dtype=np.float32))
C4 = np.array([[1, 0, 2, 8], [0, 9, 0, 0], [20, 0, 0, 24],
               [35, 0, 10, 36]], dtype=np.float64)


def _web_root(tmp_path):
    """tiny_root's tree with the tiny web-crawl cell added, on the f32
    stream mix, in every metric list that names a cell of that mix."""
    root = tiny_root(tmp_path, mixes=("f32-stream",))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    f = "benchmark/configs/tiny_web.json"
    (root / f).write_text(json.dumps({"name": "tiny_web", **TINY_WEB}))
    bench["configs"].append({"name": "tiny_web", "source": "tiny",
                             "file": f, "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": CELL, "config": "tiny_web",
                               "traffic": "f32-stream", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "webbase-1M.f32-stream" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _hybrid_c4():
    """C4 as a HybridCSR: rows 0-2 in one slab of 8 slots (and a second,
    padding slab), row 3 in the heavy CSR."""
    from ia_spgemm_tpu_torch.formats.types import CSR, SlabCSR
    from ia_spgemm_tpu_torch.ops.slab import HybridCSR
    keys = np.full((2, 8), -1, np.int32)
    vals = np.zeros((2, 8), np.float32)
    keys[0, :6] = [0, 2, 3, 5, 8, 11]          # (row - 0) * 4 + col
    vals[0, :6] = [1, 2, 8, 9, 20, 24]
    light = SlabCSR.from_numpy(keys, vals, [6, 0], [0, 0], 6, (4, 4),
                               device="cpu")
    heavy = CSR.from_numpy(np.array([0, 0, 0, 0, 3], np.int32),
                           np.array([0, 2, 3, 4], np.int32),
                           np.array([35, 10, 36, 0], np.float32), 3,
                           (4, 4), device="cpu")
    return HybridCSR(light=light, heavy=heavy, shape=(4, 4))


@pytest.mark.parametrize("kind", ["HybridCSR"])
def test_a_reader_gives_the_result_as_stored(kind):
    """The light part's entries in storage order with the heavy rows
    merged in: row 2's two entries stored out of order show as stored;
    a padding key other than -1, a row in both parts and a row that goes
    backwards are format faults."""
    res = _hybrid_c4()
    assert type(res).__name__ == kind
    good = sp.csr_matrix(C4)
    raw = readout.read(res)
    np.testing.assert_array_equal(raw.indptr, good.indptr)
    np.testing.assert_array_equal(raw.indices, good.indices)
    np.testing.assert_array_equal(raw.data, good.data)
    assert raw.format_gap == 0
    res.light.keys[0, [4, 5]] = torch.tensor([11, 8], dtype=torch.int32)
    res.light.values[0, [4, 5]] = torch.tensor([24.0, 20.0])
    raw = readout.read(res)
    np.testing.assert_array_equal(raw.indices, [0, 2, 3, 1, 3, 0, 0, 2, 3])
    np.testing.assert_array_equal(raw.data[4:6], [24, 20])
    assert raw.format_gap == 0
    ref = reference.square(A4.indptr, A4.indices, A4.data, A4.shape)
    assert reference.compare(raw, 9, ref)["pattern_gap"] == 1
    res = _hybrid_c4()
    res.light.keys[0, 7] = 0                   # a padding slot
    assert readout.read(res).format_gap == 1
    res = _hybrid_c4()
    res.light.keys[0, 5] = 3                   # row 2's entry in row 0
    assert readout.read(res).format_gap >= 1
    res = _hybrid_c4()
    res.light.keys[1, 0] = 13                  # row 3, in both parts
    res.light.nnz_slab[1] = 1
    assert readout.read(res).format_gap == 1


def _planted(kind):
    """wrap_call giving the sound hybrid result with one fault planted in
    its raw arrays."""
    from ia_spgemm_tpu_torch.formats.types import CSR

    def wrap(call, A):
        sound = call()
        assert type(sound).__name__ == "HybridCSR"
        light = dataclasses.replace(sound.light,
                                    keys=sound.light.keys.clone(),
                                    values=sound.light.values.clone(),
                                    nnz_slab=sound.light.nnz_slab.clone())
        bad = dataclasses.replace(sound, light=light)
        n = sound.shape[1]
        nnz_s = light.nnz_slab.numpy()
        if kind == "slab_unsorted":         # two columns of a row swapped
            keys = light.keys.numpy()
            s, t = next((s, t) for s in range(len(nnz_s))
                        for t in range(int(nnz_s[s]) - 1)
                        if keys[s, t] // n == keys[s, t + 1] // n)
            light.keys[s, [t, t + 1]] = light.keys[s, [t + 1, t]]
            light.values[s, [t, t + 1]] = light.values[s, [t + 1, t]]
        elif kind == "row_in_both":         # a light entry moved to heavy
            keys = light.keys.numpy()
            s = next(s for s in range(len(nnz_s)) if nnz_s[s] > 1
                     and keys[s, nnz_s[s] - 1] // n
                     == keys[s, nnz_s[s] - 2] // n)
            t = int(nnz_s[s]) - 1
            key = int(light.keys[s, t])
            row = int(light.slab_first_row[s]) + key // n
            h = sound.heavy.to_scipy().tolil()
            h[row, key % n] = float(light.values[s, t])
            light.keys[s, t], light.values[s, t] = -1, 0.0
            light.nnz_slab[s] -= 1
            light.nnz = light.nnz - 1
            h = h.tocsr()
            bad = dataclasses.replace(bad, heavy=CSR.from_scipy(
                h.astype(np.float32), device="cpu"))
        elif kind == "padding_key":         # a padding slot not -1
            W = light.keys.shape[1]
            s = int(np.nonzero((nnz_s > 0) & (nnz_s < W))[0][0])
            light.keys[s, int(nnz_s[s])] = 0
        else:
            raise ValueError(kind)
        if kind != "padding_key":
            # the fault is one that the result's own to_scipy() hides
            np.testing.assert_array_equal(bad.to_scipy().toarray(),
                                          sound.to_scipy().toarray())
        return lambda: bad
    return wrap


def test_the_tiny_web_cell_runs_the_hybrid_and_is_correct(tmp_path,
                                                          bench_run,
                                                          capsys):
    root = _web_root(tmp_path)
    rc, line, err = run_line(bench_run, root, CELL, capsys)
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "gflops"}   # off the card
    rc, line, _ = run_line(bench_run, root, CELL, capsys, trace=1)
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) == {"plan_s", "dispatch_ms.stream"}


@pytest.mark.parametrize("kind", ["slab_unsorted", "row_in_both",
                                  "padding_key"])
def test_a_fault_in_a_hybrid_result_turns_correct_false(tmp_path,
                                                        bench_run, capsys,
                                                        kind):
    root = _web_root(tmp_path)
    rc, line, _ = run_line(bench_run, root, CELL, capsys,
                           wrap_call=_planted(kind))
    assert rc == 0
    assert line["correct"] is False and line["failed"] >= 1
    assert line["checks"]["pattern_gap"]["value"] > 0


def test_the_control_fails_and_the_program_passes_on_the_hybrid(tmp_path):
    import control
    root = _web_root(tmp_path)
    limits = spec.load_json(BENCH / "traffic" / "f32-stream.json")["limits"]
    for _, row in control.readings(CELL, [1, 2**31 + 3], program=True,
                                   device="cpu", root=root):
        assert row["route"] == "hybrid"
        assert reference.judge(row["program"], limits), row
        assert not reference.judge(row["control"], limits), row
        assert row["control"]["pattern_gap"] == 0
