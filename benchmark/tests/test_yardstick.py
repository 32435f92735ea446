"""The benchmark's own arithmetic: the roofline's bytes and flops, the
import guard, the trace reductions, the reference's comparison, and
BENCHMARK.json against the folder it names."""

import json
import re
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp

from benchlib import guard, inputs, peaks, readout, reference, spec, trace
from conftest import BENCH, ROOT

# A = [[1,0,2,0],[0,3,0,0],[0,0,0,4],[5,0,0,6]]; by hand, A @ A =
# [[1,0,2,8],[0,9,0,0],[20,0,0,24],[35,0,10,36]]: 10 products, 9 entries
A4 = sp.csr_matrix(np.array([[1, 0, 2, 0], [0, 3, 0, 0], [0, 0, 0, 4],
                             [5, 0, 0, 6]], dtype=np.float32))
C4 = np.array([[1, 0, 2, 8], [0, 9, 0, 0], [20, 0, 0, 24],
               [35, 0, 10, 36]], dtype=np.float64)


@pytest.mark.parametrize("dtype,nbytes", [(np.float32, 68 + 68 + 92),
                                          (np.float64, 92 + 92 + 128)])
def test_roofline_counts_the_inputs_and_the_output_once(dtype, nbytes):
    a = A4.astype(dtype)
    ref = reference.square(a.indptr, a.indices, a.data, a.shape)
    products = inputs.products(a.indptr, a.indices, a.indptr)
    assert (products, ref.nnz) == (10, 9)
    # (rows + 1) int32 pointers, then an int32 column and a value an entry
    got = peaks.least_work(4, a.nnz, 4, a.nnz, 4, ref.nnz, products,
                           a.dtype.itemsize)
    assert got == (nbytes, 20)
    assert peaks.chip("NVIDIA H100 80GB HBM3") == "h100_sxm"
    assert peaks.chip("NVIDIA A100-SXM4-80GB") is None
    t, bound = peaks.least_seconds(*got, peaks.PEAKS["h100_sxm"],
                                   np.dtype(dtype).name)
    assert bound == "bytes" and t == pytest.approx(nbytes / 3.35e12)


def test_the_roofline_share_is_the_least_time_over_busy_per_product():
    read = spec.load_module(BENCH / "metrics" / "roofline_pct.py", "t").read
    run = SimpleNamespace(least_s=1e-3, trace={"busy_us": 8000.0,
                                               "products": 2})
    assert read(run) == pytest.approx(25.0)
    assert read(SimpleNamespace(least_s=None, trace=run.trace)) is None


def test_a_waiting_callers_time_is_the_median_call():
    read = spec.load_module(BENCH / "metrics" / "call_ms.py", "t").read
    loop = {"latencies_s": [0.003, 0.001, 0.002, 0.050], "completed": 4,
            "window_s": 0.056}
    # the median of the calls, not the window over the calls (14 ms)
    assert read(SimpleNamespace(loop=loop)) == pytest.approx(2.5)
    assert read(SimpleNamespace(loop={"completed": 4})) is None


def test_the_reference_of_the_hand_product():
    ref = reference.square(A4.indptr, A4.indices, A4.data, A4.shape)
    np.testing.assert_array_equal(sp.csr_matrix(
        (ref.value, ref.indices, ref.indptr), shape=(4, 4)).toarray(), C4)
    good = sp.csr_matrix(C4)
    raw = readout.Raw((4, 4), good.indptr, good.indices, good.data)
    assert reference.compare(raw, 9, ref) == {
        "nnz_gap": 0, "pattern_gap": 0, "max_rel_err": 0.0}


def test_the_structural_pattern_keeps_an_entry_whose_sum_cancels():
    a = sp.csr_matrix(np.array([[1.0, 1.0], [1.0, -1.0]]))
    ref = reference.square(a.indptr, a.indices, a.data, a.shape)
    assert ref.nnz == 4          # (0, 1) = 1 - 1 = 0 stays an entry
    np.testing.assert_array_equal(ref.value, [2.0, 0.0, 0.0, 2.0])


@pytest.mark.parametrize("fault,field", [
    ("unsorted", "pattern_gap"), ("repeated", "pattern_gap"),
    ("missing", "pattern_gap"), ("reported", "nnz_gap"),
    ("value", "max_rel_err")])
def test_the_comparison_sees_each_fault(fault, field):
    ref = reference.square(A4.indptr, A4.indices, A4.data, A4.shape)
    good = sp.csr_matrix(C4)
    ip, ix, v, nnz = good.indptr.copy(), good.indices.copy(), \
        good.data.copy(), 9
    if fault == "unsorted":
        ix[[0, 1]] = ix[[1, 0]]
        v[[0, 1]] = v[[1, 0]]
    elif fault == "repeated":
        ix[1] = ix[0]
    elif fault == "missing":
        ip, ix, v = ip.copy(), np.delete(ix, 0), np.delete(v, 0)
        ip[1:] -= 1
    elif fault == "reported":
        nnz = 10
    else:
        v[4] *= 1.001
    nums = reference.compare(readout.Raw((4, 4), ip, ix, v), nnz, ref)
    limits = {"nnz_gap": 0, "pattern_gap": 0, "max_rel_err": 1e-5}
    assert nums[field] is None or nums[field] > limits[field] or \
        field == "max_rel_err" and nums["pattern_gap"] > 0
    assert not reference.judge(nums, limits)


@pytest.mark.parametrize("kind", ["BlockCSR", "CSR"])
def test_a_reader_gives_the_result_as_stored(kind):
    """Each result type's reader gives its entries in storage order,
    nothing sorted or summed, and counts a broken padding slot."""
    import torch
    from ia_spgemm_tpu_torch.formats import types
    good = sp.csr_matrix(C4.astype(np.float32))
    res = getattr(types, kind).from_scipy(good, device="cpu")
    # row 3's last two entries stored out of order, as a faulty producer
    # would leave them (from_scipy itself sorts)
    ix, v = good.indices.copy(), good.data.copy()
    ix[[-1, -2]] = ix[[-2, -1]]
    v[[-1, -2]] = v[[-2, -1]]
    at = [7, 8] if kind == "CSR" else [3 * 128 + 1, 3 * 128 + 2]
    cols = res.col_ind if kind == "CSR" else res.col_blocks.view(-1)
    vals = res.values if kind == "CSR" else res.val_blocks.view(-1)
    cols[at] = torch.as_tensor(ix[-2:], dtype=torch.int32)
    vals[at] = torch.as_tensor(v[-2:])
    raw = readout.read(res)
    np.testing.assert_array_equal(raw.indptr, good.indptr)
    np.testing.assert_array_equal(raw.indices, ix)
    np.testing.assert_array_equal(raw.data, v)
    assert raw.format_gap == 0
    ref = reference.square(A4.indptr, A4.indices, A4.data, A4.shape)
    assert reference.compare(raw, 9, ref)["pattern_gap"] == 1
    if kind == "BlockCSR":
        res.col_blocks.view(-1)[5] = 0     # row 0's padding
        assert readout.read(res).format_gap == 1
    with pytest.raises(TypeError):
        readout.read(good)


def test_the_import_guard_compares_whole_top_level_names():
    assert guard.forbidden(["ia_spgemm_tpu_torch", "ia_spgemm_tpu_torch.ops",
                            "jaxtyping", "flaxen", "numpy"]) == []
    assert guard.forbidden(["ia_spgemm_tpu.ops.esc", "jax.numpy", "jaxlib",
                            "flax.linen", "ia_spgemm_tpu_torch"]) == [
        "flax", "ia_spgemm_tpu", "jax", "jaxlib"]


def test_busy_is_the_union_of_device_activity():
    ev = [("void k1_expand_sort_compress<4>(...)", 0, 10),
          ("copy", 5, 20), ("k4_sort_compress_rows", 30, 40),
          ("cat", 50, 55)]
    s = trace.summarize(ev)
    assert (s["busy_us"], s["window_us"]) == (35, 55)
    assert (s["kernel_us"], s["other_us"]) == (20, 20)
    assert trace.top(s["by_name"], 0.5, n=1) == [["copy", 7.5]]


def test_idle_gaps_are_labelled_by_the_open_span_and_host_event():
    dev = [("a", 0, 10), ("b", 20, 30), ("c", 30, 40), ("d", 60, 70)]
    host = [("bench.issue", 0, 45), ("aten::index", 12, 18),
            ("cudaLaunchKernel", 18, 19), ("bench.wait", 45, 70),
            ("cudaEventSynchronize", 46, 69), ("bench.issue", 70, 80)]
    assert trace.idle_gaps(dev, host) == {
        "bench.issue / aten::index": 10.0,
        "bench.wait / cudaEventSynchronize": 20.0}
    # a gap with no host event inside the span is labelled by the span
    assert trace.idle_gaps([("a", 0, 1), ("b", 3, 4)],
                           [("bench.nnz", 0, 5)]) == {"bench.nnz": 2.0}


def test_the_benchmark_json_names_only_what_the_folder_holds():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert name.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        cell = spec.Cell(w["name"], ROOT)
        assert (BENCH / "loops" / f"{cell.traffic['loop']}.py").is_file()
        assert (BENCH / "inputs" / f"{cell.config['family']}.py").is_file()
        shown = [m["name"] for m in cell.metrics(False)]
        assert "setup_s" in shown and len(shown) >= 2
        assert cell.metrics(True)
    for m in bench["per_layer"]:
        for c in m.get("workloads", cells):
            assert cells[c] and spec.Cell(c, ROOT).applies(e2e[m["moves"]])
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in bench["workloads"])
