"""The port's spans and counters (``ia_spgemm_tpu_torch/tracing.py``):
what a tiled call records with tracing off, under a profiler window and
inside ``tracing.enable()``; self time; the plan-constant slot counters;
the launch and plan-cache counters behind their old views; the
benchmark's four readers of them on a tiny cell (in a process of its
own: the benchmark refuses to report beside a loaded JAX); and, on the
card, the leaf spans' stream ms against CUDA events around the call.

    python -m pytest tests/test_torch_tracing.py -q
    python -m pytest tests/test_torch_tracing.py --noconftest \\
        -o addopts="" -m cuda -q          # on the card
"""

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ia_spgemm_tpu_torch import tracing
from ia_spgemm_tpu_torch.formats import convert
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.ops import bitonic
from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
from ia_spgemm_tpu_torch.ops import dense_row_kernels as DK
from ia_spgemm_tpu_torch.ops import esc
from ia_spgemm_tpu_torch.ops import hash_kernels as HK
from ia_spgemm_tpu_torch.ops import slab_kernels as SK
from ia_spgemm_tpu_torch.parallel import rdma_ring as RR

ROOT = Path(__file__).resolve().parent.parent
LEAVES = ("tiled.expand.", "tiled.sort.", "tiled.assemble", "tiled.result")


def _matrix(m=160, seed=0, dtype=np.float32):
    """Rows of 2-8 entries and a quarter of 64: C = A @ A falls into
    classes 128-2048 (ragged) or 128-4096 (chunked), so the K1, K2 + K3
    and K4 paths all run."""
    rng = np.random.default_rng(seed)
    lens = np.where(rng.random(m) < 0.25, 64, rng.integers(2, 9, m))
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.size)
    a = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(m, m)).tocsr()
    a.sum_duplicates()
    return a.astype(dtype)


def _tiled(a, device="cpu"):
    A = CSR.from_scipy(a, device=device)
    call = esc.plan_csr_tiled(A, A)
    assert call is not None
    return call


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    bitonic.clear_plan_cache()
    yield
    tracing.reset()


def _leaf_names(spans):
    return [n for n in spans if n.startswith(LEAVES)]


def test_an_untraced_call_records_no_span_and_opens_no_range(monkeypatch):
    call = _tiled(_matrix())
    opened = []
    real = torch.profiler.record_function

    def counting(*args, **kw):
        opened.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not tracing.active()
    for _ in range(2):
        call()
    snap = tracing.snapshot()
    assert snap["spans"] == {} and opened == []
    # the counters are always on
    assert snap["counters"]["tiled.calls"] == 2
    assert snap["counters"]["tiled.sort_slots"] == 2 * call.sort_slots
    # inside enable() the same call records its spans, and opens a range
    # per span only where a profiler window would record it
    from torch.profiler import ProfilerActivity, profile
    with tracing.enable():
        call()
    spans = tracing.snapshot()["spans"]
    assert opened == [] and sum(s["calls"] for s in spans.values()) > 0
    tracing.reset()
    with tracing.enable(), profile(activities=[ProfilerActivity.CPU]):
        call()
    spans = tracing.snapshot()["spans"]
    assert len(opened) == sum(s["calls"] for s in spans.values()) > 0


def test_a_profiler_window_records_the_calls_spans_nested_in_the_caller():
    from torch.profiler import ProfilerActivity, profile, record_function
    a = _matrix()
    call = _tiled(a)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.active()
        with record_function("caller"):
            C = call()
    assert not tracing.active()
    assert abs(C.to_scipy() - a @ a).max() < 1e-4
    ev = {}
    for e in prof.events():
        ev.setdefault(e.name, []).append(e)
    w = call.widths
    want = ({"tiled.call", "tiled.assemble", "tiled.result"}
            | {f"tiled.sort.w{x}" for x in w}
            | {f"tiled.expand.w{x}" for x in w})
    assert want <= set(ev), sorted(set(ev))
    caller = ev["caller"][0]
    top = ev["tiled.call"][0]
    for name in want:
        (e,) = ev[name]
        # on the loop's thread, inside the caller's range and the call's
        assert e.thread == caller.thread
        assert caller.time_range.start <= e.time_range.start
        assert e.time_range.end <= caller.time_range.end
        assert top.time_range.start <= e.time_range.start
        assert e.time_range.end <= top.time_range.end
    # the table holds the same spans, once each, with the call's number
    spans = tracing.snapshot()["spans"]
    assert set(spans) == want
    assert all(s["calls"] == 1 for s in spans.values())
    assert tracing.counter("tiled.calls") == 1


def test_a_card_under_a_profiler_alone_times_one_call_in_time_every():
    from torch.profiler import ProfilerActivity, profile
    assert tracing.tracer() is None
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.tracer()
        assert not tracing.tracer().clock.timed
        time.sleep(tracing.TIME_EVERY_NS * 1.2e-9)
        assert [tracing.tracer().clock.timed for _ in range(3)] == [
            True, False, False]
        # inside enable() every call is timed
        with tracing.enable():
            assert all(tracing.tracer().clock.timed for _ in range(3))
    # off a card a call untimed on the stream is still timed by the host
    call = _tiled(_matrix())
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            call()
    s = tracing.snapshot()["spans"]
    assert all(row["timed"] == row["calls"] == 3 for row in s.values())


def test_the_span_readers_average_the_timed_calls(monkeypatch):
    """expand_ms / assemble_ms: a leaf's stream ms over its timed calls,
    times its calls, over the tiled calls."""
    import importlib.util
    spans = {"tiled.call": dict(calls=8, timed=2, stream_ms=9.0),
             "tiled.expand.w128": dict(calls=8, timed=2, stream_ms=1.0),
             "tiled.expand.w256": dict(calls=16, timed=4, stream_ms=6.0),
             "tiled.assemble": dict(calls=8, timed=2, stream_ms=3.0)}
    monkeypatch.setattr(tracing, "snapshot",
                        lambda: {"spans": spans, "counters": {}})
    got = {}
    for name in ("expand_ms", "assemble_ms"):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "benchmark" / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        got[name] = mod.read(SimpleNamespace(trace={"products": 1}))
    assert got["expand_ms"] == pytest.approx((0.5 + 1.5 * 2) / 1)
    assert got["assemble_ms"] == pytest.approx(1.5)


def test_self_time_is_duration_less_children():
    with tracing.enable():
        with tracing.span("outer"):
            time.sleep(0.004)
            for _ in range(2):
                with tracing.span("inner"):
                    time.sleep(0.002)
                    with tracing.span("leaf"):
                        time.sleep(0.001)
    s = tracing.snapshot()["spans"]
    assert s["outer"]["calls"] == 1 and s["inner"]["calls"] == 2
    assert s["outer"]["self_ns"] == (s["outer"]["host_ns"]
                                     - s["inner"]["host_ns"])
    assert s["inner"]["self_ns"] == (s["inner"]["host_ns"]
                                     - s["leaf"]["host_ns"])
    assert s["leaf"]["self_ns"] == s["leaf"]["host_ns"] >= 2e6
    assert s["outer"]["self_ns"] >= 4e6
    # off a card stream ms is host ms
    for row in s.values():
        assert row["timed"] == row["calls"]
        assert row["stream_ms"] == pytest.approx(row["host_ns"] * 1e-6)
    # a tiled call: the same rule, at every level
    call = _tiled(_matrix())
    tracing.reset()
    with tracing.enable():
        call()
    s = tracing.snapshot()["spans"]
    top = s["tiled.call"]
    assert top["self_ns"] == top["host_ns"] - sum(
        s[n]["host_ns"] for n in _leaf_names(s))


@pytest.mark.parametrize("opts", [
    dict(assemble="bcsr"),
    dict(assemble="bcsr", pregather=True),
    dict(assemble="bcsr", plan_device=True),
    dict(assemble="bcsr", layout="chunked"),
    dict(assemble="ell"),
    dict(assemble="ell", layout="chunked", dtype=np.float64),
], ids=["ragged", "pregather", "plan_device", "chunked", "ell",
        "f64_chunked"])
def test_the_slot_counters_are_the_plans_constants(opts):
    opts = dict(opts)
    a = _matrix(dtype=opts.pop("dtype", np.float32))
    A = convert.csr_to_ell(CSR.from_scipy(a, device="cpu"),
                           check_guard=False)
    call = bitonic.multiclass_planned(A, A, **opts)
    assert call is not None
    sort_slots = sum(n * w for n, w in zip(call.counts, call.widths))
    if call.assemble == "bcsr":
        out_slots = int(call.blk_ptr[-1]) * 128
    else:
        out_slots = A.nrows * call.out_w
    assert (call.sort_slots, call.out_slots) == (sort_slots, out_slots)
    before = tracing.snapshot()["counters"]
    assert "tiled.calls" not in before
    with tracing.enable():
        C = call()
    C = call()
    got = C.to_scipy() if hasattr(C, "to_scipy") else None
    if got is not None:
        tol = 1e-10 if a.dtype == np.float64 else 1e-4
        assert abs(got - a @ a).max() < tol
    c = tracing.snapshot()["counters"]
    assert c["tiled.calls"] == 2
    assert c["tiled.sort_slots"] == 2 * sort_slots
    assert c["tiled.out_slots"] == 2 * out_slots
    # every class opened its expand and sort spans, and the leaves lie
    # in the call
    spans = tracing.snapshot()["spans"]
    assert {f"tiled.{leaf}.w{w}" for w in call.widths
            for leaf in ("expand", "sort")} <= set(spans)
    assert spans["tiled.call"]["calls"] == 1


def test_launch_counts_and_plan_cache_stats_keep_their_dicts():
    mods = (K, SK, DK, HK, RR)
    for mod in mods:
        assert mod.launch_counts() == {k: 0 for k in mod.KERNELS}
    # a launch is the counter launch.<K>; each module's view and reset
    # cover its own kernels only
    tracing.count("launch.K1", 3)
    tracing.count("launch.K8")
    tracing.count("launch.K13", 2)
    assert K.launch_counts()["K1"] == 3 and SK.launch_counts()["K8"] == 1
    assert RR.launch_counts() == {"K13": 2}
    K.reset_launch_counts()
    assert K.launch_counts()["K1"] == 0 and SK.launch_counts()["K8"] == 1
    assert RR.launch_counts() == {"K13": 2}
    assert not any(hasattr(fn, "launches")
                   for mod in mods for fn in mod.KERNELS.values())
    # the plan cache: hits and misses as before, zeroed by clear alone
    A = convert.csr_to_ell(CSR.from_scipy(_matrix(), device="cpu"),
                           check_guard=False)
    assert bitonic.plan_cache_stats() == {"hits": 0, "misses": 0}
    bitonic.multiclass_planned(A, A)
    bitonic.multiclass_planned(A, A)
    assert bitonic.plan_cache_stats() == {"hits": 1, "misses": 1}
    c = tracing.snapshot()["counters"]
    assert (c["plan_cache.hits"], c["plan_cache.misses"]) == (1, 1)
    bitonic.clear_plan_cache()
    assert bitonic.plan_cache_stats() == {"hits": 0, "misses": 0}
    assert RR.launch_counts() == {"K13": 2}


def test_the_snapshot_survives_clear_plan_cache():
    call = _tiled(_matrix())
    with tracing.enable():
        call()
    tracing.count("launch.K4")
    before = tracing.snapshot()
    bitonic.clear_plan_cache()
    after = tracing.snapshot()
    assert after["spans"] == before["spans"] and after["spans"]
    drop = ("plan_cache.hits", "plan_cache.misses")
    assert after["counters"] == {k: v for k, v in before["counters"].items()
                                 if k not in drop}
    assert after["counters"]["tiled.calls"] == 1


def test_the_planner_spans_nest_under_plan():
    a = _matrix()
    A = CSR.from_scipy(a, device="cpu")
    with tracing.enable():
        route, call = esc.plan_csr_auto(A, A)
    assert route == "tiled"
    s = tracing.snapshot()["spans"]
    stages = ("plan.route", "plan.ell", "plan.classes", "plan.table",
              "plan.fragments", "plan.assembly_map")
    assert set(s) == {"plan", *stages}
    assert all(s[n]["calls"] == 1 for n in s)
    assert s["plan"]["self_ns"] == s["plan"]["host_ns"] - sum(
        s[n]["host_ns"] for n in stages)


# the tiny cells of the benchmark's own tests, run through benchmark/run.py
# with the port's plain versions; prints the result lines, the snapshot
# after each run and the four readers on a stand-in for a card's run
_BENCH_SCRIPT = r"""
import importlib.util, json, sys, tempfile
from pathlib import Path
from types import SimpleNamespace
root = Path(sys.argv[1])
spec = importlib.util.spec_from_file_location(
    "bench_conftest", root / "benchmark" / "tests" / "conftest.py")
conf = importlib.util.module_from_spec(spec)
spec.loader.exec_module(conf)
from ia_spgemm_tpu_torch import tracing
tiny = conf.tiny_root(Path(tempfile.mkdtemp()), mixes=("f32-stream",))
run = conf.load_run()
from benchlib import spec as bspec
cell = bspec.Cell("tiny_graph.f32-stream", tiny)
names = ("expand_ms", "assemble_ms", "sort_slots_per_product",
         "out_slots_per_product")
readers = {n: cell.reader(n) for n in names}
out = {}
for trace in (0, 1):
    rc = run.main(["--workload", "tiny_graph.f32-stream", "--seed",
                   str(2**31 + 7), "--seconds", "0.3", "--trace",
                   str(trace)], device="cpu", root=tiny)
    snap = tracing.snapshot()
    stand_in = SimpleNamespace(trace={"products": 1}, products=1000)
    out[trace] = {"rc": rc, "snapshot": snap,
                  "on_a_card": {n: r.read(stand_in)
                                for n, r in readers.items()},
                  "off_the_card": {n: r.read(SimpleNamespace(
                      trace=None, products=1000))
                      for n, r in readers.items()}}
print("RESULT " + json.dumps(out))
"""


def test_the_benchmarks_readers_find_the_spans_of_a_traced_tiny_run():
    proc = subprocess.run([sys.executable, "-c", _BENCH_SCRIPT, str(ROOT)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    res = json.loads([ln for ln in lines if ln.startswith("RESULT ")][0][7:])
    last = [json.loads(ln) for ln in lines if ln.startswith('{"correct"')]
    assert len(last) == 2 and all(ln["correct"] for ln in last)
    names = ("expand_ms", "assemble_ms", "sort_slots_per_product",
             "out_slots_per_product")
    # neither line holds them: the untraced one has no spans, and off
    # the card the harness reads no per-product device figure
    assert not set(names) & (set(last[0]["metrics"]) | set(last[1]["metrics"]))
    untraced, traced = res["0"], res["1"]
    assert untraced["rc"] == traced["rc"] == 0
    assert untraced["snapshot"]["spans"] == {}
    assert untraced["on_a_card"] == dict.fromkeys(names)
    spans = traced["snapshot"]["spans"]
    assert {"tiled.call", "tiled.assemble", "tiled.result"} <= set(spans)
    assert any(n.startswith("tiled.sort.w") for n in spans)
    assert any(n.startswith("tiled.expand.w") for n in spans)
    got = traced["on_a_card"]
    assert all(got[n] is not None and got[n] > 0 for n in names), got
    assert traced["off_the_card"] == dict.fromkeys(names)
    c = traced["snapshot"]["counters"]
    assert got["sort_slots_per_product"] == pytest.approx(
        c["tiled.sort_slots"] / c["tiled.calls"] / 1000)
    assert got["out_slots_per_product"] == pytest.approx(
        c["tiled.out_slots"] / c["tiled.calls"] / 1000)
    call = spans["tiled.call"]["calls"]
    assert got["assemble_ms"] == pytest.approx(
        spans["tiled.assemble"]["stream_ms"] / call)
    assert got["expand_ms"] == pytest.approx(
        sum(s["stream_ms"] for n, s in spans.items()
            if n.startswith("tiled.expand.")) / call)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_device_only_profiler_window_times_few_calls_on_the_card(
        cuda_device):
    from torch.profiler import ProfilerActivity, profile
    from ia_spgemm_tpu_torch.bench.headline import build_matrix
    call = _tiled(build_matrix(m=16384).astype(np.float32),
                  device=cuda_device)
    call()
    torch.cuda.synchronize()
    tracing.reset()
    time.sleep(tracing.TIME_EVERY_NS * 1.2e-9)
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(6):
            call()
        torch.cuda.synchronize()
    spans = tracing.snapshot()["spans"]
    # the ranges and host times of every call, the stream of the first
    assert spans["tiled.call"]["calls"] == 6
    assert all(s["timed"] * 6 == s["calls"] for s in spans.values())
    assert all(s["stream_ms"] > 0 for s in spans.values())


@pytest.mark.cuda
def test_the_leaf_spans_cover_the_call_on_the_card(cuda_device):
    from ia_spgemm_tpu_torch.bench.headline import build_matrix
    a = build_matrix(m=16384).astype(np.float32)
    call = _tiled(a, device=cuda_device)
    call()
    torch.cuda.synchronize()
    whole = []
    for _ in range(5):
        tracing.reset()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        # the card waits while the host issues the call, so the call's
        # work then runs back to back
        torch.cuda._sleep(50_000_000)
        t0.record()
        with tracing.enable():
            call()
        t1.record()
        torch.cuda.synchronize()
        spans = tracing.snapshot()["spans"]
        leaves = sum(spans[n]["stream_ms"] for n in _leaf_names(spans))
        whole.append((t0.elapsed_time(t1), leaves,
                      spans["tiled.call"]["stream_ms"]))
    for ms, leaves, top in whole:
        assert leaves == pytest.approx(ms, rel=0.10), whole
        assert top == pytest.approx(ms, rel=0.10), whole
    # tracing off: no event is recorded, no span kept
    tracing.reset()
    call()
    torch.cuda.synchronize()
    assert tracing.snapshot()["spans"] == {} and not tracing._pending
