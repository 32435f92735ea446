"""PyTorch port, the measurement layer against the JAX package:
bench/profiling.py (the timers' keys, trace / annotate, the device a
result names), bench/roofline.py (every cost model and ``analyze``, at
the same ChipSpec, exactly; the card's peaks by its name), the harness's
device timers and progress (in process and in an isolated worker), the
public probes, FORMAT_NAMES, get_flop_jit, and bench/scaling.py's
``--d1-from``.

On the CPU every timer is the host clock; times are only checked to be
positive and finite here (a time of the card comes from a chip run).
Roofline numbers are compared exactly (the same arithmetic)."""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ia_spgemm_tpu.bench import harness as jharness
from ia_spgemm_tpu.bench import profiling as jprof
from ia_spgemm_tpu.bench import roofline as jroof
from ia_spgemm_tpu.bench import scaling as jscaling
from ia_spgemm_tpu.formats import types as jtypes
from ia_spgemm_tpu.formats.types import CSR as JCSR
from ia_spgemm_tpu.ops import flops as jflops
from ia_spgemm_tpu_torch.bench import harness, profiling, roofline, scaling
from ia_spgemm_tpu_torch.bench.isolated import bench_algorithm_isolated
from ia_spgemm_tpu_torch.formats import types as ttypes
from ia_spgemm_tpu_torch.formats.types import CSR as TCSR
from ia_spgemm_tpu_torch.ops import flops as tflops
from tests import fixtures


def _tfn():
    return torch.ones(64) * 2.0


def _jfn():
    return jnp.ones(64) * 2.0


@pytest.mark.parametrize("name", ["time_op", "device_time_ms",
                                  "pipelined_wall_ms", "wall_decomposition"])
def test_timer_keys_match_jax(name):
    got = getattr(profiling, name)(_tfn)
    want = getattr(jprof, name)(_jfn)
    assert set(got) == set(want)
    for k, v in got.items():
        assert math.isfinite(v), k
    if "device_ms" in got:
        assert got["device_ms"] > 0


def test_device_time_ms_chain_on_the_cpu():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return x * scale

    out = profiling.device_time_ms(fn, torch.ones(8), chain=4, reps=2,
                                   scale=3.0)
    # one warm-up call, then per rep one single call and a chain of 4
    assert len(calls) == 1 + 2 * (1 + 4)
    assert out["chain"] == 4 and out["chain_ms"] >= out["device_ms"] > 0
    assert profiling.dispatch_ms(fn, torch.ones(8)) >= 0.0


def test_sync_rtt_defaults_to_the_card(monkeypatch):
    assert profiling.sync_rtt_ms(device="cpu") >= 0.0
    assert jprof.sync_rtt_ms(reps=2) >= 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        profiling.sync_rtt_ms()


def test_result_device_finds_the_tensor_in_a_format():
    A = TCSR.from_scipy(fixtures.random_csr(8, 8, seed=1), device="cpu")
    assert profiling._result_device(A) == torch.device("cpu")
    assert profiling._result_device((None, [A], {"x": 1})) == \
        torch.device("cpu")


def test_trace_writes_the_annotated_window(tmp_path):
    with profiling.trace(str(tmp_path)) as d:
        with profiling.annotate("ia_spgemm_span"):
            _tfn()
    assert d == str(tmp_path)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "ia_spgemm_span" in names


COSTS = {
    "cost_esc": [dict(expansion=10_000_000, nnz_a=500_000, nnz_b=500_000,
                      nnz_c=7_000_000),
                 dict(expansion=12, nnz_a=3, nnz_b=4, nnz_c=5,
                      value_bytes=8)],
    "cost_dense": [dict(m=128, k=64, n=32), dict(m=7, k=9, n=11,
                                                 value_bytes=8)],
    "cost_dense_row": [dict(m=16384, k_width=29, n=16384, nnz_a=400_000)],
    "cost_dia": [dict(m=262144, nd_a=5, nd_b=5, nd_c=13)],
    "cost_bitonic": [dict(m=32768, width=1024, nnz_a=556_940)],
    "cost_multiclass": [dict(class_rows=[(22000, 256), (10000, 512),
                                         (224, 1024)], nnz_a=556_940,
                             nnz_c=7_086_306)],
    "cost_ell": [dict(m=32768, ka=29, kb=29, kc=400)],
}


@pytest.mark.parametrize("fn,kw", [(f, kw) for f, kws in COSTS.items()
                                   for kw in kws])
def test_cost_models_equal_jax(fn, kw):
    got = getattr(roofline, fn)(**kw)
    want = getattr(jroof, fn)(**kw)
    assert (got.flops, got.bytes) == (want.flops, want.bytes)


@pytest.mark.parametrize("time_ms", [100.0, 0.5, 1e-3])
@pytest.mark.parametrize("peak", ["f32", "bf16"])
def test_analyze_equals_jax(time_ms, peak):
    cost_t = roofline.cost_esc(expansion=10_000_000, nnz_a=500_000,
                               nnz_b=500_000, nnz_c=7_000_000)
    cost_j = jroof.cost_esc(expansion=10_000_000, nnz_a=500_000,
                            nnz_b=500_000, nnz_c=7_000_000)
    v5e = jroof.TPU_V5E
    chip = roofline.ChipSpec(v5e.name, v5e.hbm_gbs, v5e.peak_f32_gflops,
                             v5e.peak_bf16_gflops)
    assert roofline.analyze(time_ms, cost_t, chip, peak) == \
        jroof.analyze(time_ms, cost_j, v5e, peak)
    h = roofline.analyze(time_ms, cost_t, roofline.H100_SXM, peak)
    assert h["chip"] == "h100_sxm" and h["bound"] == "memory"


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", roofline.H100_SXM),
    ("NVIDIA H100 SXM5 80GB", roofline.H100_SXM),
    ("NVIDIA H100 PCIe", roofline.H100_PCIE),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_detect_chip_by_name(monkeypatch, name, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    if want is None:
        with pytest.raises(ValueError, match="no peaks known"):
            roofline.detect_chip()
    else:
        assert roofline.detect_chip() is want


def test_detect_chip_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        roofline.detect_chip()
    assert roofline.H100_SXM.hbm_gbs == 3350.0
    assert roofline.H100_SXM.peak_f32_gflops == 67_000.0


def _pair(a):
    a = a.astype(np.float32)
    return JCSR.from_scipy(a), TCSR.from_scipy(a, device="cpu")


def test_device_timers_and_progress_match_jax():
    J, T = _pair(fixtures.banded_csr(48, bandwidth=2, seed=5))
    algos = ("baseline", "csr", "ell", "dense")
    seen_t, seen_j = [], []
    rt = harness.run_benchmark(T, T, algos, iters=1, device_timers=True,
                               progress=seen_t.append)
    rj = jharness.run_benchmark(J, J, algos, iters=1, device_timers=True,
                                progress=seen_j.append)
    assert seen_t == seen_j == list(algos)
    for a, b in zip(rt.results, rj.results):
        assert (a.name, a.ok, a.skipped, bool(a.error)) == \
            (b.name, b.ok, b.skipped, bool(b.error))
        if a.ok and a.name != "baseline":
            # the JAX package's chained estimate, (t_chain - t_1) /
            # (chain - 1), is clamped at 0 and reads 0 for a tiny op on
            # a busy host; the port's chain time is always positive
            assert a.device_time_ms > 0 and b.device_time_ms >= 0
    assert rt.by_name("baseline").device_time_ms == 0.0
    plain = harness.run_benchmark(T, T, ("baseline", "csr"), iters=1)
    assert plain.by_name("csr").device_time_ms == 0.0


def test_isolated_row_carries_device_time():
    _, T = _pair(fixtures.banded_csr(64, bandwidth=2, seed=6))
    res = bench_algorithm_isolated(T, T, "bitonic", timeout_s=None,
                                   iters=1, device="cpu",
                                   device_timers=True)
    assert res.ok and not res.error and res.device_time_ms > 0
    res = bench_algorithm_isolated(T, T, "bitonic", timeout_s=None,
                                   iters=1, device="cpu")
    assert res.ok and res.device_time_ms == 0.0


@pytest.mark.parametrize("mat", ["banded", "random", "tall"])
@pytest.mark.parametrize("ratio", [50.0, 2.0, 1.01])
def test_public_probes_match_jax(mat, ratio):
    a = {"banded": fixtures.banded_csr(60, bandwidth=3, seed=1),
         "random": fixtures.random_csr(60, 60, density=0.08, seed=2),
         "tall": fixtures.random_csr(90, 12, density=0.3, seed=3)}[mat]
    J, T = _pair(a)
    assert harness.csr_to_ell_probe(T, ratio) == \
        jharness.csr_to_ell_probe(J, ratio)
    assert harness.csr_to_dia_probe(T, ratio) == \
        jharness.csr_to_dia_probe(J, ratio)


def test_format_names_match_jax():
    assert ttypes.FORMAT_NAMES == jtypes.FORMAT_NAMES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_flop_jit_matches_jax(seed):
    a = fixtures.random_csr(40, 30, density=0.1, seed=seed)
    b = fixtures.random_csr(30, 50, density=0.2, seed=seed + 10)
    (JA, TA), (JB, TB) = _pair(a), _pair(b)
    want = jflops.get_flop_jit(JA.col_ind, JA.nnz, JB.row_ptr)
    got = tflops.get_flop_jit(TA.col_ind, TA.nnz, TB.row_ptr)
    assert got.dim() == 0 and got.device == TA.col_ind.device
    assert int(got) == int(want) == tflops.get_flop(TA, TB)
    # slots past nnz count nothing
    assert int(tflops.get_flop_jit(TA.col_ind, 0, TB.row_ptr)) == 0


def _fake_points(monkeypatch, mod):
    pt = mod.ScalingPoint(devices=1, nnz_out=10, flops=20, time_ms=2.5,
                          nnz_per_s=4000.0, gflops=1e-5, efficiency=1.0)
    monkeypatch.setattr(mod, "measure_ring_scaling",
                        lambda *a, **k: [pt])
    return pt


def _jax_main(monkeypatch, capsys, argv):
    import sys

    from ia_spgemm_tpu.cli import main as jcli
    _fake_points(monkeypatch, jscaling)
    monkeypatch.setattr(jcli, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["scaling"] + argv)
    jscaling.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_main(monkeypatch, capsys, argv):
    _fake_points(monkeypatch, scaling)
    assert scaling.main(["--cpu", "--m", "256"] + argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["missing", "garbled", "no_d1", "good"])
def test_d1_from_matches_jax(monkeypatch, capsys, tmp_path, case):
    path = tmp_path / "d1.json"
    d1 = {"devices": 1, "time_ms": 1.25, "nnz_out": 10,
          "nnz_per_s": 8000.0, "efficiency": 1.0, "simulated": False}
    if case == "garbled":
        path.write_text("{not json")
    elif case == "no_d1":
        path.write_text(json.dumps({"points": []}))
    elif case == "good":
        path.write_text(json.dumps({"d1_real_chip": d1}))
    argv = ["--d1-from", str(path)]
    got = _port_main(monkeypatch, capsys, argv)
    want = _jax_main(monkeypatch, capsys, argv)
    assert ("d1_import_error" in got) == ("d1_import_error" in want) == \
        (case != "good")
    if case == "good":
        assert got["d1_real_chip"] == want["d1_real_chip"] == d1
        assert got["model_h100_nvlink_from_d1"][0]["time_ms"] == \
            want["model_v5e_ici_from_d1"][0]["time_ms"] == 1.25
    else:
        # the same error text, the path and the parser's message
        assert got["d1_import_error"] == want["d1_import_error"]
    assert got["points"] and "model_h100_nvlink" in got
