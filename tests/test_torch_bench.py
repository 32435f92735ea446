"""PyTorch port, the route competition of ``bench.py``
(``ia_spgemm_tpu_torch.bench.headline.run_bench``) against ``bench.main``
itself, on the CPU at the smoke size (m = 256, IA_SPGEMM_BENCH_SMOKE=1;
the JAX package's Pallas kernels interpreted, pinned to float32 as on
its chip, about a minute and a half, once per module):

- the same top-level keys and ``detail`` keys, the same routes and plan
  seconds' keys, the same products count (the global ESC plan's, which
  is also ``ops.flops.get_flop``'s) and output nnz, every route's
  checksum within CHECKSUM_RTOL of scipy's, and each package's
  ``fused_max_width`` its own module constant (both read the width at
  import: which package was imported first must not matter);
- the tuning: adopted when nothing is set, an explicit width wins, a
  missing or unreadable file gives None;
- the entry point: with no card and no ``--device cpu``, one structured
  error line and exit 1, before anything runs.

The winner is not compared: host timings pick it here.
"""

import contextlib
import io
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from ia_spgemm_tpu.ops import bitonic as jbt
from ia_spgemm_tpu_torch.bench import headline, roofline
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.ops import bitonic as tbt
from ia_spgemm_tpu_torch.ops.flops import get_flop

REPO = Path(__file__).resolve().parents[1]
CHECKSUM_RTOL = 1e-4
ROUTES = {"bitonic", "multiclass", "multiclass_pg", "slab", "esc"}
PLAN_KEYS = {"esc", "bitonic", "multiclass", "multiclass_call",
             "multiclass_pg", "slab"}
MODES = ("sparse_mode_device_ms", "bf16_mode_device_ms",
         "bf16_sparse_mode_device_ms")


@contextlib.contextmanager
def _environ(**env):
    """os.environ with env set, restored whole afterwards (both drivers
    write IA_SPGEMM_FUSED_MAX_WIDTH into it)."""
    saved = dict(os.environ)
    os.environ.update(env)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


@pytest.fixture(scope="module")
def jax_bench():
    sys.path.insert(0, str(REPO))
    import bench
    out = io.StringIO()
    with _environ(IA_SPGEMM_BENCH_SMOKE="1"), jax.enable_x64(False), \
            contextlib.redirect_stdout(out):
        bench.main()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_bench():
    with _environ():
        return headline.run_bench(m=256, device="cpu", smoke=True,
                                  chip=roofline.H100_SXM)


def test_same_keys_as_bench_py(jax_bench, port_bench):
    assert set(port_bench) == set(jax_bench)
    assert set(port_bench["detail"]) == set(jax_bench["detail"])
    for key in ("wall_decomposition", "roofline", "roofline_device"):
        assert set(port_bench["detail"][key]) == set(
            jax_bench["detail"][key]), key
    assert port_bench["metric"] == jax_bench["metric"] == "spgemm_gflops"
    assert port_bench["unit"] == jax_bench["unit"] == "GFLOPS"


def test_same_routes_and_plan_keys(jax_bench, port_bench):
    j, t = jax_bench["detail"], port_bench["detail"]
    assert set(t["routes"]) == set(j["routes"]) == ROUTES
    assert set(t["plan_seconds"]) == set(j["plan_seconds"]) == PLAN_KEYS
    assert t["algorithm"] in t["routes"] and j["algorithm"] in j["routes"]
    assert t["tuned_from"] == j["tuned_from"]


def test_same_products_and_output_nnz(jax_bench, port_bench):
    j, t = jax_bench["detail"], port_bench["detail"]
    a = headline.build_matrix(m=256).astype(np.float32)
    A = CSR.from_scipy(a, device="cpu")
    assert t["m"] == j["m"] == 256 and t["nnz"] == j["nnz"] == a.nnz
    assert t["intermediate_products"] == j["intermediate_products"] == \
        get_flop(A, A)
    assert t["nnz_out"] == j["nnz_out"] == (a @ a).nnz
    assert all(r["nnz"] == t["nnz_out"] for r in t["routes"].values())


def test_checksums_within_tolerance(jax_bench, port_bench):
    assert jax_bench["detail"]["checksum_rel_err"] < CHECKSUM_RTOL
    assert port_bench["detail"]["checksum_rel_err"] < CHECKSUM_RTOL
    for name, r in port_bench["detail"]["routes"].items():
        assert r["checksum_rel_err"] < CHECKSUM_RTOL, name


def test_fused_width_is_each_packages_own(jax_bench, port_bench):
    assert jax_bench["detail"]["fused_max_width"] == jbt.FUSED_MAX_WIDTH
    assert port_bench["detail"]["fused_max_width"] == tbt.FUSED_MAX_WIDTH


def test_every_time_and_mode_measured(port_bench):
    """Host times here (the card's device reads "cpu"), but every one
    taken: the routes, the three serving modes, the rooflines."""
    d = port_bench["detail"]
    assert d["device"] == "cpu"
    assert port_bench["value"] > 0 and port_bench["vs_baseline"] > 0
    assert d["ours_ms"] == d["wall_decomposition"]["pipelined_wall_ms"] > 0
    assert d["wall_decomposition"]["pipeline_n"] == 4
    for r in d["routes"].values():
        assert r["wall_ms"] > 0 and r["device_ms"] > 0
    assert all(d[k] > 0 for k in MODES), {k: d[k] for k in MODES}
    assert d["device_ms"] == d["routes"][d["algorithm"]]["device_ms"]
    assert d["roofline"]["chip"] == d["roofline_device"]["chip"] == \
        "h100_sxm"
    assert port_bench["value"] == pytest.approx(
        2 * d["intermediate_products"] / (d["ours_ms"] * 1e6))


def test_no_roofline_on_the_cpu_without_a_chip():
    """On the CPU no card's peaks are assumed unless given."""
    with _environ():
        r = headline.run_bench(m=64, device="cpu", smoke=True)
    assert r["detail"]["roofline"] is None
    assert r["detail"]["roofline_device"] is None
    assert r["detail"]["checksum_rel_err"] < CHECKSUM_RTOL


# ---------------------------------------------------------------------------
# the tuning
# ---------------------------------------------------------------------------

def _tuning_file(tmp_path, monkeypatch, text):
    path = tmp_path / "bench_tuning.json"
    if text is not None:
        path.write_text(text)
    monkeypatch.setattr(headline, "TUNING_PATH", path)
    monkeypatch.setattr(headline, "_ADOPTED", None)
    return path


def test_tuning_adopted_when_nothing_is_set(tmp_path, monkeypatch):
    _tuning_file(tmp_path, monkeypatch, json.dumps(
        {"fused_max_width": 512, "pg_run": 8, "source": "w512.json"}))
    with _environ():
        os.environ.pop("IA_SPGEMM_FUSED_MAX_WIDTH", None)
        t = headline.apply_bench_tuning()
        assert t["pg_run"] == 8 and t["source"] == "w512.json"
        assert os.environ["IA_SPGEMM_FUSED_MAX_WIDTH"] == "512"
        # a later call reports what it adopted
        assert headline.apply_bench_tuning() is t


@pytest.mark.parametrize("text", [None, "{not json", '{"pg_run": 8}'],
                         ids=["missing", "unreadable", "no_width"])
def test_tuning_missing_or_unreadable_gives_none(tmp_path, monkeypatch,
                                                 text):
    _tuning_file(tmp_path, monkeypatch, text)
    with _environ():
        os.environ.pop("IA_SPGEMM_FUSED_MAX_WIDTH", None)
        assert headline.apply_bench_tuning() is None
        assert "IA_SPGEMM_FUSED_MAX_WIDTH" not in os.environ


def test_explicit_width_wins(tmp_path, monkeypatch):
    _tuning_file(tmp_path, monkeypatch, json.dumps(
        {"fused_max_width": 512, "pg_run": 8, "source": "w512.json"}))
    with _environ(IA_SPGEMM_FUSED_MAX_WIDTH="256"):
        assert headline.apply_bench_tuning() is None
        assert os.environ["IA_SPGEMM_FUSED_MAX_WIDTH"] == "256"
        # even one equal to the tuning's, set by someone else
        os.environ["IA_SPGEMM_FUSED_MAX_WIDTH"] = "512"
        assert headline.apply_bench_tuning() is None


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_no_card_prints_one_error_line_and_exits_1(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def ran(*a, **k):
        raise AssertionError("the bench ran without a card")

    monkeypatch.setattr(headline, "build_matrix", ran)
    with _environ():
        assert headline.main([]) == 1
        assert headline.main(["--route", "multiclass_pg"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    for line in lines:
        r = json.loads(line)
        assert set(r) == {"metric", "value", "unit", "vs_baseline", "error"}
        assert r["metric"] == "spgemm_gflops" and r["unit"] == "GFLOPS"
        assert r["value"] == 0.0 and r["vs_baseline"] == 0.0
        assert "no GPU" in r["error"] and "ran without" not in r["error"]


def test_route_keeps_the_single_route_line(capsys):
    with _environ(IA_SPGEMM_FUSED_MAX_WIDTH=str(tbt.FUSED_MAX_WIDTH)):
        assert headline.main(["--route", "multiclass_pg", "--m", "128",
                              "--device", "cpu", "--iters", "1"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["detail"]["route"] == "multiclass_pg"
    assert r["detail"]["m"] == 128 and "host_wall_ms" in r["detail"]
