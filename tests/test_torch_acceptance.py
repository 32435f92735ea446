"""PyTorch port, the acceptance run (``ia_spgemm_tpu_torch.bench.acceptance``)
against the JAX package's ``scripts/acceptance.py``, on the CPU at the
script's smoke sizes (headline m=256, skew m=512):

- ``headline_rooflines``: the same keys in the same order but
  ``multiclass_skew_ell`` (left out), the same engine / route / assembly
  strings, flat-plan flags, nnz and n_dense, the same cost model, flops
  and bytes behind every roofline entry (the JAX side's recorded as its
  ``roofline.analyze`` is called), the skew checksum error; the one value
  computed otherwise, ``vs_global_sort``, each package's by its own rule;
- ``fixture_sweeps`` over one directory of small .mtx files (square,
  rectangular, broken): the same entries, the same ok rows, each ok
  row's C the same size in its format and its checksum within 1e-5, an
  error entry for the broken file;
- the gate before every timing, ``shares_above``, the outputs only at
  the paths given, the card by default, no jax imported.

The JAX side runs once per module (Pallas in interpret mode, about a
minute and a half), pinned to float32 (tests/conftest.py turns x64 on),
as on its chip. No time is compared.

Tolerances: checksums within 1e-5 relative; everything else exactly.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ia_spgemm_tpu.bench import roofline as jroofline
from ia_spgemm_tpu.io import suitesparse as jss
from ia_spgemm_tpu_torch.bench import acceptance, roofline
from ia_spgemm_tpu_torch.bench.headline import build_matrix
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.io import mmio

REPO = Path(__file__).resolve().parents[1]
CHECKSUM_RTOL = 1e-5
# the keys of the JAX script's smoke run (the headline at m=256 has no
# dia entry: its random entries fill ~every diagonal)
KEYS = ["esc_csr", "esc_csr_to_flat", "esc_csr_to_flat_scatter",
        "esc_csr_global_sort", "esc_auto_tiled", "bitonic", "compensated",
        "dense_row", "multiclass_skew", "multiclass_skew_pg",
        "skew_esc_fallback", "esc_auto_skew", "dense_row_spmm_win"]
ROOFLINE_KEYS = KEYS[:10]
FIELDS = ("engine", "route", "assembly", "flat_plan_viable", "nnz",
          "n_dense")
COST_MODELS = ("cost_esc", "cost_bitonic", "cost_multiclass",
               "cost_dense_row", "cost_dia")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "acceptance_script", REPO / "scripts" / "acceptance.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _strip_costs(d):
    """The entry without the recorded "_cost" (nested ones too) and the
    cost it recorded (its own, else its roofline_device's)."""
    d = dict(d)
    cost = d.pop("_cost", None)
    if isinstance(d.get("roofline_device"), dict):
        rd = dict(d["roofline_device"])
        cost = cost or rd.pop("_cost", None)
        rd.pop("_cost", None)
        d["roofline_device"] = rd
    return d, cost


@pytest.fixture(scope="module")
def jax_run():
    """The JAX script's headline_rooflines at its smoke size, float32,
    with the cost behind every roofline.analyze call recorded into the
    entry it made."""
    script = _jax_script()
    names = {}
    keep = []

    def recording(name, fn):
        def wrapped(*a, **k):
            cost = fn(*a, **k)
            keep.append(cost)
            names[id(cost)] = name
            return cost
        return wrapped

    analyze = jroofline.analyze

    def analyze_recording(time_ms, cost, *a, **k):
        d = analyze(time_ms, cost, *a, **k)
        d["_cost"] = {"model": names.get(id(cost)), "flops": cost.flops,
                      "bytes": cost.bytes}
        return d

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IA_SPGEMM_BENCH_SMOKE", "1")
        mp.setattr(jroofline, "analyze", analyze_recording)
        for n in COST_MODELS:
            mp.setattr(jroofline, n, recording(n, getattr(jroofline, n)))
        with jax.enable_x64(False):
            raw = script.headline_rooflines()
    out, costs = {}, {}
    for k, v in raw.items():
        out[k], cost = _strip_costs(v)
        if cost is not None:
            costs[k] = cost
    return out, costs


@pytest.fixture(scope="module")
def port_run():
    costs = {}
    out = acceptance.headline_rooflines("cpu", chip=roofline.H100_SXM,
                                        smoke=True, costs=costs)
    return out, costs


# ---------------------------------------------------------------------------
# headline_rooflines against the JAX script
# ---------------------------------------------------------------------------

def test_keys_match_jax_but_the_ell_assembly(jax_run, port_run):
    """The JAX keys in the JAX order; only multiclass_skew_ell (the ELL
    assembly on the skew matrix, not ported) is missing."""
    jout, tout = jax_run[0], port_run[0]
    assert list(jout) == KEYS[:8] + ["multiclass_skew_ell"] + KEYS[8:]
    assert list(tout) == KEYS
    assert "multiclass_skew_ell" not in tout


@pytest.mark.parametrize("key", KEYS)
def test_entry_fields_match_jax(jax_run, port_run, key):
    """engine / route / assembly strings, flags and counts; the same
    entry keys (roofline entries: the roofline's, the same extras)."""
    j, t = jax_run[0][key], port_run[0][key]
    assert set(t) == set(j)
    for f in FIELDS:
        assert t.get(f) == j.get(f), f
    assert (t.get("roofline_device") is None) == \
        (j.get("roofline_device") is None)


@pytest.mark.parametrize("key", ROOFLINE_KEYS)
def test_cost_model_matches_jax(jax_run, port_run, key):
    """The same cost model, flops and bytes behind each roofline entry
    (dense_row's least count is the port's own, for shares_above)."""
    jc, tc = jax_run[1][key], dict(port_run[1][key])
    least = tc.pop("least_bytes", None)
    assert tc == jc
    assert (least is not None) == (key == "dense_row")


def test_roofline_entries_and_costs_cover_the_same_keys(jax_run, port_run):
    jkeys = [k for k in jax_run[1] if k != "multiclass_skew_ell"]
    assert sorted(jkeys) == sorted(port_run[1]) == sorted(ROOFLINE_KEYS)
    tout = port_run[0]
    for key in ROOFLINE_KEYS:
        entry = tout[key].get("roofline_device") or tout[key]
        assert entry["chip"] == "h100_sxm"


@pytest.mark.parametrize("key", ["multiclass_skew", "multiclass_skew_pg"])
def test_skew_checksum_matches_jax(jax_run, port_run, key):
    j, t = jax_run[0][key], port_run[0][key]
    assert t["checksum_rel_err"] < 1e-5
    assert abs(t["checksum_rel_err"] - j["checksum_rel_err"]) <= 1e-5


def test_vs_global_sort_departs_from_jax(jax_run, port_run):
    """Where the packages part: the JAX script divides esc_csr's time,
    the slab engine's whenever slab is viable, by the tiled route's; the
    port divides the global sort's, as the name says."""
    jout, tout = jax_run[0], port_run[0]
    assert jout["esc_csr"]["engine"] == tout["esc_csr"]["engine"] == "slab"
    assert jout["esc_auto_tiled"]["vs_global_sort"] == round(
        jout["esc_csr"]["time_ms"] / jout["esc_auto_tiled"]["time_ms"], 2)
    assert tout["esc_auto_tiled"]["vs_global_sort"] == round(
        tout["esc_csr_global_sort"]["time_ms"]
        / tout["esc_auto_tiled"]["time_ms"], 2)


def test_full_size_skew_matrix():
    """The skew workload at full size: m = 32768, about 535 k nnz, heavy
    rows of 400 entries, a flat plan that is not viable."""
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.ops import bitonic
    a = acceptance.skew_matrix()
    lens = np.diff(a.indptr)
    assert a.shape == (32768, 32768) and a.dtype == np.float32
    assert 520_000 <= a.nnz <= 550_000
    assert lens.max() <= 400 and 40 <= (lens > 300).sum() <= 100
    A = convert.csr_to_ell(CSR.from_scipy(a, device="cpu"),
                           check_guard=False)
    assert not bitonic.plan_bitonic(A, A).viable


# ---------------------------------------------------------------------------
# the gate, the shares
# ---------------------------------------------------------------------------

def test_hold_raises_on_a_wrong_value_or_pattern():
    a = build_matrix(m=64).astype(np.float32)
    want = acceptance._oracle(a, a)
    C = CSR.from_scipy(want.astype(np.float32), device="cpu")
    assert acceptance.hold("ok", C, want) <= 1e-4 * abs(want).max()
    bad = want.copy()
    bad.data[7] += 0.01 * abs(want).max()
    with pytest.raises(AssertionError, match="max"):
        acceptance.hold("value", CSR.from_scipy(bad.astype(np.float32),
                                                device="cpu"), want)
    gone = want.copy()
    gone.data[7] = 0.0
    with pytest.raises(AssertionError, match="pattern"):
        acceptance.hold("pattern", CSR.from_scipy(gone, device="cpu"), want)
    dense = a.astype(np.float64) @ np.ones((64, 3))
    from ia_spgemm_tpu_torch.formats.types import Dense
    D = Dense(values=torch.from_numpy(
        dense + 0.01 * max(1.0, abs(dense).max())))
    with pytest.raises(AssertionError, match="max"):
        acceptance.hold("dense", D, dense)


def test_a_wrong_route_raises_before_its_time(monkeypatch):
    """A route whose C is off raises: no entry, no time."""
    from ia_spgemm_tpu_torch.ops import esc
    comp = esc.spgemm_csr_compensated

    def off(A, B, *a, **k):
        C = comp(A, B, *a, **k)
        C.values[0] += 1.0
        return C

    monkeypatch.setattr(esc, "spgemm_csr_compensated", off)
    with pytest.raises(AssertionError, match="compensated"):
        acceptance.headline_rooflines("cpu", chip=roofline.H100_SXM,
                                      smoke=True)


def test_shares_above_reads_each_entry_against_its_least_count():
    chip = roofline.H100_SXM
    esc_cost = roofline.cost_esc(1_000_000, 50_000, 50_000, 400_000)
    sol = roofline.analyze(1.0, esc_cost, chip)["speed_of_light_ms"]
    dr = roofline.cost_dense_row(1000, 9, 2048, 8000)
    costs = {"fast": {"model": "cost_esc", "flops": esc_cost.flops,
                      "bytes": esc_cost.bytes},
             "slow": {"model": "cost_esc", "flops": esc_cost.flops,
                      "bytes": esc_cost.bytes},
             "dense_row": {"model": "cost_dense_row", "flops": dr.flops,
                           "bytes": dr.bytes, "least_bytes": 1e6}}
    dr_sol = roofline.analyze(1.0, dr, chip)["speed_of_light_ms"]
    out = {"fast": {"time_ms": sol / 2,
                    "roofline_device": {"time_ms": sol * 2}},
           "slow": {"time_ms": sol * 4, "roofline_device": None},
           # above 100% of the JAX count, under the least count's
           "dense_row": {"time_ms": dr_sol / 10}}
    above = acceptance.shares_above(out, costs, chip)
    assert list(above) == ["fast"] and above["fast"] == pytest.approx(
        200.0, rel=1e-2)
    costs["dense_row"].pop("least_bytes")
    assert set(acceptance.shares_above(out, costs, chip)) == {
        "fast", "dense_row"}


# ---------------------------------------------------------------------------
# fixture_sweeps against the JAX script
# ---------------------------------------------------------------------------

def _write_fixtures(d: Path):
    mmio.write_mtx(str(d / "square.mtx"),
                   CSR.from_scipy(build_matrix(m=128), device="cpu"))
    r = sp.random(96, 128, density=0.05, format="csr",
                  random_state=np.random.default_rng(5))
    mmio.write_mtx(str(d / "rect.mtx"), CSR.from_scipy(r, device="cpu"))
    (d / "broken.mtx").write_text(
        "%%MatrixMarket matrix coordinate real general\n3 3 2\n1 1\n")


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixtures")
    _write_fixtures(d)
    orig = jss.local_collection
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jss, "local_collection", lambda path=None: orig(str(d)))
        with jax.enable_x64(False):
            jout = _jax_script().fixture_sweeps()
    return jout, acceptance.fixture_sweeps(str(d), "cpu")


def test_fixture_sweeps_match_jax(sweeps):
    jout, tout = sweeps
    assert list(tout) == list(jout) == ["broken", "rect", "square"]
    assert set(tout["broken"]) == set(jout["broken"]) == {"error"}
    for name in ("rect", "square"):
        j, t = jout[name], tout[name]
        assert t["shape_b"] == j["shape_b"] and t["flops"] == j["flops"]
        ok_j = [r["name"] for r in j["results"] if r["ok"]]
        ok_t = [r["name"] for r in t["results"] if r["ok"]]
        assert ok_t == ok_j
        assert len(ok_t) == len(acceptance.SWEEP_EXTRA) + 5
        rows_j = {r["name"]: r for r in j["results"]}
        for r in t["results"]:
            if not r["ok"]:
                continue
            rj = rows_j[r["name"]]
            assert r["memory_bytes"] == rj["memory_bytes"], r["name"]
            assert abs(r["verified_sum"] - rj["verified_sum"]) <= \
                CHECKSUM_RTOL * max(1.0, abs(rj["verified_sum"])), r["name"]
        assert set(t) == set(j)


def test_rectangular_fixture_runs_a_times_a_transpose(sweeps):
    t = sweeps[1]["rect"]
    assert t["shape_a"] == [96, 128] and t["shape_b"] == [128, 96]


# ---------------------------------------------------------------------------
# main: outputs, the card, the imports
# ---------------------------------------------------------------------------

def test_no_output_without_its_flag(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(acceptance, "fixture_sweeps",
                        lambda d, dev: calls.append(("sweeps", d)) or
                        {"m": {"winner": "csr"}})
    monkeypatch.setattr(acceptance, "headline_rooflines",
                        lambda dev, chip, smoke: calls.append(
                            ("roofs", chip, smoke)) or
                        {"esc_csr": {"time_ms": 1.0, "pct_of_sol": 2.0}})
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("IA_SPGEMM_BENCH_SMOKE", raising=False)
    argv = ["--device", "cpu", "--chip", "h100_sxm"]
    assert acceptance.main(argv) == 0
    assert calls == [("sweeps", "Inputs"),
                     ("roofs", roofline.H100_SXM, False)]
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("IA_SPGEMM_BENCH_SMOKE", "1")
    roofs, sw = tmp_path / "o" / "r.json", tmp_path / "s.json"
    assert acceptance.main(argv + ["--rooflines-only", "--rooflines-out",
                                   str(roofs), "--sweeps-out",
                                   str(sw)]) == 0
    assert calls[-1] == ("roofs", roofline.H100_SXM, True)
    assert ("sweeps", "Inputs") not in calls[2:]
    assert json.loads(roofs.read_text())["esc_csr"]["time_ms"] == 1.0
    assert not sw.exists()
    assert acceptance.main(argv + ["--inputs", "F", "--sweeps-out",
                                   str(sw), "--smoke"]) == 0
    assert calls[-2:] == [("sweeps", "F"), ("roofs", roofline.H100_SXM,
                                            True)]
    assert json.loads(sw.read_text()) == {"m": {"winner": "csr"}}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["o", "s.json"]


def test_main_runs_on_the_card_unless_cpu_is_named():
    """No path falls back to the CPU or to peaks it did not detect."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        acceptance.main(["--smoke", "--rooflines-only"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        acceptance.headline_rooflines("cuda", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        acceptance.fixture_sweeps("Inputs", "cuda")
    with pytest.raises(ValueError, match="chip"):
        acceptance.headline_rooflines("cpu", smoke=True)
    with pytest.raises(SystemExit):
        acceptance.main(["--device", "cpu", "--smoke"])


def test_acceptance_imports_no_jax_scripts_or_bench(tmp_path):
    """The module and a sweep in a fresh interpreter where `import jax`
    fails: no jax, no ia_spgemm_tpu, no scripts, no root bench module."""
    d = tmp_path / "fx"
    d.mkdir()
    mmio.write_mtx(str(d / "a.mtx"),
                   CSR.from_scipy(build_matrix(m=64), device="cpu"))
    code = f"""
import sys
sys.modules["jax"] = None
from ia_spgemm_tpu_torch.bench import acceptance
out = acceptance.fixture_sweeps({str(d)!r}, "cpu")
assert out["a"]["winner"], out
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "ia_spgemm_tpu", "scripts", "bench") and sys.modules[m]]
assert not bad, bad
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")
    src = (REPO / "ia_spgemm_tpu_torch" / "bench" /
           "acceptance.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|ia_spgemm_tpu|scripts|"
                         r"bench)(\.|\s|$)", src, re.M)
