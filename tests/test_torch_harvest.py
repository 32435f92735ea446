"""PyTorch port, the harvest-and-retrain driver
(``ia_spgemm_tpu_torch.models.harvest``) against the JAX package's
scripts (``scripts/upcycle_tpu.py``, ``scripts/retrain_from_checkpoint.py``):

- the corpus: the same names in the same order (the JAX generators
  stubbed with lazy stand-ins, so that side builds nothing large), and
  the same matrices on the quick corpus and on the smallest entry of
  every family (indptr, indices and float32 data identical);
- the driver on the CPU: a checkpoint after every matrix, resume by name,
  a failed or timed-out worker retried by the next run (never
  blacklisted), the timeout's kill of the worker's process group, every
  output at the path given and nothing in weights/;
- the retrain: the JAX report's keys plus the failures, class counts and
  majority baseline as the JAX upcycle module computes them, --menu as
  JAX relabel;
- the committed card artefacts (weights/H100_*);
- the imports: no jax, JAX package, scripts or bench.

Tolerances: none; names, labels, counts and matrices are compared
exactly.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import bench as jbench
from ia_spgemm_tpu.io import suitesparse as jss
from ia_spgemm_tpu.models import upcycle as jupcycle
from ia_spgemm_tpu_torch import autotune
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.io import suitesparse as tss
from ia_spgemm_tpu_torch.models import harvest
from ia_spgemm_tpu_torch.models import upcycle as tupcycle
from ia_spgemm_tpu_torch.models import weights as tweights

REPO = Path(__file__).resolve().parents[1]
WEIGHTS = Path(tweights.LOCAL_WEIGHTS_DIR)
H100_SAMPLES = WEIGHTS / "H100_samples.npz"
H100_WEIGHTS = WEIGHTS / "H100_upcycled.npz"
H100_REPORT = WEIGHTS / "H100_upcycle_report.json"
QUICK = [n for n, _ in harvest.corpus(quick=True)]
# the smallest entry of every family of the full corpus
SMALLEST = ["banded_4096_0", "uniform_4096_0", "powerlaw_4096_0",
            "blockdiag_4096_0", "bandrand_16384_0", "pair_band_uni_4096_0",
            "pair_uni_pow_4096_0", "pair_pow_band_4096_0",
            "transpose_16384_0", "wideband_4096_0", "scatdiag_4096_0",
            "heavyskew_8192_0", "scatdiag5_4096_2", "hugerow_8192_0",
            "largeE_32768_0", "bskew_8192_0", "pair_band_scat_4096_0",
            "denseband_4096_32_0", "smalldense_1024_32_0",
            "pair_sp_dense_2048_0", "named_poisson3Da_0"]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "upcycle_tpu_script", REPO / "scripts" / "upcycle_tpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Lazy:
    """A JAX generator's call, made only when asked for (the script's
    `a.T.tocsr()` included)."""

    def __init__(self, fn, args, kwargs, transposed=False):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.transposed = transposed

    @property
    def T(self):
        return _Lazy(self.fn, self.args, self.kwargs, not self.transposed)

    def tocsr(self):
        return self

    def build(self):
        a = self.fn(*self.args, **self.kwargs)
        return (a.T if self.transposed else a).tocsr()


def _lazy(fn):
    return lambda *a, **k: _Lazy(fn, a, k)


def _jax_corpus(mp, quick, collection=None):
    """[(name, A, B)] of the JAX script's corpus, each generator call
    lazy (the script's own scipy / numpy draws run at their sizes)."""
    for name in ("gen_banded", "gen_uniform", "gen_powerlaw",
                 "gen_blockdiag", "gen_named"):
        mp.setattr(jss, name, _lazy(getattr(jss, name)))
    mp.setattr(jbench, "build_matrix", _lazy(jbench.build_matrix))
    mp.setattr(jss, "local_collection", lambda: dict(collection or {}))
    return list(_jax_script().corpus(quick))


def _mat(x):
    return x.build() if isinstance(x, _Lazy) else x


@pytest.fixture(scope="module")
def jax_full():
    with pytest.MonkeyPatch.context() as mp:
        return {n: (a, b) for n, a, b in _jax_corpus(mp, False)}


def _family(name):
    return "named" if name.startswith("named_") else \
        re.sub(r"(_\d+)+$", "", name)


@pytest.mark.parametrize("quick", [False, True])
def test_corpus_names_match_the_jax_script(monkeypatch, quick):
    monkeypatch.setattr(tss, "local_collection", lambda: {})
    port = [n for n, _ in harvest.corpus(quick)]
    with pytest.MonkeyPatch.context() as mp:
        jax = [n for n, _, _ in _jax_corpus(mp, quick)]
    assert port == jax
    assert len(port) == (8 if quick else 292) == len(set(port))


def test_smallest_entries_cover_every_family(jax_full):
    fams = {}
    for n in jax_full:
        fams.setdefault(_family(n), []).append(n)
    assert sorted(fams) == sorted({_family(n) for n in SMALLEST})
    for n in SMALLEST:
        if _family(n) != "named":
            m = int(re.findall(r"_(\d+)", n)[0])
            assert m == min(int(re.findall(r"_(\d+)", x)[0])
                            for x in fams[_family(n)]), n


def _same(t, j, name):
    if t is None or j is None:
        assert t is None and j is None, name
        return
    t = t.tocsr().astype(np.float32)
    j = _mat(j).tocsr().astype(np.float32)
    assert t.shape == j.shape, name
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f"{name} {f}")


@pytest.mark.parametrize("name", SMALLEST)
def test_corpus_matrices_match_the_jax_script(jax_full, name):
    ta, tb = dict(harvest.corpus(False))[name]()
    ja, jb = jax_full[name]
    _same(ta, ja, name)
    _same(tb, jb, name)


@pytest.mark.parametrize("name", QUICK)
def test_quick_corpus_matrices_match_the_jax_script(monkeypatch, name):
    monkeypatch.setattr(tss, "local_collection", lambda: {})
    with pytest.MonkeyPatch.context() as mp:
        jax = {n: (a, b) for n, a, b in _jax_corpus(mp, True)}
    ta, tb = dict(harvest.corpus(True))[name]()
    _same(ta, jax[name][0], name)
    _same(tb, jax[name][1], name)


def test_fixture_entries_match_the_jax_script(monkeypatch, tmp_path):
    """The reference's fixtures, when present: the square ones, as
    ref_<name>, after the quick corpus, read alike."""
    (tmp_path / "sq.mtx").write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 3\n1 1 2.0\n2 1 -1.5\n3 3 4.0\n")
    (tmp_path / "wide.mtx").write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "2 3 2\n1 3 1.0\n2 1 5.0\n")
    coll = tss.local_collection(str(tmp_path))
    monkeypatch.setattr(tss, "local_collection", lambda: coll)
    port = list(harvest.corpus(True))
    with pytest.MonkeyPatch.context() as mp:
        jax = _jax_corpus(mp, True, coll)
    assert [n for n, _ in port] == [n for n, _, _ in jax] == QUICK + [
        "ref_sq"]
    a, b = port[-1][1]()
    _same(a, jax[-1][1], "ref_sq")
    assert b is None and jax[-1][2] is None


# ---------------------------------------------------------------------------
# the driver on the CPU
# ---------------------------------------------------------------------------

def _weights_dir():
    return sorted((p.name, p.stat().st_mtime_ns) for p in WEIGHTS.iterdir())


def _paths(tmp_path, stem="s"):
    return {"samples": str(tmp_path / f"{stem}.npz"),
            "log": str(tmp_path / "log.json"),
            "weights": str(tmp_path / "w.npz"),
            "report": str(tmp_path / "r.json")}


def _argv(p, *extra):
    return ["--quick", "--device", "cpu", "--samples", p["samples"],
            "--harvest-log", p["log"], *extra]


def _log(p):
    with open(p["log"]) as f:
        return json.load(f)


def test_driver_checkpoints_resumes_and_writes_only_the_given_paths(
        monkeypatch, tmp_path):
    """Two quick entries through real CPU workers, then the retrain: the
    checkpoint after each matrix, every output at its given path and
    nothing in weights/; a second run resumes and harvests nothing."""
    before = _weights_dir()
    p = _paths(tmp_path)
    names = QUICK[:2]
    saved = []
    real_save = harvest._save_samples

    def save(path, samples):
        saved.append((path, [s.matrix_name for s in samples]))
        real_save(path, samples)

    monkeypatch.setattr(harvest, "_save_samples", save)
    rc = harvest.main(_argv(p, "--names", ",".join(names), "--weights-out",
                            p["weights"], "--report", p["report"],
                            "--steps", "2", "--kfold", "2"))
    assert rc == 0
    assert saved == [(p["samples"], names[:1]), (p["samples"], names)]
    log = _log(p)
    assert [log["entries"][n]["status"] for n in names] == ["ok", "ok"]
    assert log["runs"][-1]["attempted"] == 2
    assert [s.matrix_name for s in tupcycle.load_samples(p["samples"])] == \
        names
    with open(p["report"]) as f:
        assert json.load(f)["n_samples"] == 2
    assert tweights.load_params_npz(p["weights"], with_menu=True)[1] == \
        harvest.MENU
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(x) for x in p.values())

    def no_worker(*_a, **_k):
        raise AssertionError("a resumed run started a worker")

    monkeypatch.setattr(harvest, "_run_worker", no_worker)
    harvest.main(_argv(p, "--names", ",".join(names), "--harvest-only"))
    assert _log(p)["runs"][-1]["attempted"] == 0
    assert len(saved) == 2
    assert _weights_dir() == before


def test_failed_worker_is_retried_never_blacklisted(monkeypatch, tmp_path):
    p = _paths(tmp_path)
    name = QUICK[0]
    real = harvest._worker_command
    monkeypatch.setattr(harvest, "_worker_command", lambda *a: [
        sys.executable, "-c", "import sys; sys.exit(7)"])
    harvest.main(_argv(p, "--names", name, "--harvest-only"))
    rec = _log(p)["entries"][name]
    assert (rec["status"], rec["rc"]) == ("failed", 7)
    assert not os.path.exists(p["samples"])
    # the next run tries it again (a real worker now) and harvests it
    monkeypatch.setattr(harvest, "_worker_command", real)
    harvest.main(_argv(p, "--names", name, "--harvest-only"))
    log = _log(p)
    assert log["runs"][-1]["attempted"] == 1
    assert log["entries"][name]["status"] == "ok"
    assert [s.matrix_name for s in tupcycle.load_samples(p["samples"])] == \
        [name]
    assert not [f for f in os.listdir(tmp_path) if "nowinner" in f]


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_timeout_kills_the_process_group_and_goes_on(monkeypatch,
                                                     tmp_path):
    """A worker (and the child it started) sleeping past a 2 s
    IA_HARVEST_TIMEOUT is killed by its process group; the run goes on to
    the next entry; the timeout is logged, and retried next run."""
    p = _paths(tmp_path)
    pids = tmp_path / "pids"
    code = ("import os, subprocess, sys, time\n"
            "c = subprocess.Popen([sys.executable, '-c', "
            "'import time; time.sleep(120)'])\n"
            f"open({str(pids)!r}, 'a').write("
            "f'{os.getpid()} {c.pid}\\n')\n"
            "time.sleep(120)\n")
    monkeypatch.setattr(harvest, "_worker_command",
                        lambda *a: [sys.executable, "-c", code])
    monkeypatch.setenv(harvest.TIMEOUT_ENV, "2")
    harvest.main(_argv(p, "--names", ",".join(QUICK[:2]), "--harvest-only"))
    log = _log(p)
    assert [log["entries"][n]["status"] for n in QUICK[:2]] == \
        ["timeout", "timeout"]
    assert all(log["entries"][n]["rc"] is None for n in QUICK[:2])
    assert log["runs"][-1]["timeout_s"] == 2.0
    started = [int(x) for x in pids.read_text().split()]
    assert len(started) == 4
    assert not [pid for pid in started if _alive(pid)]
    report = harvest.failures(log, [])
    assert [f["name"] for f in report] == QUICK[:2]


def test_no_output_path_without_its_flag(tmp_path):
    with pytest.raises(SystemExit, match="--out-dir or --samples"):
        harvest.main(["--quick", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--weights-out"):
        harvest.main(["--retrain", str(tmp_path / "s.npz"), "--report",
                      str(tmp_path / "r.json")])


def test_worker_and_retrain_raise_without_a_card(tmp_path):
    """No path falls back to the CPU: without a card, "cpu" must be
    named."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        harvest.worker(QUICK[0], str(tmp_path / "one.npz"), quick=True)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        harvest.retrain(str(tmp_path / "s.npz"), str(tmp_path / "w.npz"),
                        str(tmp_path / "r.json"))


# ---------------------------------------------------------------------------
# retrain against the JAX upcycle module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def v3_subset(tmp_path_factory):
    """Every fifth sample of weights/tpu_samples_v3.npz, under a name a
    version parser would misread."""
    src = str(WEIGHTS / "tpu_samples_v3.npz")
    path = str(tmp_path_factory.mktemp("v3") / "tpu_samples_v9.npz")
    tupcycle.save_samples(path, tupcycle.load_samples(src)[::5],
                          menu=tupcycle.load_samples_menu(src))
    return path


def _jax_majority(monkeypatch, samples, menu):
    monkeypatch.setattr(jupcycle, "upcycle",
                        lambda *a, **k: (None, [], tuple(menu)))
    monkeypatch.setattr(jupcycle, "evaluate_pick_accuracy",
                        lambda *a, **k: 0.0)
    return jupcycle.stratified_kfold_accuracy(samples, menu, k=2)[2]


@pytest.mark.parametrize("menu", [None, "bitonic,esc", "dense,dia,bitonic"])
def test_retrain_report_matches_jax(monkeypatch, tmp_path, v3_subset, menu):
    p = _paths(tmp_path)
    argv = ["--retrain", v3_subset, "--device", "cpu", "--steps", "2",
            "--kfold", "2", "--weights-out", p["weights"], "--report",
            p["report"]]
    assert harvest.main(argv + (["--menu", menu] if menu else [])) == 0
    with open(p["report"]) as f:
        rep = json.load(f)
    assert list(rep) == list(harvest.REPORT_KEYS) + ["failed"]
    js = jupcycle.load_samples(v3_subset)
    jmenu = tuple(menu.split(",")) if menu else tuple(
        jupcycle.load_samples_menu(v3_subset))
    if menu:
        js = jupcycle.relabel(js, jmenu)
    counts = {a: sum(s.winner == a for s in js) for a in jmenu}
    assert rep["menu"] == list(jmenu)
    assert rep["n_samples"] == len(js) == 19
    assert rep["class_counts"] == counts
    assert rep["min_class_count"] == min(counts.values())
    assert rep["majority_baseline"] == round(
        _jax_majority(monkeypatch, js, jmenu), 4)
    assert rep["train_steps"] == 2 and rep["harvest_seconds"] is None
    assert rep["failed"] == []
    assert tweights.load_params_npz(p["weights"], with_menu=True)[1] == jmenu
    # only the paths given: nothing derived from the samples file's name
    assert sorted(os.listdir(tmp_path)) == ["r.json", "w.npz"]


def test_retrain_report_counts_the_harvest_log(tmp_path, v3_subset):
    p = _paths(tmp_path)
    log = {"menu": list(harvest.MENU), "runs": [
        {"seconds": 10.25}, {"seconds": 5.0}], "entries": {
        "x": {"status": "timeout", "rc": None, "seconds": 2.0},
        "y": {"status": "failed", "rc": 1, "seconds": 1.0},
        "z": {"status": "ok", "rc": 0, "seconds": 3.0}}}
    with open(p["log"], "w") as f:
        json.dump(log, f)
    rep = harvest.retrain(v3_subset, p["weights"], p["report"],
                          log_path=p["log"], steps=1, k=2, device="cpu")
    assert rep["harvest_seconds"] == 15.2
    assert rep["failed"] == [
        {"name": "x", "status": "timeout", "rc": None, "seconds": 2.0},
        {"name": "y", "status": "failed", "rc": 1, "seconds": 1.0}]


def test_near_ties_from_a_repeat():
    def s(name, times, winner):
        return tupcycle.Sample(img1=None, img2=None, feats=None, label=0,
                               winner=winner, matrix_name=name,
                               times={k: [v, 1.0] for k, v in times.items()})
    first = [s("a", {"esc": 1.0, "bitonic": 1.05, "baseline": 0.0}, "esc"),
             s("b", {"esc": 1.0, "dia": 2.0}, "esc"),
             s("c", {"esc": 1.0}, "esc")]
    again = [s("a", {"esc": 1.1, "bitonic": 1.0}, "bitonic"),
             s("b", {"esc": 1.0, "dia": 2.0}, "esc")]
    out = harvest.near_ties(first, again)
    assert out["repeated_entries"] == 2 and out["rows_timed_twice"] == 4
    assert out["winner_flips"] == ["a"]
    assert out["samples_with_a_runner_up"] == 2
    assert out["spread_p90"] == pytest.approx(np.percentile(
        [0.1, 0.05, 0.0, 0.0], 90))
    assert out["near_tie_names_p90"] == ["a"]
    assert out["near_ties_p50"] == 0


# ---------------------------------------------------------------------------
# the committed card artefacts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h100():
    with open(H100_REPORT) as f:
        return tupcycle.load_samples(str(H100_SAMPLES)), json.load(f)


def test_h100_weights_pick_from_their_menu():
    params, menu = tweights.load_params_npz(str(H100_WEIGHTS),
                                            with_menu=True)
    assert menu == tupcycle.V3_MENU
    a = sp.random(64, 64, density=0.08, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(1))
    A = CSR.from_scipy(a, device="cpu")
    res = autotune.select_algorithm(A, A, weight_name=str(H100_WEIGHTS))
    assert res.algorithm in menu


def test_h100_report_recomputes_from_the_samples(h100):
    samples, rep = h100
    menu = tuple(rep["menu"])
    assert menu == tupcycle.V3_MENU
    assert tupcycle.load_samples_menu(str(H100_SAMPLES)) == list(menu)
    counts = {a: sum(s.winner == a for s in samples) for a in menu}
    assert rep["n_samples"] == len(samples)
    assert rep["class_counts"] == counts
    assert rep["majority_baseline"] == round(
        max(counts.values()) / len(samples), 4)
    assert list(rep) == list(harvest.REPORT_KEYS) + ["failed"]
    names = [s.matrix_name for s in samples]
    assert len(set(names)) == len(names)
    corpus = [n for n, _ in harvest.corpus(False)]
    assert set(names) <= set(corpus)
    assert sorted(set(corpus) - set(names)) == sorted(
        f["name"] for f in rep["failed"])


def test_h100_log_matches_the_report(h100):
    """The committed harvest log: every corpus entry's last attempt,
    the report's harvest seconds and failures."""
    samples, rep = h100
    log = harvest.read_log(str(WEIGHTS / "H100_harvest_log.json"))
    summary = harvest.log_summary(log)
    assert summary["entries"] == len(harvest.failures(log, samples)) + len(
        samples)
    assert summary["status"].get("ok", 0) == len(samples)
    assert sum(r["harvested"] for r in summary["runs"]) == len(samples)
    assert rep["harvest_seconds"] == round(
        sum(r["seconds"] for r in log["runs"]), 1)
    assert rep["failed"] == harvest.failures(log, samples)
    assert all(r["card"].startswith("NVIDIA H100") for r in log["runs"])


def test_h100_labels_are_the_least_device_time(h100):
    samples, rep = h100
    menu = rep["menu"]
    for s in samples:
        dev = {n: t[0] for n, t in s.times.items() if n in menu}
        assert all(t > 0 for t in dev.values()), s.matrix_name
        assert s.winner == min(dev, key=dev.get), s.matrix_name
        assert s.label == menu.index(s.winner)


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def test_harvest_imports_no_jax_scripts_or_bench(tmp_path):
    """The module, its worker's run and its retrain in a fresh
    interpreter where `import jax` fails: no jax, no ia_spgemm_tpu, no
    scripts, no root bench module."""
    code = f"""
import sys
sys.modules["jax"] = None
from ia_spgemm_tpu_torch.models import harvest
assert harvest.worker({QUICK[0]!r}, {str(tmp_path / 'one.npz')!r},
                      quick=True, device="cpu") == 0
harvest.retrain({str(tmp_path / 'one.npz')!r}, {str(tmp_path / 'w.npz')!r},
                {str(tmp_path / 'r.json')!r}, steps=1, k=2, device="cpu")
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
    src = (REPO / "ia_spgemm_tpu_torch" / "models" / "harvest.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|ia_spgemm_tpu|scripts|"
                         r"bench)(\.|\s|$)", src, re.M)
