"""PyTorch port, the width-class slice end to end against the JAX package:
multiclass_planned (BlockCSR and ELL assembly, with and without the
plan-time gather, run 8), the flat spgemm_bitonic, the harness's bitonic
row, the CLI (bitonic and the ESC modes), and the headline's and the
hybrid route's workloads."""

import re

import numpy as np
import pytest
import scipy.sparse as sp

import bench
from ia_spgemm_tpu.bench import harness as jharness
from ia_spgemm_tpu.cli import main as jcli
from ia_spgemm_tpu.formats.types import CSR as JCSR
from ia_spgemm_tpu.ops import bitonic as jbt
from ia_spgemm_tpu_torch.bench import harness as tharness
from ia_spgemm_tpu_torch.bench import headline
from ia_spgemm_tpu_torch.bench import report as treport
from ia_spgemm_tpu_torch.cli import main as tcli
from ia_spgemm_tpu_torch.formats import convert as tconvert
from ia_spgemm_tpu_torch.formats.types import CSR as TCSR
from ia_spgemm_tpu_torch.io import mmio as tmmio
from ia_spgemm_tpu_torch.ops import bitonic as tbt
from tests import fixtures
from tests.test_bitonic import _skewed
from tests.torch_parity import (assert_same, assert_values_close,
                                check_oracle, jell, tell)

MATRICES = {
    "narrow": _skewed(7, 300),
    # a class above TRANSPOSED_MAX_WIDTH: K4 through the torch expand
    "mixed_wide": _skewed(23, 256, heavy_every=64, heavy=160, light=5),
    "headline256": bench.build_matrix(m=256),
}
VARIANTS = {"plain": {}, "pregather": {"pregather": True},
            "pregather_run8": {"pregather": True, "run_override": 8}}
CASES = [("narrow", "plain"), ("narrow", "pregather"),
         ("mixed_wide", "plain"), ("mixed_wide", "pregather"),
         ("headline256", "pregather"), ("headline256", "pregather_run8")]


@pytest.fixture(scope="module")
def jax_results():
    """JAX outputs, computed once per (matrix, run_override, assemble).
    The JAX package's plan-time gather is bit-identical to its per-call
    gather (tests/test_bitonic.py::test_multiclass_pregather_matches), so
    the JAX side runs without it and the port runs both ways."""
    cache = {}

    def get(name, variant, assemble):
        run = VARIANTS[variant].get("run_override")
        key = (name, run, assemble)
        if key not in cache:
            A = jell(MATRICES[name])
            cache[key] = jbt.multiclass_planned(
                A, A, assemble=assemble, run_override=run)()
        return cache[key]
    return get


def _assert_bcsr_matches(T, J):
    assert T.shape == J.shape
    assert_same(T.blk_ptr, J.blk_ptr, "blk_ptr")
    assert_same(T.nnz_row, J.nnz_row, "nnz_row")
    assert_same(T.col_blocks, J.col_blocks, "col_blocks")
    assert_values_close(T.val_blocks, J.val_blocks, "val_blocks")
    assert int(T.nnz) == int(J.nnz)


@pytest.mark.parametrize("name,variant", CASES)
def test_multiclass_bcsr_matches_jax(jax_results, name, variant):
    a = MATRICES[name]
    A = tell(a)
    T = tbt.multiclass_planned(A, A, assemble="bcsr", **VARIANTS[variant])()
    _assert_bcsr_matches(T, jax_results(name, variant, "bcsr"))
    check_oracle(a, a, T)


@pytest.mark.parametrize("name", ["narrow"])
def test_multiclass_ell_matches_jax(jax_results, name):
    a = MATRICES[name]
    A = tell(a)
    T = tbt.spgemm_bitonic_multiclass(A, A)
    J = jax_results(name, "plain", "ell")
    assert_same(T.col_ind, J.col_ind, "col_ind")
    assert_same(T.nnz_row, J.nnz_row, "nnz_row")
    assert_values_close(T.values, J.values, "values")
    check_oracle(a, a, T)


def test_multiclass_out_width_cap_matches_jax():
    """A cap below the widest row: bcsr rounds it up to 128, rows keep
    min(nnz, their class's output width), as in the JAX package."""
    a = _skewed(25, 200)
    JA, TA = jell(a), tell(a)
    J = jbt.multiclass_planned(JA, JA, assemble="bcsr", out_width=130)()
    T = tbt.multiclass_planned(TA, TA, assemble="bcsr", out_width=130)()
    _assert_bcsr_matches(T, J)


def test_multiclass_chunked_layout_matches_oracle():
    """Uniform short rows plan the chunked layout (no fragment lists)."""
    a = sp.random(64, 64, density=0.05, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(12))
    A = tell(a)
    call = tbt.multiclass_planned(A, A, assemble="bcsr")
    assert not call.ragged
    check_oracle(a, a, call())


@pytest.mark.parametrize("seed,layout", [(3, "auto"), (5, "rows")])
def test_flat_spgemm_bitonic_matches_jax(seed, layout):
    rng = np.random.default_rng(seed)
    a = sp.random(96, 96, density=0.08, format="csr",
                  random_state=np.random.RandomState(seed))
    a.data[:] = rng.standard_normal(a.nnz)
    JA, TA = jell(a), tell(a)
    J = jbt.spgemm_bitonic(JA, JA, layout=layout)
    T = tbt.spgemm_bitonic(TA, TA, layout=layout)
    assert_same(T.col_ind, J.col_ind, "col_ind")
    assert_same(T.nnz_row, J.nnz_row, "nnz_row")
    assert_values_close(T.values, J.values, "values")
    check_oracle(a, a, T)


def test_flat_unported_options_raise():
    """The bf16 lane refuses what the JAX package refuses (float64
    operands, a ka outside the gather budget), and a plan that is not
    viable raises. The cols layout that float64 and wide-ka plans take
    otherwise is tests/test_torch_bitonic_cols.py's."""
    a = sp.random(32, 32, density=0.1, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(1))
    A = tell(a)
    A64 = tconvert.csr_to_ell(TCSR.from_scipy(a.astype(np.float64),
                                              device="cpu"),
                              check_guard=False)
    with pytest.raises(ValueError, match="fused-expand"):
        tbt.spgemm_bitonic(A64, A64, value_mode="bf16")
    dense = tell(sp.csr_matrix(np.ones((8, 100), np.float32)))
    wide = tell(sp.csr_matrix(np.ones((100, 8), np.float32)))
    with pytest.raises(ValueError, match="fused-expand"):
        tbt.spgemm_bitonic(dense, wide, value_mode="bf16")
    with pytest.raises(ValueError):
        tbt.spgemm_bitonic(A, A, plan=tbt.BitonicPlan(
            width=2 * tbt.MAX_WIDTH, run=8, tile_rows=8, viable=False))


def test_harness_bitonic_row_matches_jax():
    a = fixtures.random_csr(32, 32, density=0.15, seed=11,
                            dtype=np.float32)
    jrep = jharness.run_benchmark(JCSR.from_scipy(a), JCSR.from_scipy(a),
                                  ("baseline", "bitonic"), iters=1)
    trep = tharness.run_benchmark(TCSR.from_scipy(a, device="cpu"),
                                  TCSR.from_scipy(a, device="cpu"),
                                  ("baseline", "bitonic"), iters=1)
    assert trep.flops == jrep.flops
    for name in ("baseline", "bitonic"):
        j, t = jrep.by_name(name), trep.by_name(name)
        assert t.ok and j.ok and not t.error, t.error
        assert t.verified_sum == pytest.approx(j.verified_sum, rel=1e-5)
        assert t.memory_bytes == j.memory_bytes
    # a name off the menu is an error row, as in the JAX harness
    jrep = jharness.run_benchmark(JCSR.from_scipy(a), JCSR.from_scipy(a),
                                  ("baseline", "dist"), iters=1)
    trep = tharness.run_benchmark(TCSR.from_scipy(a, device="cpu"),
                                  TCSR.from_scipy(a, device="cpu"),
                                  ("baseline", "dist"), iters=1)
    for rep in (jrep, trep):
        assert "unknown algorithm" in rep.by_name("dist").error


def _verified_sums(out: str) -> dict:
    sums = {}
    for line in out.splitlines():
        f = line.split()
        if len(f) == 8 and f[0] in tharness.PORTED_ALGORITHMS:
            sums[f[0]] = (f[4], f[7])
    return sums


def test_cli_bitonic_matches_jax_cli(tmp_path, capsys):
    """Small-integer values: every sum is exact in float32 and float64,
    so both CLIs print the same verified_sum digits."""
    rng = np.random.default_rng(4)
    a = sp.random(120, 120, density=0.04, format="csr",
                  random_state=np.random.RandomState(4))
    a.data[:] = rng.integers(-3, 4, a.nnz)
    a.eliminate_zeros()
    path = str(tmp_path / "a.mtx")
    tmmio.write_mtx(path, TCSR.from_scipy(a, device="cpu"))
    args = [path, "--mode", "bitonic", "--no-matnet", "--iters", "1"]
    assert jcli.main(args) == 0
    jsums = _verified_sums(capsys.readouterr().out)
    assert tcli.main(args + ["--device", "cpu"]) == 0
    tsums = _verified_sums(capsys.readouterr().out)
    assert set(tsums) == {"baseline", "bitonic"}
    assert tsums == jsums
    assert tsums["bitonic"][1] == "ok"


@pytest.mark.parametrize("mode", ["csr", "esc", "compensated"])
def test_cli_esc_modes_match_jax_cli(tmp_path, capsys, mode):
    """The production CSR route, the ESC engine and the compensated route
    print the JAX CLI's verified_sum (small-integer values: exact sums).
    Under the tests' x64 setting the JAX CLI reads float64 and skips its
    float32-only compensated row, so that row is held to the baseline."""
    rng = np.random.default_rng(6)
    a = sp.random(120, 120, density=0.04, format="csr",
                  random_state=np.random.RandomState(6))
    a.data[:] = rng.integers(-3, 4, a.nnz)
    a.eliminate_zeros()
    path = str(tmp_path / "a.mtx")
    tmmio.write_mtx(path, TCSR.from_scipy(a, device="cpu"))
    args = [path, "--mode", mode, "--no-matnet", "--iters", "1"]
    assert jcli.main(args) == 0
    jsums = _verified_sums(capsys.readouterr().out)
    assert tcli.main(args + ["--device", "cpu"]) == 0
    tsums = _verified_sums(capsys.readouterr().out)
    assert set(tsums) == {"baseline", mode}
    assert tsums["baseline"] == jsums["baseline"]
    want = (jsums["baseline"][0], "ok")
    assert tsums[mode] == want
    assert jsums[mode] == (want if mode != "compensated" else ("0",
                                                               "skipped"))


@pytest.mark.parametrize("argv,pattern", [
    (["--mode", "dist", "--shards", "2"], r"--shards 2 > 1 visible shard"),
    (["--mode", "ring", "--no-matnet", "--shards", "3"],
     r"--shards 3 > 1 visible shard"),
    (["--mode", "dist", "--isolate"], "--isolate does not apply"),
    (["--mode", "all", "--shards", "2"], "--shards applies only to"),
])
def test_cli_refuses_unported(tmp_path, capsys, monkeypatch, argv, pattern):
    monkeypatch.delenv("IA_SPGEMM_SHARDS_PER_DEVICE", raising=False)
    path = str(tmp_path / "a.mtx")
    tmmio.write_mtx(path, TCSR.from_scipy(sp.eye(4, format="csr"),
                                          device="cpu"))
    assert tcli.main([path, "--device", "cpu"] + argv) != 0
    assert re.search(pattern, capsys.readouterr().err)


def test_cli_cuda_device_needs_a_gpu(tmp_path, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "a.mtx")
    tmmio.write_mtx(path, TCSR.from_scipy(sp.eye(4, format="csr"),
                                          device="cpu"))
    assert tcli.main([path, "--mode", "bitonic", "--no-matnet"]) == 2
    assert "no CUDA GPU" in capsys.readouterr().err


def test_headline_workload_and_smoke_run(monkeypatch):
    """The headline copies bench.build_matrix; its route runs end to end
    on the CPU at m=256 (host wall time, labelled so)."""
    a, b = headline.build_matrix(m=256), bench.build_matrix(m=256)
    assert (a != b).nnz == 0 and a.nnz == b.nnz
    monkeypatch.setenv("IA_SPGEMM_FUSED_MAX_WIDTH", "256")
    result, C, c_ref = headline.run_headline(m=256, device="cpu", iters=1)
    det = result["detail"]
    assert det["nnz_out"] == c_ref.nnz == int(C.nnz)
    assert det["checksum_rel_err"] <= 1e-4
    assert "host_wall_ms" in det and "device_ms" not in det
    assert det["intermediate_products"] == int(
        np.diff(a.indptr)[a.indices].sum())


def test_hybrid_matrix_copies_jax_skew_matrix():
    from tests.test_route_dispatch import _skew_matrix
    for kw in ({}, {"heavy_every": 100, "heavy_len": 300}):
        a = headline.build_hybrid_matrix(512, **kw)
        b = _skew_matrix(m=512, **kw)
        assert a.nnz == b.nnz and (a != b).nnz == 0


@pytest.fixture(scope="module")
def all_menu_reports():
    """The JAX and the port harness on the CLI's whole `all` menu, one
    small float32 matrix, with a MatNet pick (the JAX side runs its
    Pallas kernels in interpret mode)."""
    a = fixtures.random_csr(24, 24, density=0.2, seed=11, dtype=np.float32)
    kw = dict(iters=1, matnet_pick="csr")
    return (jharness.run_benchmark(JCSR.from_scipy(a), JCSR.from_scipy(a),
                                   tharness.PORTED_ALGORITHMS, **kw),
            tharness.run_benchmark(TCSR.from_scipy(a, device="cpu"),
                                   TCSR.from_scipy(a, device="cpu"),
                                   tharness.PORTED_ALGORITHMS, **kw))


@pytest.mark.parametrize("name", tharness.PORTED_ALGORITHMS)
def test_harness_all_menu_row_matches_jax(all_menu_reports, name):
    """Each row ok / skipped as in the JAX harness, its verified_sum
    within the JAX gates of the baseline (1e-4, serve 2e-2) and of the
    JAX row, and the same memory size."""
    jrep, trep = all_menu_reports
    j, t = jrep.by_name(name), trep.by_name(name)
    assert (t.ok, t.skipped, t.timed_out) == (j.ok, j.skipped, j.timed_out)
    assert not t.error and not j.error, (t.error, j.error)
    base = trep.by_name("baseline").verified_sum
    tol = tharness.SERVE_CHECKSUM_TOL if name == "serve" else 1e-4
    assert abs(t.verified_sum - base) <= tol * max(1.0, abs(base))
    assert t.verified_sum == pytest.approx(j.verified_sum, rel=1e-5,
                                           abs=1e-5)
    assert t.memory_bytes == j.memory_bytes


def test_harness_matnet_verdict_matches_jax(all_menu_reports):
    jrep, trep = all_menu_reports
    assert [r.name for r in trep.results] == [r.name for r in jrep.results]
    assert trep.matnet_pick == jrep.matnet_pick == "csr"
    assert trep.matnet_correct == (trep.winner == "csr")
    text = treport.format_table(trep)
    assert "MatNet pick: csr" in text and "Fastest algorithm:" in text


@pytest.fixture
def int_mtx(tmp_path):
    """A 120 x 120 matrix of small integers: every sum is exact in
    float32 and float64, so both CLIs print the same digits."""
    rng = np.random.default_rng(4)
    a = sp.random(120, 120, density=0.04, format="csr",
                  random_state=np.random.RandomState(4))
    a.data[:] = rng.integers(-3, 4, a.nnz)
    a.eliminate_zeros()
    path = str(tmp_path / "a.mtx")
    tmmio.write_mtx(path, TCSR.from_scipy(a, device="cpu"))
    return path


def _lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def test_cli_all_with_matnet(int_mtx, capsys):
    """The default run: MatNet's pick (the JAX CLI's), every row of the
    menu ok or skipped, the winner and the verdict lines."""
    assert jcli.main([int_mtx, "--mode", "baseline", "--iters", "1"]) == 0
    jpred = _lines(capsys.readouterr().out, "MatNet prediction")
    assert tcli.main([int_mtx, "--device", "cpu", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert _lines(out, "MatNet prediction") == jpred and jpred
    sums = _verified_sums(out)
    assert tuple(sums) == tharness.PORTED_ALGORITHMS
    assert {s for _, s in sums.values()} <= {"ok", "skipped"}
    assert _lines(out, "Fastest algorithm:")
    assert _lines(out, "MatNet pick:")


def test_cli_autotune_matches_jax_cli(int_mtx, capsys):
    args = [int_mtx, "--mode", "autotune", "--iters", "1"]
    assert jcli.main(args) == 0
    jout = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    for prefix in ("MatNet prediction", "ran algorithm", "C:"):
        assert _lines(tout, prefix) == _lines(jout, prefix), prefix


def test_cli_profile_gpu_matches_jax_cli(int_mtx, capsys):
    """P100 weights, B = A^T, the (coo, csr, bitonic) menu."""
    args = [int_mtx, "--profile", "gpu", "--iters", "1"]
    assert jcli.main(args) == 0
    jout = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert _lines(tout, "MatNet prediction") == _lines(jout,
                                                       "MatNet prediction")
    tsums = _verified_sums(tout)
    assert tuple(tsums) == ("baseline", "coo", "csr", "bitonic")
    assert tsums == _verified_sums(jout)


def test_cli_imgs_dir_matches_jax_cli(int_mtx, tmp_path, capsys):
    for main, sub, extra in ((jcli.main, "jax", []),
                             (tcli.main, "port", ["--device", "cpu"])):
        assert main([int_mtx, "--mode", "baseline", "--no-matnet",
                     "--iters", "1", "--imgs-dir",
                     str(tmp_path / sub)] + extra) == 0
    capsys.readouterr()
    for f in ("img1.txt", "img2.txt"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
