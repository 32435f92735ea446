"""PyTorch port, the process-isolated watchdog (bench/isolated.py and the
CLI's --isolate) on --device cpu: the port's counterpart of
tests/test_watchdog.py. A row that times out is killed with its process
group and must not hold back the row after it."""

import os
import subprocess
import time

import numpy as np
import pytest
import scipy.sparse as sp

from ia_spgemm_tpu_torch.bench import harness
from ia_spgemm_tpu_torch.bench import isolated as iso
from ia_spgemm_tpu_torch.cli import main as tcli
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.io import mmio


def _small(dtype=np.float64):
    a = sp.random(64, 64, density=0.05, format="csr", dtype=dtype,
                  random_state=np.random.RandomState(0))
    a.sum_duplicates()
    return a


@pytest.mark.parametrize("name", ["bitonic", "csr"])
def test_isolated_row_reports_like_in_process(name):
    """The worker's row (float64 CSR: the flat cols route for bitonic)
    has the in-process row's checksum and sizes."""
    A = CSR.from_scipy(_small())
    res = iso.bench_algorithm_isolated(A, A, name, timeout_s=None,
                                       iters=2, device="cpu")
    want = harness.run_benchmark(A, A, ("baseline", name), iters=1)
    assert res.ok and res.error == "" and not res.timed_out
    assert res.run_time_ms > 0
    base = want.by_name("baseline").verified_sum
    assert abs(res.verified_sum - base) <= 1e-9 * max(1.0, abs(base))
    assert res.verified_sum == want.by_name(name).verified_sum
    assert res.memory_bytes == want.by_name(name).memory_bytes


def test_timeout_kills_the_process_group_and_next_row_is_clean(
        monkeypatch):
    """_test_slow never finishes: it times out within its budget, its
    process group is gone, and the next isolated row runs normally."""
    started = []
    popen = subprocess.Popen

    def spy(*a, **kw):
        started.append(popen(*a, **kw))
        return started[-1]
    monkeypatch.setattr(iso.subprocess, "Popen", spy)
    monkeypatch.setattr(iso, "STARTUP_GRACE_S", 2.0)
    A = CSR.from_scipy(_small())
    t0 = time.perf_counter()
    res = iso.bench_algorithm_isolated(A, A, "_test_slow", timeout_s=1.0,
                                       iters=1, device="cpu")
    elapsed = time.perf_counter() - t0
    assert res.timed_out and not res.ok
    assert res.run_time_ms == 0.0          # zeroed, main.cpp:778-793
    assert elapsed < 20.0
    proc = started[0]
    assert proc.returncode is not None
    with pytest.raises(ProcessLookupError):
        os.killpg(proc.pid, 0)

    res2 = iso.bench_algorithm_isolated(A, A, "bitonic", timeout_s=None,
                                        iters=1, device="cpu")
    assert res2.ok and res2.error == ""
    assert res2.run_time_ms < 10_000.0


def test_grace_constant_sane():
    assert iso.STARTUP_GRACE_S >= 30.0


def test_run_benchmark_isolate_reports_errors_and_skips():
    """A row off the menu comes back as the worker's error, a row its
    guard skips as skipped, both without raising."""
    A = CSR.from_scipy(_small())
    rep = harness.run_benchmark(A, A, ("baseline", "dist", "hash"),
                                iters=1, isolate=True,
                                isolate_device="cpu")
    assert rep.by_name("baseline").ok
    assert "unknown algorithm" in rep.by_name("dist").error
    assert rep.by_name("hash").skipped      # float32 only


@pytest.fixture
def int_mtx(tmp_path):
    rng = np.random.default_rng(4)
    a = sp.random(120, 120, density=0.04, format="csr",
                  random_state=np.random.RandomState(4))
    a.data[:] = rng.integers(-3, 4, a.nnz)
    a.eliminate_zeros()
    path = str(tmp_path / "a.mtx")
    mmio.write_mtx(path, CSR.from_scipy(a))
    return path


def _row(out, name):
    return [ln.split() for ln in out.splitlines()
            if ln.split()[:1] == [name]]


def test_cli_isolate_runs_on_cpu(int_mtx, capsys):
    """--isolate prints the in-process run's row (small-integer values:
    exact sums)."""
    args = [int_mtx, "--mode", "bitonic", "--no-matnet", "--iters", "1",
            "--device", "cpu"]
    assert tcli.main(args) == 0
    plain = _row(capsys.readouterr().out, "bitonic")
    assert tcli.main(args + ["--isolate"]) == 0
    isolated = _row(capsys.readouterr().out, "bitonic")
    assert len(isolated) == 1 and isolated[0][-1] == "ok"
    assert isolated[0][4] == plain[0][4]       # verified_sum


def test_cli_isolate_keeps_shards_refused(int_mtx, capsys):
    assert tcli.main([int_mtx, "--device", "cpu", "--isolate",
                      "--shards", "2"]) == 2
    assert "--shards is not ported" in capsys.readouterr().err
