"""PyTorch port, the native C++ MatrixMarket parser (io/native.py) and
``read_mtx_to_csr(use_native=...)``: built from native/mtxparse.cpp into
the port's build directory (never into native/), it parses every .mtx
kind the tests write (and a file past 100k entries, the parser's OpenMP
path) to the same header and arrays as the numpy parser and as the JAX
package's reader, bit for bit. Skips where no C++ compiler is found.

And the port's ``spgemm-run`` binary (``csrc/spgemm_run.cpp``, built by
``cli/binary.py`` into the same directory): ``--help``, and the port's
CLI on the CPU against ``python -m ia_spgemm_tpu_torch.cli``. Skips where
there is no C++ compiler or no ``python3-config --embed``."""

import os
import shutil

import numpy as np
import pytest

from ia_spgemm_tpu.io import mmio as jmmio
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.io import mmio, native
from tests import fixtures


@pytest.fixture(scope="module")
def lib():
    if not any(shutil.which(c) for c in (os.environ.get("CXX"), "g++",
                                         "c++") if c):
        pytest.skip("no C++ compiler")
    assert native.build()
    assert native.available()
    return native.library_path()


def test_builds_into_the_ports_build_directory(lib):
    assert lib.parent.name == "_kernels_build"
    assert lib.parent.parent.name == "ia_spgemm_tpu_torch"
    assert lib.exists() and lib.name.startswith("libmtxparse_")


def _same_parse(path):
    h1, r1, c1, v1 = native.read_mtx(path)
    h2, r2, c2, v2 = mmio.read_mtx(path)
    assert h1 == h2
    for x, y in ((r1, r2), (c1, c2), (v1, v2)):
        np.testing.assert_array_equal(x, y)
    return h1


@pytest.mark.parametrize("kind", fixtures.ALL_KINDS)
def test_native_matches_python(lib, tmp_path, kind):
    _same_parse(fixtures.mtx_file(tmp_path, kind))


def test_native_large_file_parallel_path(lib, tmp_path):
    a = fixtures.random_csr(600, 600, density=0.4, seed=60)
    p = str(tmp_path / "big.mtx")
    mmio.write_mtx(p, CSR.from_scipy(a, device="cpu"))
    assert a.nnz > 100000
    assert _same_parse(p).nnz_stored == a.nnz


@pytest.mark.parametrize("kind", fixtures.ALL_KINDS)
@pytest.mark.parametrize("use_native", [None, True, False])
def test_read_mtx_to_csr_matches_jax(lib, tmp_path, kind, use_native):
    path = fixtures.mtx_file(tmp_path, kind)
    T = mmio.read_mtx_to_csr(path, device="cpu", use_native=use_native)
    J = jmmio.read_mtx_to_csr(path, use_native=False)
    assert T.shape == J.shape and int(T.nnz) == int(J.nnz)
    for f in ("row_ptr", "col_ind", "values"):
        np.testing.assert_array_equal(getattr(T, f).numpy(),
                                      np.asarray(getattr(J, f)), err_msg=f)


def test_native_error_codes(lib, tmp_path):
    p = tmp_path / "bad.mtx"
    p.write_text("%%MatrixMarket matrix coordinate complex general\n"
                 "2 2 1\n1 1 1.0 2.0\n")
    with pytest.raises(mmio.MatrixMarketError, match="COMPLEX"):
        native.read_mtx(str(p))
    with pytest.raises(mmio.MatrixMarketError, match="open"):
        native.read_mtx(str(tmp_path / "missing.mtx"))
    # use_native=True raises the parser's error; None falls back to the
    # numpy reader, which rejects the file with its own
    with pytest.raises(mmio.MatrixMarketError, match="COMPLEX"):
        mmio.read_mtx_to_csr(str(p), device="cpu", use_native=True)
    with pytest.raises(mmio.MatrixMarketError):
        mmio.read_mtx_to_csr(str(p), device="cpu", use_native=None)


def test_use_native_true_raises_without_a_compiler(tmp_path, monkeypatch):
    path = fixtures.mtx_file(tmp_path, "general_real")
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libmtxparse_absent.so")
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "_LIB", None)
    assert not native.available() and not native.build()
    with pytest.raises(RuntimeError, match="could not be built"):
        mmio.read_mtx_to_csr(path, device="cpu", use_native=True)
    # None reads with numpy when the library is absent
    assert int(mmio.read_mtx_to_csr(path, device="cpu").nnz) == 7


# the port's spgemm-run binary (csrc/spgemm_run.cpp, cli/binary.py): a
# C++ main embedding CPython that runs the port's CLI


@pytest.fixture(scope="module")
def spgemm_run():
    from ia_spgemm_tpu_torch.cli import binary
    if binary.toolchain() is None:
        pytest.skip("no C++ compiler or no python3-config --embed")
    return str(binary.build())


def test_binary_builds_into_the_ports_build_directory(spgemm_run):
    from pathlib import Path
    p = Path(spgemm_run)
    assert p.parent.name == "_kernels_build"
    assert p.parent.parent.name == "ia_spgemm_tpu_torch"
    assert p.name.startswith("spgemm-run_") and os.access(p, os.X_OK)


def test_binary_help_names_spgemm_run(spgemm_run, tmp_path):
    """--help exits 0 before any heavy import, from any directory."""
    import subprocess
    out = subprocess.run([spgemm_run, "--help"], capture_output=True,
                         text=True, cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "spgemm-run" in out.stdout and "--device" in out.stdout


def _csr_row(stdout):
    rows = [ln.split() for ln in stdout.splitlines()
            if ln.split()[:1] == ["csr"]]
    assert len(rows) == 1 and rows[0][-1] == "ok", stdout
    return rows[0][4]      # verified_sum, as the table prints it


def test_binary_runs_the_ports_cli_on_the_cpu(spgemm_run, tmp_path):
    """--device cpu --mode csr on a small .mtx: the binary and python -m
    ia_spgemm_tpu_torch.cli exit 0 and print the same checksum, scipy's
    (the baseline row's)."""
    import subprocess
    import sys
    path = str(tmp_path / "a.mtx")
    a = fixtures.random_csr(120, 120, density=0.04, seed=61)
    mmio.write_mtx(path, CSR.from_scipy(a, device="cpu"))
    argv = [path, "--device", "cpu", "--mode", "csr", "--iters", "1",
            "--no-matnet"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = subprocess.run([spgemm_run, *argv], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    want = subprocess.run([sys.executable, "-m", "ia_spgemm_tpu_torch.cli",
                           *argv], capture_output=True, text=True,
                          cwd=root, timeout=300)
    assert got.returncode == 0 and want.returncode == 0, (got.stderr,
                                                          want.stderr)
    assert _csr_row(got.stdout) == _csr_row(want.stdout)
    assert float(_csr_row(got.stdout)) == pytest.approx(
        float((a @ a).sum()), rel=1e-5)
    assert "Fastest algorithm:" in got.stdout
