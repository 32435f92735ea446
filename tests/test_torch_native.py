"""PyTorch port, the native C++ MatrixMarket parser (io/native.py) and
``read_mtx_to_csr(use_native=...)``: built from native/mtxparse.cpp into
the port's build directory (never into native/), it parses every .mtx
kind the tests write (and a file past 100k entries, the parser's OpenMP
path) to the same header and arrays as the numpy parser and as the JAX
package's reader, bit for bit. Skips where no C++ compiler is found."""

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
