"""ctypes bindings to the native C++ MatrixMarket parser (PyTorch port
of ``ia_spgemm_tpu.io.native``).

The reference's I/O layer is C (mmio.c); the repository's is a C++
shared library built from ``native/mtxparse.cpp``. This module compiles
that source with the host C++ compiler (``$CXX``, else ``g++`` or
``c++``; OpenMP on) into the port's git-ignored build directory
(``_kernels_build/``, under a name keyed on the source's hash), never
into ``native/``, and loads it with ctypes under the JAX package's C
signature. ``mmio.read_mtx_to_csr(use_native=...)`` chooses between it
and the numpy reader, which gives the same arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "mtxparse.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_kernels_build"
_CXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-Wall", "-std=c++17", "-shared")

_LIB: Optional[ctypes.CDLL] = None


def _compiler() -> Optional[str]:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_DIR / f"libmtxparse_{h.hexdigest()[:16]}.so"


def build() -> bool:
    """Compile the parser if it is not built yet; False when there is no
    compiler or the compile fails (its output is kept beside the library
    as ``.log``)."""
    out = library_path()
    if out.exists():
        return True
    cxx = _compiler()
    if cxx is None:
        return False
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", tmp, str(_SOURCE)],
                          capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        return False
    os.replace(tmp, out)    # atomic: a concurrent build never sees a stub
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is None and library_path().exists():
        lib = ctypes.CDLL(str(library_path()))
        lib.mtx_parse.restype = ctypes.c_int
        lib.mtx_parse.argtypes = [
            ctypes.c_char_p,                     # path
            ctypes.POINTER(ctypes.c_longlong),   # nrows
            ctypes.POINTER(ctypes.c_longlong),   # ncols
            ctypes.POINTER(ctypes.c_longlong),   # nnz (stored)
            ctypes.POINTER(ctypes.c_int),        # field 0=real 1=int 2=pattern
            ctypes.POINTER(ctypes.c_int),        # symmetry 0=gen 1=sym 2=skew
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),     # rows out
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),     # cols out
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),  # vals out
        ]
        lib.mtx_free.restype = None
        lib.mtx_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the parser is built (this does not start a compiler)."""
    return _load() is not None


_FIELD_NAMES = {0: "real", 1: "integer", 2: "pattern"}
_SYM_NAMES = {0: "general", 1: "symmetric", 2: "skew-symmetric"}
_ERRORS = {-1: "cannot open file", -2: "bad banner",
           -3: "data type 'COMPLEX' is not supported",
           -4: "bad size line", -5: "bad entry", -6: "out of memory"}


def read_mtx(path: str) -> Tuple:
    """Parse with the native library: (MatrixMarketHeader, rows, cols,
    vals), as ``mmio.read_mtx`` returns them."""
    from ia_spgemm_tpu_torch.io.mmio import (MatrixMarketError,
                                             MatrixMarketHeader)

    lib = _load()
    if lib is None:
        raise RuntimeError("native parser not built (native.build())")
    nrows, ncols, nnz = (ctypes.c_longlong() for _ in range(3))
    field, sym = ctypes.c_int(), ctypes.c_int()
    rows_p = ctypes.POINTER(ctypes.c_int)()
    cols_p = ctypes.POINTER(ctypes.c_int)()
    vals_p = ctypes.POINTER(ctypes.c_double)()
    rc = lib.mtx_parse(str(path).encode(), ctypes.byref(nrows),
                       ctypes.byref(ncols), ctypes.byref(nnz),
                       ctypes.byref(field), ctypes.byref(sym),
                       ctypes.byref(rows_p), ctypes.byref(cols_p),
                       ctypes.byref(vals_p))
    if rc != 0:
        raise MatrixMarketError(f"{_ERRORS.get(rc, 'parse error')} "
                                f"({path})")
    n = nnz.value
    try:
        if n:
            rows = np.ctypeslib.as_array(rows_p, shape=(n,)).copy()
            cols = np.ctypeslib.as_array(cols_p, shape=(n,)).copy()
            vals = np.ctypeslib.as_array(vals_p, shape=(n,)).copy()
        else:
            rows = np.zeros(0, np.int32)
            cols = np.zeros(0, np.int32)
            vals = np.zeros(0, np.float64)
    finally:
        lib.mtx_free(rows_p)
        lib.mtx_free(cols_p)
        lib.mtx_free(vals_p)
    header = MatrixMarketHeader(
        "matrix", "coordinate", _FIELD_NAMES[field.value],
        _SYM_NAMES[sym.value], int(nrows.value), int(ncols.value), n)
    return header, rows, cols, vals
