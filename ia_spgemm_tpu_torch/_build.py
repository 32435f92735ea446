"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles the sources into a shared library with a plain C
interface, loaded with ``ctypes``; nothing includes PyTorch's headers, so
a build takes seconds. The library is built at first use, from the
checkout's sources only, into ``_kernels_build/`` beside this file (listed
in ``.gitignore``) under a name keyed on a hash of the sources and flags:
an edited source builds anew, an unchanged one loads the existing file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "bitonic.cu",)
BUILD_DIR = _PKG / "_kernels_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/bitonic.cu: pointers and the stream as void*,
# sizes as int; every entry point returns a cudaError_t as int.
SIGNATURES = {
    "ia_k1_expand_sort_compress": [_P] * 5 + [_I] * 8 + [_P],
    "ia_k2_expand_sort": [_P] * 4 + [_I] * 7 + [_P],
    "ia_k3_compress": [_P] * 5 + [_I] * 4 + [_P],
    "ia_k4_sort_compress_rows": [_P] * 5 + [_I] * 3 + [_P],
}

_lib = None
build_seconds = None   # wall seconds of this process's build, None if loaded


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (PATH or CUDA_HOME)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libia_spgemm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the keyed library exists; returns its
    path. The compiler's register/shared-memory report is kept beside it
    as ``<name>.log``. Raises RuntimeError with nvcc's output on failure."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}"
                           f"\n{r.stdout}\n{r.stderr}")
    out.with_suffix(".log").write_text(r.stdout + r.stderr)
    os.replace(tmp, out)     # atomic: a concurrent build never sees a stub
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
