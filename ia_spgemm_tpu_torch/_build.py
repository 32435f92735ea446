"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source into its own shared library with a plain C
interface, loaded with ``ctypes``; nothing includes PyTorch's headers, so
a build takes seconds, and the sources build in parallel (one ``nvcc``
each, all started together). A library is built at first use, from the
checkout's sources only, into ``_kernels_build/`` beside this file
(listed in ``.gitignore``) under a name keyed on a hash of its source, the
shared headers and the flags: an edited source builds anew, an unchanged
one loads the existing file.
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
_CSRC = _PKG / "csrc"
SOURCES = {"bitonic": _CSRC / "bitonic.cu", "slab": _CSRC / "slab.cu",
           "dense_row": _CSRC / "dense_row.cu", "hash": _CSRC / "hash.cu",
           "ring": _CSRC / "ring.cu"}
HEADERS = (_CSRC / "sort_common.cuh",)
BUILD_DIR = _PKG / "_kernels_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# after the source: ring.cu's stream memory operations come from libcuda
NVCC_LIBS = ("-lcuda",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures per source: pointers and the stream as void*, sizes as
# int (K13's copy table and its stream operations: each the address of
# a host array of long long), addresses passed by value as long long;
# every entry point returns a cudaError_t as int (ia_k13_stream_ops a
# CUresult, ia_k13_can_wait 1 / 0 or a negative CUresult).
SIGNATURES = {
    "bitonic": {
        "ia_k1_expand_sort_compress": [_P] * 5 + [_I] * 8 + [_P],
        "ia_k2_expand_sort": [_P] * 4 + [_I] * 7 + [_P],
        "ia_k2_expand_sort_table": [_P] * 5 + [_I] * 6 + [_P],
        "ia_k3_compress": [_P] * 5 + [_I] * 4 + [_P],
        "ia_k3_compress_f64": [_P] * 5 + [_I] * 4 + [_P],
        "ia_k4_sort_compress_rows": [_P] * 5 + [_I] * 3 + [_P],
        "ia_k4_sort_compress_rows_f64": [_P] * 5 + [_I] * 3 + [_P],
        "ia_k5_sort_compress": [_P] * 5 + [_I] * 4 + [_P],
        "ia_k5_sort_compress_f64": [_P] * 5 + [_I] * 4 + [_P],
        "ia_k6_sort": [_P] * 4 + [_I] * 3 + [_P],
        "ia_k6_sort_f64": [_P] * 4 + [_I] * 3 + [_P],
        "ia_k7a_expand_sort_packed": [_P] * 4 + [_I] * 6 + [_P],
        "ia_k7b_compress_packed": [_P] * 4 + [_I] * 4 + [_P],
    },
    "dense_row": {"ia_k11_dense_row": [_P] * 4 + [_I] * 3 + [_P],
                  "ia_k11_dense_row_f64": [_P] * 4 + [_I] * 3 + [_P]},
    "hash": {"ia_k12_hash": [_P] * 7 + [_I] * 4 + [_P]},
    "ring": {"ia_k13_ring_hop": [_P, _I, _P],
             "ia_k13_ring_hop_xproc": [_P, _I, _L, _L, _P],
             "ia_k13_stream_ops": [_P, _I, _P],
             "ia_k13_can_wait": [_I],
             "ia_k13_load_kernels": [],
             "ia_k13_host_map": [_L, _L, _P],
             "ia_k13_host_unmap": [_L],
             "ia_k13_enable_peer_access": [_I]},
    "slab": {
        "ia_k8_expand_sort_lr": [_P] * 6 + [_I] * 7 + [_P],
        "ia_k9_expand_sort_lr_dd": [_P] * 6 + [_I] * 7 + [_P],
        "ia_k10_compress_dd": [_P] * 6 + [_I] * 2 + [_P],
    },
}

_fns = None
build_seconds = None   # wall seconds of this process's build, None if loaded


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (PATH or CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + NVCC_LIBS).encode())
    for src in HEADERS + (SOURCES[name],):
        h.update(src.read_bytes())
    return BUILD_DIR / f"libia_spgemm_{name}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source whose keyed library is missing, all at once;
    returns {source name: library path}. Each compiler's register /
    shared-memory report is kept beside its library as ``<name>.log``.
    Raises RuntimeError with nvcc's output on a failure."""
    global build_seconds
    paths = {name: library_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for name, out in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name]),
               *NVCC_LIBS]
        jobs[name] = (cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (cmd, tmp, out, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)   # atomic: a concurrent build never sees a stub
    if failed:
        raise RuntimeError("\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return paths


def load() -> dict:
    """{entry point name: ctypes function} of every kernel library, built
    on first use and loaded once."""
    global _fns
    if _fns is None:
        fns = {}
        for name, path in build().items():
            lib = ctypes.CDLL(str(path))
            for fname, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[fname] = fn
        _fns = fns
    return _fns
