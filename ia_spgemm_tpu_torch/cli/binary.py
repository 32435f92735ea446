"""The port's ``spgemm-run`` binary (``csrc/spgemm_run.cpp``): a C++ main
that embeds CPython and runs ``ia_spgemm_tpu_torch.cli.main``, the
reference's architecture (a native main around the Python selector).

It is built at first use with the host C++ compiler (``$CXX``, else
``g++`` or ``c++``) and the embedding flags of the interpreter running
this module (``python3-config --includes`` and ``--embed --ldflags``:
the ``pythonX.Y-config`` or ``python3-config`` beside ``sys.executable``
or under ``sys.base_prefix``, else on PATH), into the package's
git-ignored ``_kernels_build/``, under a name keyed on the source, the
flags, the interpreter and the checkout's root. The binary starts that
interpreter (``sys.executable`` at build time) and imports the package
from that root, whatever the working directory.

    python -m ia_spgemm_tpu_torch.cli.binary     # build; print the path
    $(python -m ia_spgemm_tpu_torch.cli.binary) A.mtx --mode all
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from ia_spgemm_tpu_torch.io.native import _compiler

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "spgemm_run.cpp"
BUILD_DIR = _PKG / "_kernels_build"
_CXX_FLAGS = ("-O2", "-Wall", "-std=c++17")


def _python_config() -> str | None:
    """The python-config of the running interpreter."""
    names = (f"python{sys.version_info.major}.{sys.version_info.minor}"
             "-config", "python3-config")
    for d in (Path(sys.executable).parent, Path(sys.base_prefix) / "bin"):
        for name in names:
            if (d / name).is_file():
                return str(d / name)
    for name in names:
        if shutil.which(name):
            return shutil.which(name)
    return None


def toolchain() -> tuple[str, list[str], list[str]] | None:
    """(compiler, compile flags, link flags) that embed this interpreter,
    or None where there is no C++ compiler or no python-config that
    gives the embedding flags."""
    cxx, cfg = _compiler(), _python_config()
    if cxx is None or cfg is None:
        return None
    out = []
    for args in (["--includes"], ["--embed", "--ldflags"]):
        proc = subprocess.run([cfg, *args], capture_output=True, text=True)
        if proc.returncode != 0:
            return None
        out.append(proc.stdout.split())
    includes, ldflags = out
    # the library directories also at run time, where the loader's own
    # search path lacks them
    rpath = [f"-Wl,-rpath,{f[2:]}" for f in ldflags if f.startswith("-L")]
    root = str(_PKG.parent)
    defines = [f"-DSPGEMM_PYTHON_EXE={json.dumps(sys.executable)}",
               f"-DSPGEMM_PACKAGE_ROOT={json.dumps(root)}"]
    return cxx, [*_CXX_FLAGS, *includes, *defines], [*ldflags, *rpath]


def binary_path(cflags: list[str], ldflags: list[str]) -> Path:
    h = hashlib.sha256(" ".join(cflags + ldflags).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"spgemm-run_{h.hexdigest()[:16]}"


def build() -> Path:
    """The binary's path, compiled first if it is not built yet. Raises
    RuntimeError where there is no toolchain (``toolchain``) or the
    compile fails (with the compiler's output, also kept beside the
    binary as ``.log``)."""
    tc = toolchain()
    if tc is None:
        raise RuntimeError("spgemm-run needs a C++ compiler and the "
                           "interpreter's embedding flags (python3-config "
                           "--embed)")
    cxx, cflags, ldflags = tc
    out = binary_path(cflags, ldflags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR)
    os.close(fd)
    # the libraries after the source, where the linker looks for them
    cmd = [cxx, *cflags, "-o", tmp, str(SOURCE), *ldflags]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout
                                       + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building spgemm-run failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.chmod(tmp, 0o755)
    os.replace(tmp, out)    # atomic: a concurrent build never sees a stub
    return out


if __name__ == "__main__":
    print(build())
