"""Process-isolated algorithm benchmarking: a watchdog that can kill
(PyTorch port of ``ia_spgemm_tpu.bench.isolated``).

The reference cancels a slow algorithm with pthread_cancel
(main.cpp:43-93,770-775), which stops the work. A CUDA kernel cannot be
cancelled from Python once it is launched: the harness's in-process
watchdog (``harness._run_with_timeout``) stops waiting on a hung row, but
the kernel keeps the card busy and every later row queues behind it.

Here each algorithm runs in its own subprocess, in its own session (so
its own process group). On timeout the parent kills exactly the process
group it started, never by pattern; the worker's CUDA context dies with
it and the card is clean for the next row. The worker measures
inside itself (CUDA events, as ``harness._bench_one`` does) and sends one
JSON line back, so its start-up never enters the reported times.

The worker never builds the kernels: on a CUDA device the parent builds
the libraries first (``_build.build``, keyed on the sources' hash), and
the worker only loads them. The parent may hold a CUDA context while
workers run on the same card; that needs the card's default compute mode
(``nvidia-smi --query-gpu=compute_mode``), not EXCLUSIVE_PROCESS.

    python -m ia_spgemm_tpu_torch.bench.isolated MATS.npz ALG \\
        [--iters N] [--device cuda|cpu]

runs one worker by hand (MATS.npz as ``bench_algorithm_isolated`` writes
it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]

# Start-up allowance on top of the row's watchdog budget: the worker's
# interpreter start, the torch and scipy imports, CUDA context creation
# and loading the prebuilt kernel libraries. On an H100 host an isolated
# bitonic row took 9-11 s from the worker's start to its result line
# (chip_smoke.py, phase 21), nearly all of it start-up: the row's own
# runs take milliseconds. 60 s leaves room for a loaded host. The
# reference's 20x-baseline scale applies to the runs that follow.
STARTUP_GRACE_S = 60.0


def _dump_csr(z: dict, prefix: str, M) -> None:
    z[f"{prefix}_row_ptr"] = M.row_ptr.cpu().numpy()
    z[f"{prefix}_col_ind"] = M.col_ind.cpu().numpy()
    z[f"{prefix}_values"] = M.values.cpu().numpy()
    z[f"{prefix}_nnz"] = np.asarray(int(M.nnz))
    z[f"{prefix}_shape"] = np.asarray(M.shape)


def _load_csr(z, prefix: str, device):
    from ia_spgemm_tpu_torch.formats.types import CSR
    return CSR.from_numpy(z[f"{prefix}_row_ptr"], z[f"{prefix}_col_ind"],
                          z[f"{prefix}_values"], int(z[f"{prefix}_nnz"]),
                          tuple(int(x) for x in z[f"{prefix}_shape"]),
                          device)


def bench_algorithm_isolated(A, B, name: str, *,
                             timeout_s: Optional[float], iters: int = 3,
                             device: Optional[str] = None):
    """Benchmark one algorithm in a killable subprocess on ``device``
    ("cuda" or "cpu"; default: A's device type).

    Returns an AlgorithmResult. timeout_s bounds the worker's whole wall
    time at timeout_s + STARTUP_GRACE_S (None: no bound); past it the
    worker's process group is killed and the result reports
    timed_out=True with zeroed times, like the reference's cancelled
    threads (main.cpp:778-793)."""
    from ia_spgemm_tpu_torch.bench.harness import AlgorithmResult

    device = device or A.device.type
    if device == "cuda":
        from ia_spgemm_tpu_torch import _build
        _build.build()
    res = AlgorithmResult(name=name)
    with tempfile.TemporaryDirectory(prefix="ia_spgemm_iso_") as td:
        path = os.path.join(td, "mats.npz")
        z: dict = {}
        _dump_csr(z, "a", A)
        _dump_csr(z, "b", B)
        np.savez(path, **z)
        cmd = [sys.executable, "-m", "ia_spgemm_tpu_torch.bench.isolated",
               path, name, "--iters", str(iters), "--device", device]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(_REPO), env.get("PYTHONPATH")) if p)
        budget = None if timeout_s is None else timeout_s + STARTUP_GRACE_S
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True, env=env)
        try:
            out, err = proc.communicate(timeout=budget)
        except subprocess.TimeoutExpired:
            # kill the exact process group this call started
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.communicate()
            res.timed_out = True
            return res
    if proc.returncode != 0:
        res.error = (err or "").strip()[-500:] or \
            f"worker exited {proc.returncode}"
        return res
    line = out.strip().splitlines()[-1] if out.strip() else "{}"
    try:
        payload = json.loads(line)
    except json.JSONDecodeError:
        res.error = f"unparseable worker output: {line[:200]}"
        return res
    for f in dataclasses.fields(res):
        if f.name in payload:
            setattr(res, f.name, payload[f.name])
    return res


def _worker_main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("matrices")
    ap.add_argument("algorithm")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.algorithm == "_test_slow":
        # test hook: a row that never finishes (stands in for a kernel
        # that hangs the card; tests/test_torch_isolated.py)
        import time
        time.sleep(3600)
        return 0

    import torch

    from ia_spgemm_tpu_torch import config as cfg
    from ia_spgemm_tpu_torch.bench.harness import AlgorithmResult, _bench_one

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("worker: --device cuda but no CUDA GPU", file=sys.stderr)
        return 2
    z = np.load(args.matrices)
    A = _load_csr(z, "a", device)
    B = _load_csr(z, "b", device)
    res = AlgorithmResult(name=args.algorithm)
    try:
        # no inner watchdog: the parent's process-group kill is the timeout
        _bench_one(args.algorithm, A, B, cfg.DEFAULT_CONFIG, None, res,
                   args.iters)
    except Exception as e:  # noqa: BLE001 - ship the error as the row's
        res.error = f"{type(e).__name__}: {e}"
    print(json.dumps(dataclasses.asdict(res)))
    return 0


if __name__ == "__main__":
    raise SystemExit(_worker_main(sys.argv[1:]))
