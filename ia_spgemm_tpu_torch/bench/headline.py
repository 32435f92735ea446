"""Headline run of the port: the counterpart of ``bench.py``'s
``multiclass_pg`` route, on the same workload. Prints one JSON line.

Workload: C = A @ A in float32 on ``build_matrix()`` (m=32768, a banded +
random matrix: 556,940 nnz, 9,467,057 intermediate products, 7,086,306
output nnz). Route: CSR -> ELL, then the width-class pipeline with the
fragment gather done at plan time (``multiclass_planned(assemble="bcsr",
pregather=True, run_override=<pg_run>, out_width=<observed>)``), the
tuning ``reports/bench_tuning.json`` records (fused width 512, run 8).

Metrics: the route's median time per call over CUDA events (device time
of one call, plan excluded, as in bench.py), GFLOPS = 2 * products / time
(main.cpp:989), scipy's host CSR@CSR time, and the checksum's relative
error against scipy. On the CPU (plain versions) the time is host wall
time and is reported as such.

    python -m ia_spgemm_tpu_torch.bench.headline [--m M] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]


def build_matrix(m=32768, band=4, extra_per_row=8, seed=0):
    """Banded + random off-band entries (a copy of bench.build_matrix)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(m) for _ in range(2 * band + 1)]
    a = sp.diags(diags, list(range(-band, band + 1)),
                 shape=(m, m), format="coo")
    nnz_extra = m * extra_per_row
    rows = rng.integers(0, m, nnz_extra)
    cols = rng.integers(0, m, nnz_extra)
    vals = rng.standard_normal(nnz_extra)
    b = sp.coo_matrix((vals, (rows, cols)), shape=(m, m))
    out = (a + b).tocsr()
    out.sum_duplicates()
    return out


def build_skew_matrix(m=4096, seed=0,
                      heavy=((61, 100), (127, 200), (251, 600))):
    """Row-skewed float32 matrix for the wide classes: light rows of 1-7
    entries, and every `every`-th row with `length` entries, all columns
    among the light rows. A @ A then plans (at run 8) into width classes
    128, 1024, 2048 and 8192: K1 on the first, K2 + K3 on 1024, K4 on the
    two wide ones."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 8, m)
    is_heavy = np.zeros(m, bool)
    for every, length in heavy:
        lens[::every] = length
        is_heavy[::every] = True
    light = np.nonzero(~is_heavy)[0]
    rows = np.repeat(np.arange(m), lens)
    cols = np.concatenate([rng.choice(light, size=n, replace=False)
                           for n in lens])
    return sp.coo_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(m, m)).tocsr().astype(np.float32)


def build_hybrid_matrix(m, heavy_every=300, heavy_len=1500, seed=3):
    """A few huge rows among short ones (a copy of the JAX package's
    tests/test_route_dispatch.py _skew_matrix): the heavy rows exceed the
    tiled route's width cap and the slab width cap, so plan_csr_auto
    routes C = A @ A to the slab + global hybrid."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 6, m)
    lens[::heavy_every] = heavy_len
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.shape[0])
    a = sp.coo_matrix((rng.standard_normal(rows.shape[0]), (rows, cols)),
                      shape=(m, m)).tocsr()
    a.sum_duplicates()
    return a


def observed_out_width(nnz_row, cap: int) -> int:
    """Smallest pow2 >= 128 holding the widest output row, capped."""
    out_w = 128
    mx = int(np.max(np.asarray(nnz_row)))
    while out_w < mx:
        out_w *= 2
    return min(out_w, cap)


def apply_bench_tuning() -> dict:
    """Read reports/bench_tuning.json (as bench.py does) and adopt its
    fused width unless IA_SPGEMM_FUSED_MAX_WIDTH is set. Takes effect only
    when it runs before ia_spgemm_tpu_torch.ops.bitonic is imported (the
    width is read at import)."""
    with open(_REPO / "reports" / "bench_tuning.json") as f:
        tuning = json.load(f)
    os.environ.setdefault("IA_SPGEMM_FUSED_MAX_WIDTH",
                          str(int(tuning["fused_max_width"])))
    return tuning


def plan_headline(A):
    """The headline route's planned call on CSR ``A`` (C = A @ A, on A's
    device): CSR -> ELL, one unpinned call to observe the output width,
    then the pinned plan. Returns (call, out_w, plan seconds)."""
    tuning = apply_bench_tuning()
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.ops import bitonic

    A_ell = convert.csr_to_ell(A, check_guard=False)
    call0 = bitonic.multiclass_planned(A_ell, A_ell, assemble="bcsr")
    out_w = observed_out_width(call0().nnz_row.cpu(), call0.widths[-1])
    t0 = time.perf_counter()
    call = bitonic.multiclass_planned(
        A_ell, A_ell, assemble="bcsr", out_width=out_w, pregather=True,
        run_override=tuning.get("pg_run"))
    return call, out_w, time.perf_counter() - t0


def run_headline(m: int = 32768, device: str = "cuda", iters: int = 20):
    """Plan and time the headline route. Returns (result dict, C, scipy
    reference C)."""
    apply_bench_tuning()
    import torch

    from ia_spgemm_tpu_torch.bench.harness import time_ms
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.ops import bitonic
    from ia_spgemm_tpu_torch.ops.flops import get_flop

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but no GPU is available")
    a = build_matrix(m=m)
    c_ref = a @ a
    scipy_ms = time_ms(lambda: a @ a, torch.device("cpu"), warmup=0,
                       iters=5)
    ref_sum = float(c_ref.sum())

    A = CSR.from_scipy(a.astype(np.float32), device=dev)
    flops = get_flop(A, A)
    call, out_w, plan_s = plan_headline(A)
    C = call()
    ms = time_ms(call, dev, warmup=1, iters=iters)
    rel = abs(float(C.checksum()) - ref_sum) / max(1.0, abs(ref_sum))
    timer = "device_ms" if dev.type == "cuda" else "host_wall_ms"
    result = {
        "metric": "spgemm_gflops",
        "value": 2.0 * flops / (ms * 1e6),
        "unit": "GFLOPS",
        "vs_baseline": scipy_ms / ms,
        "detail": {
            "route": "multiclass_pg",
            "m": A.nrows, "nnz": int(A.nnz),
            "intermediate_products": flops,
            "nnz_out": int(C.nnz),
            timer: ms,
            "scipy_ms": scipy_ms,
            "checksum_rel_err": rel,
            "plan_seconds": plan_s,
            "widths": list(call.widths), "run": call.run,
            "out_width": out_w,
            "fused_max_width": bitonic.FUSED_MAX_WIDTH,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
        },
    }
    return result, C, c_ref


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--m", type=int, default=32768)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    result, _, _ = run_headline(m=args.m, device=args.device,
                                iters=args.iters)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
