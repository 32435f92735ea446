"""The port's headline benchmark: the counterpart of ``bench.py``. Prints
one JSON line.

Workload: C = A @ A in float32 on ``build_matrix()`` (m=32768, a banded +
random matrix: 556,940 nnz, 9,467,057 intermediate products, 7,086,306
output nnz; m=256 under IA_SPGEMM_BENCH_SMOKE=1).

``run_bench`` (the default) is ``bench.py``'s main: every candidate route
(flat bitonic, width classes, width classes with the fragment gather at
plan time, slab; the global ESC when nothing else ran or in smoke mode),
each checked against scipy and timed, the winner by device ms, its
pipelined wall as the headline time, GFLOPS = 2 * products / time
(main.cpp:989), ``vs_baseline`` against scipy's host CSR@CSR, the serving
modes of the flat plan and the rooflines, under bench.py's keys.
``--route multiclass_pg`` times that route alone (``run_headline``:
CSR -> ELL, ``multiclass_planned(assemble="bcsr", pregather=True,
run_override=<pg_run>, out_width=<observed>)``, median over CUDA events).
Both adopt the tuning ``reports/bench_tuning.json`` records (fused width
512, run 8) unless IA_SPGEMM_FUSED_MAX_WIDTH is set.

The run is on the card unless ``--device cpu`` is given (the plain
versions; times on the host clock). Without a card, or when a kernel
fails to build or launch, the line is bench.py's structured error line
and the exit code 1.

    python -m ia_spgemm_tpu_torch.bench.headline [--m M] [--device cuda|cpu]
        [--route multiclass_pg [--iters N]]
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


TUNING_PATH = _REPO / "reports" / "bench_tuning.json"
_ADOPTED: dict | None = None    # the tuning this module put in the environment


def read_bench_tuning() -> dict | None:
    """reports/bench_tuning.json (the A/B pick of fused width and pg_run
    that bench.py adopts), or None when it is missing or unreadable."""
    try:
        with open(TUNING_PATH) as f:
            tuning = json.load(f)
        int(tuning["fused_max_width"])
        return tuning
    except (OSError, ValueError, KeyError, TypeError):
        return None


def apply_bench_tuning() -> dict | None:
    """bench.py's _apply_bench_tuning: adopt the tuning's fused width as
    IA_SPGEMM_FUSED_MAX_WIDTH and return the tuning; None when the
    variable was set otherwise (an explicit width wins) or the file is
    missing or unreadable. A later call returns the tuning it adopted.
    Takes effect only before ia_spgemm_tpu_torch.ops.bitonic is imported
    (the width is read at import)."""
    global _ADOPTED
    env = os.environ.get("IA_SPGEMM_FUSED_MAX_WIDTH")
    if _ADOPTED is not None and env == str(int(_ADOPTED["fused_max_width"])):
        return _ADOPTED
    if env:
        return None
    tuning = read_bench_tuning()
    if tuning is not None:
        os.environ["IA_SPGEMM_FUSED_MAX_WIDTH"] = str(
            int(tuning["fused_max_width"]))
    _ADOPTED = tuning
    return tuning


def plan_headline(A):
    """The headline route's planned call on CSR ``A`` (C = A @ A, on A's
    device): CSR -> ELL, one unpinned call to observe the output width,
    then the pinned plan. Returns (call, out_w, plan seconds)."""
    apply_bench_tuning()
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.ops import bitonic

    A_ell = convert.csr_to_ell(A, check_guard=False)
    call0 = bitonic.multiclass_planned(A_ell, A_ell, assemble="bcsr")
    out_w = observed_out_width(call0().nnz_row.cpu(), call0.widths[-1])
    t0 = time.perf_counter()
    call = bitonic.multiclass_planned(
        A_ell, A_ell, assemble="bcsr", out_width=out_w, pregather=True,
        run_override=(read_bench_tuning() or {}).get("pg_run"))
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


def card_name() -> str | None:
    """The card's name and power limit, from nvidia-smi (no CUDA
    context); None where nvidia-smi gives none."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_bench(m: int = 32768, device: str = "cuda", smoke: bool = False,
              chip=None) -> dict:
    """bench.py's main on the port: every candidate route of C = A @ A on
    ``build_matrix(m)`` (float32), each checked against scipy and timed,
    the winner by device ms, its pipelined wall as the headline, the
    serving modes of the flat plan and the rooflines. Returns bench.py's
    JSON object, every key of it with the same meaning.

    Routes (each with its plan seconds, ``plan_seconds``, and its cost
    model): ``bitonic`` (the flat plan, pinned to the observed out
    width), ``multiclass`` (width classes, BlockCSR out; its
    ``multiclass_call`` seconds count, as bench.py does, both planned
    calls, the first call and the route's measurement), ``multiclass_pg``
    (the same with the fragment gather at plan time, at the tuning's
    pg_run; the planner's run when smoke), ``slab``, and the global-sort
    ESC only when no other route ran or when smoke. Each route: one first
    call, the median wall of 5 synchronised calls, device ms from
    ``profiling.device_time_ms(chain=8)`` (CUDA events around 8 calls:
    it includes any time the card waits on the host between them, so it
    is not the card's busy time), and the checksum's relative error
    against scipy. The winner's ``wall_decomposition`` gives ``ours_ms``,
    the pipelined wall. The serving modes of the flat plan (``compact=
    False``; ``value_mode="bf16"``; both) are device ms, None where the
    mode does not apply.

    ``device`` is the card unless "cpu" is named; without a card this
    raises. On the CPU the plain versions run and every "device" time is
    the host clock (``device`` reads "cpu"). ``chip``: the peaks the
    rooflines read (default: ``roofline.detect_chip`` on the card; on
    the CPU None, and then no roofline)."""
    tuning = apply_bench_tuning()
    import torch

    from ia_spgemm_tpu_torch.bench import profiling, roofline
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.ops import bitonic, esc
    from ia_spgemm_tpu_torch.ops import slab as slab_mod

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but no GPU is available: "
                           "pass --device cpu to run the plain versions")
    if chip is None and dev.type == "cuda":
        chip = roofline.detect_chip(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    a = build_matrix(m=m)
    A = CSR.from_scipy(a.astype(np.float32), device=dev)
    plan_seconds = {}
    t_plan = time.perf_counter()
    esc_plan = esc.plan_spgemm(A, A)
    plan_seconds["esc"] = time.perf_counter() - t_plan

    # baseline: scipy CSR @ CSR on the host
    c_ref = a @ a
    scipy_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        a @ a
        scipy_times.append((time.perf_counter() - t0) * 1e3)
    scipy_ms = float(np.median(scipy_times))
    ref_sum = float(c_ref.sum())

    A_ell = convert.csr_to_ell(A, check_guard=False)
    routes = {}

    def measure(name, run, cost):
        C = run()
        sync()
        nnz = int(C.nnz)
        rel = abs(float(C.checksum()) - ref_sum) / max(1.0, abs(ref_sum))
        del C   # keep scalars only: no route's result stays on the card
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        routes[name] = {
            "run": run, "nnz": nnz, "wall_ms": float(np.median(times)),
            "device_ms": profiling.device_time_ms(run, chain=8)["device_ms"],
            "cost": cost, "checksum_rel_err": rel}

    # flat bitonic at the observed output width
    t_plan = time.perf_counter()
    bt_plan = bitonic.plan_bitonic(A_ell, A_ell)
    plan_seconds["bitonic"] = time.perf_counter() - t_plan
    if bt_plan.viable:
        C0 = bitonic.spgemm_bitonic(A_ell, A_ell, bt_plan)
        out_w = observed_out_width(C0.nnz_row.cpu(), bt_plan.width)
        del C0
        measure("bitonic",
                lambda: bitonic.spgemm_bitonic(A_ell, A_ell, bt_plan,
                                               out_width=out_w),
                roofline.cost_bitonic(A.nrows, bt_plan.width, int(A.nnz)))

    # width classes, BlockCSR out; then with the gather at plan time
    t_plan = time.perf_counter()
    mc_plan, W = bitonic.plan_multiclass(
        A_ell.nnz_row.cpu().numpy(), A_ell.max_nnz_per_row,
        a_col_dev=A_ell.col_ind, b_len_dev=A_ell.nnz_row)
    plan_seconds["multiclass"] = time.perf_counter() - t_plan
    if mc_plan.viable:
        t_plan = time.perf_counter()
        call0 = bitonic.multiclass_planned(A_ell, A_ell, assemble="bcsr")
        if call0 is not None:
            Cm = call0()
            out_w_mc = observed_out_width(Cm.nnz_row.cpu(),
                                          int(mc_plan.widths[-1]))
            W = np.asarray(W)
            class_rows = [(int((W == w).sum()), int(w))
                          for w in np.unique(W)]
            mc_cost = roofline.cost_multiclass(class_rows, int(A.nnz),
                                               int(Cm.nnz))
            del Cm
            call = bitonic.multiclass_planned(A_ell, A_ell,
                                              assemble="bcsr",
                                              out_width=out_w_mc)
            measure("multiclass", call, mc_cost)
            plan_seconds["multiclass_call"] = time.perf_counter() - t_plan
            t_plan = time.perf_counter()
            call_pg = bitonic.multiclass_planned(
                A_ell, A_ell, assemble="bcsr", out_width=out_w_mc,
                pregather=True,
                run_override=None if smoke
                else (tuning or {}).get("pg_run"))
            plan_seconds["multiclass_pg"] = time.perf_counter() - t_plan
            if call_pg is not None:
                measure("multiclass_pg", call_pg, mc_cost)

    # the slab-packed ESC engine
    t_plan = time.perf_counter()
    scall = slab_mod.plan_slab_csr(A, A)
    plan_seconds["slab"] = time.perf_counter() - t_plan
    if scall is not None:
        measure("slab", scall,
                roofline.cost_esc(scall.plan.padded_slots, int(A.nnz),
                                  int(A.nnz), int(c_ref.nnz)))

    # the global-sort ESC, the fallback every route rests on
    if not routes or smoke:
        measure("esc", lambda: esc.spgemm_csr(A, A, esc_plan,
                                              engine="global"),
                roofline.cost_esc(esc_plan.expansion_capacity, int(A.nnz),
                                  int(A.nnz), int(c_ref.nnz)))

    algorithm = min(routes, key=lambda k: routes[k]["device_ms"]
                    if routes[k]["device_ms"] > 0 else routes[k]["wall_ms"])
    best = routes[algorithm]
    ours_ms, device_ms = best["wall_ms"], best["device_ms"]
    decomp = profiling.wall_decomposition(best["run"], n=4 if smoke else 16)
    pipelined_ms = decomp["pipelined_wall_ms"]

    # the serving modes of the flat plan: no compaction; bf16 values
    # (packed single-array sort); both
    sparse_device_ms = bf16_device_ms = bf16_sparse_device_ms = None
    if "bitonic" in routes:
        flat_nnz = routes["bitonic"]["nnz"]

        def mode_ms(**kw):
            run = lambda: bitonic.spgemm_bitonic(  # noqa: E731
                A_ell, A_ell, bt_plan, **kw)
            nnz = int(run().nnz)
            assert nnz == flat_nnz, (kw, nnz, flat_nnz)
            return profiling.device_time_ms(run, chain=8)["device_ms"]

        sparse_device_ms = mode_ms(compact=False)
        try:
            bf16_device_ms = mode_ms(out_width=out_w, value_mode="bf16")
        except (ValueError, AssertionError):
            bf16_device_ms = None
        try:
            bf16_sparse_device_ms = mode_ms(value_mode="bf16",
                                            compact=False)
        except (ValueError, AssertionError):
            bf16_sparse_device_ms = None

    roof = roof_dev = None
    if chip is not None:
        roof = roofline.analyze(pipelined_ms, best["cost"], chip)
        if device_ms > 0:
            roof_dev = roofline.analyze(device_ms, best["cost"], chip)

    gflops = 2.0 * esc_plan.flops / (pipelined_ms * 1e6)
    return {
        "metric": "spgemm_gflops",
        "value": gflops,
        "unit": "GFLOPS",
        "vs_baseline": scipy_ms / pipelined_ms,
        "detail": {
            "algorithm": algorithm,
            "m": A.nrows, "nnz": int(A.nnz),
            "intermediate_products": esc_plan.flops,
            "nnz_out": best["nnz"],
            "ours_ms": pipelined_ms,
            "single_call_wall_ms": ours_ms,
            "wall_decomposition": decomp,
            "plan_seconds": plan_seconds,
            "device_ms": device_ms,
            "sparse_mode_device_ms": sparse_device_ms,
            "bf16_mode_device_ms": bf16_device_ms,
            "bf16_sparse_mode_device_ms": bf16_sparse_device_ms,
            "device_gflops": (2.0 * esc_plan.flops / (device_ms * 1e6)
                              if device_ms > 0 else None),
            "scipy_ms": scipy_ms,
            "checksum_rel_err": best["checksum_rel_err"],
            "routes": {k: {f: v[f] for f in ("wall_ms", "device_ms", "nnz",
                                              "checksum_rel_err")}
                       for k, v in routes.items()},
            "device": (f"{card_name()}; CUDA {torch.version.cuda}"
                       if dev.type == "cuda" else "cpu"),
            "fused_max_width": bitonic.FUSED_MAX_WIDTH,
            "tuned_from": tuning.get("source") if tuning else None,
            "roofline": roof,
            "roofline_device": roof_dev,
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--m", type=int, default=None,
                   help="matrix size (default 32768; 256 when "
                        "IA_SPGEMM_BENCH_SMOKE=1)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--route", default=None, choices=("multiclass_pg",),
                   help="time this route alone (run_headline)")
    p.add_argument("--iters", type=int, default=20,
                   help="timed calls of --route")
    args = p.parse_args(argv)
    smoke = os.environ.get("IA_SPGEMM_BENCH_SMOKE") == "1"
    m = args.m or (256 if smoke else 32768)
    try:
        if args.route:
            result, _, _ = run_headline(m=m, device=args.device,
                                        iters=args.iters)
        else:
            result = run_bench(m=m, device=args.device, smoke=smoke)
    except Exception as e:     # no card, a failed build or launch
        # bench.py's one structured line for a run with no result
        print(json.dumps({"metric": "spgemm_gflops", "value": 0.0,
                          "unit": "GFLOPS", "vs_baseline": 0.0,
                          "error": f"{type(e).__name__}: {e}"}))
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
