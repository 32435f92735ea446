"""Run one cell of the port's benchmark once, and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (an entry of ``workloads`` in BENCHMARK.json) names a
configuration and a traffic mix. Set-up makes the configuration's matrix
A from the seed, hands it to the port as a CSR on the card, and plans the
production entry once: ``ia_spgemm_tpu_torch.ops.esc.plan_csr_auto(A,
A)`` (the router's pick, then that engine's planner). The window then
drives the planned call as the mix's loop says, for ``--seconds``.

With ``--trace 0`` the line holds the cell's end-to-end metrics. With
``--trace 1`` it holds the per-layer ones: the host ms to issue a call
(before the profiler starts), then a profiler window over the same loop
(device activity only: busy, window, the hand kernels and the rest) and
a short one with the host's events (the idle gaps by what the host was
doing).

After the window, two of its results (one drawn from the seed, and the
last) are read from their raw arrays as the program stored them
(``benchlib/readout.py``), the program's state is freed, and the plain
reference (``benchlib/reference.py``) judges them: ``correct`` is true
when every number is within the mix's limits. The numbers and their
limits are the last lines on standard error and the last key of the
line.

Exits 2 without the card(s) the cell asks for, and 3 if a module of JAX
or of the JAX package is loaded when the result is due (looked for just
before it is printed); neither prints a result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))   # the port, from the checkout's root

from benchlib import (guard, inputs, peaks, readout,  # noqa: E402
                      reference, spec, trace)
from benchlib.runtime import Runtime  # noqa: E402

# the traced windows: device activity alone, then with the host's events
TRACE_SECONDS = 2.0
GAPS_SECONDS = 0.5
DISPATCH_REPS = 20
# one checked result is drawn from the first SAMPLE_FROM calls
SAMPLE_FROM = 8


def _process_age():
    """Seconds since this process started (Linux /proc), 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_T0 = _process_age()


def _finite(x):
    """x as a float, None when absent or not finite (JSON has no NaN)."""
    return None if x is None or not math.isfinite(x) else float(x)


def _card(torch):
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return name, limit


def main(argv=None, *, device=None, root=None, wrap_call=None):
    """One run. ``device`` and ``wrap_call`` exist for the tests alone:
    "cpu" skips the look for a card and runs the port's plain versions;
    wrap_call(call, A) puts a broken call in the planned call's place."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.Cell(args.workload, root or ROOT)
    traffic = cell.traffic
    import numpy as np
    import torch
    if device is None:
        need = int(cell.workload["chips"])
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            print(f"{args.workload} needs {need} CUDA card(s); found {have}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    rt = Runtime(device, spans=bool(args.trace))

    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.ops import bitonic, esc

    phases = {"start_s": AGE_AT_T0 + rt.clock() - T0}
    t = rt.clock()
    a = inputs.generate(cell.family(), cell.config, args.seed)
    a = a.astype(np.dtype(traffic["dtype"]))
    A = CSR.from_scipy(a, device=device)
    products = inputs.products(a.indptr, a.indices, a.indptr)
    phases["inputs_s"] = rt.clock() - t
    t = rt.clock()
    route, call = esc.plan_csr_auto(A, A)
    plan_s = rt.clock() - t
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "route": route,
                      "fused_max_width": bitonic.FUSED_MAX_WIDTH,
                      "m": a.shape[0], "nnz": int(a.nnz),
                      "products": products, "dtype": traffic["dtype"]}),
          flush=True)
    if wrap_call is not None:
        call = wrap_call(call, A)
    t = rt.clock()
    for _ in range(2):   # warm-up: kernels loaded or built, allocator grown
        int(call().nnz)
    rt.sync()
    phases["warmup_s"] = rt.clock() - t
    setup_s = AGE_AT_T0 + rt.clock() - T0

    loop = cell.loop()
    keep = [random.Random(args.seed).randrange(SAMPLE_FROM)]
    dispatch = summary = gaps = None
    t = rt.clock()
    if not args.trace:
        out = loop.run(call, args.seconds, traffic, rt, keep)
    else:
        from torch.profiler import ProfilerActivity, profile
        dispatch = rt.dispatch_ms(call, DISPATCH_REPS)
        acts = [ProfilerActivity.CUDA] if rt.cuda else \
            [ProfilerActivity.CPU]
        with profile(activities=acts):   # the profiler's own start-up
            int(call().nnz)
        with profile(activities=acts) as prof:
            out = loop.run(call, min(args.seconds, TRACE_SECONDS), traffic,
                           rt, keep)
        dev_ev, _ = trace.profiler_events(prof)
        summary = trace.summarize(dev_ev)
        if summary is not None:
            summary["products"] = out["completed"]
        del prof, dev_ev
        if rt.cuda:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                short = loop.run(call, min(args.seconds, GAPS_SECONDS),
                                 traffic, rt)
            dev_ev, host_ev = trace.profiler_events(prof)
            gaps = (trace.idle_gaps(dev_ev, host_ev), short["completed"])
            del prof, dev_ev, host_ev, short
    rt.sync()
    phases["window_s"] = rt.clock() - t
    peak = torch.cuda.max_memory_allocated() if rt.cuda else None
    card = _card(torch) if rt.cuda else ("cpu", "none")

    # the results, as the program reads them out; then its state goes
    t = rt.clock()
    kept = sorted(out.pop("kept").items())
    results = [(idx, readout.read(r), int(r.nnz)) for idx, r in kept]
    phases["read_s"] = rt.clock() - t
    del kept, call, A
    bitonic.clear_plan_cache()
    gc.collect()
    if rt.cuda:
        torch.cuda.empty_cache()
    t = rt.clock()
    ref = reference.square(a.indptr, a.indices, a.data, a.shape,
                           device=device)
    phases["reference_s"] = rt.clock() - t
    t = rt.clock()
    limits = traffic["limits"]
    readings = {k: [] for k in limits}
    failed = 0
    for _, res, nnz in results:
        nums = reference.compare(res, nnz, ref)
        failed += not reference.judge(nums, limits)
        for k in limits:
            readings[k].append(_finite(nums.get(k)))
    worst = {k: None if None in v else max(v) for k, v in readings.items()}
    correct = bool(results) and failed == 0
    phases["compare_s"] = rt.clock() - t

    least_s = None
    chip = peaks.chip(card[0]) if rt.cuda else None
    if chip is not None:
        nbytes, flops = peaks.least_work(
            a.shape[0], int(a.nnz), a.shape[0], int(a.nnz), a.shape[0],
            ref.nnz, products, a.dtype.itemsize)
        least_s = peaks.least_seconds(nbytes, flops, peaks.PEAKS[chip],
                                      traffic["dtype"])[0]
    run = SimpleNamespace(setup_s=setup_s, plan_s=plan_s, products=products,
                          loop=out, peak_bytes=peak, dispatch_ms=dispatch,
                          trace=summary, least_s=least_s, traffic=traffic)
    metrics = {}
    for m in cell.metrics(args.trace):
        v = cell.reader(m["name"]).read(run)
        if v is None:
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if rt.cuda else "cpu", "kind": card[0],
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": out["issued"],
            "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_us"] * 1e-6
        dev["window_s"] = summary["window_us"] * 1e-6
        per = 1e-6 / summary["products"]
        line["breakdown"] = {
            "device_ops": trace.top(summary["by_name"], per),
            "idle_gaps": trace.top(gaps[0], 1e-6 / max(gaps[1], 1))
            if gaps else []}
    checks = {k: {"value": worst.get(k), "limit": lim}
              for k, lim in limits.items()}
    line["checks"] = checks
    print(json.dumps({"card": card[0], "power_limit": card[1],
                      "route": route, "checked_calls":
                      [idx for idx, _, _ in results], "phases": phases}),
          flush=True)
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    found = guard.forbidden()
    if found:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
