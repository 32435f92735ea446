"""Device-time breakdown of one planned route, from torch.profiler.

    python -m ia_spgemm_tpu_torch.bench.profile [--route R] [--m M]
                                                [--calls N] [--cpu-ops]

Routes: ``multiclass_pg`` (default; the headline route, planned as
``bench/headline.py`` plans it), ``slab``, ``compensated`` (the
compensated slab pipeline) and ``global`` on the headline matrix
``build_matrix(m)``, and ``hybrid`` on ``build_hybrid_matrix(m)``; C =
A @ A in float32. Plans the route, warms it up, and profiles ``calls``
back-to-back calls with one synchronise at the end.
The profiler records device activity only, unless ``--cpu-ops`` also
records every host-side operator (which slows the host's launch path
and so widens the gaps between kernels).

Prints the card (nvidia-smi name and power limit), then one JSON object:

- ``device_us``: device microseconds per call of every device activity
  (kernels, copies, sets) by name, most first;
- ``positions_us``: for each hand-written kernel, device microseconds
  per call of each of its launches within one call, in launch order (in
  the headline route, one launch per width class of that kernel,
  classes in width order);
- ``window_us``, ``busy_us``, ``idle_share``: per call, the span from the
  first device activity's start to the last one's end, the summed
  activity time, and 1 - busy / window, all with the profiler on;
- ``host_ms_1`` / ``host_ms_n``: host wall ms per call of one call with
  its synchronise, and of ``calls`` calls back to back with one.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from collections import defaultdict

import numpy as np

_KERNEL = re.compile(r"\bk(?:[1-4]|8|9|10)_[a-z_]+")
ROUTES = ("multiclass_pg", "slab", "compensated", "global", "hybrid")


def _plan(route: str, m: int, dev):
    """(call, plan details) of one route on its matrix."""
    from ia_spgemm_tpu_torch.bench import headline
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.ops import esc, slab

    a = (headline.build_hybrid_matrix(m) if route == "hybrid"
         else headline.build_matrix(m=m))
    A = CSR.from_scipy(a.astype(np.float32), device=dev)
    if route == "multiclass_pg":
        call, out_w, plan_s = headline.plan_headline(A)
        return call, {"widths": list(call.widths), "run": call.run,
                      "out_width": out_w, "plan_seconds": plan_s}
    t0 = time.perf_counter()
    if route in ("slab", "compensated"):
        call = slab.plan_slab_csr(A, A, dd=route == "compensated")
        detail = {"width": call.plan.width, "slabs": call.plan.n_slabs}
    elif route == "hybrid":
        call = slab.plan_slab_hybrid(A, A)
        detail = {"n_heavy": call.n_heavy,
                  "variant": call.heavy_plan.variant}
    else:
        plan = esc.plan_spgemm(A, A)
        call = lambda: esc.spgemm_csr(A, A, plan)  # noqa: E731
        detail = {"variant": plan.variant,
                  "expansion_capacity": plan.expansion_capacity}
    detail["plan_seconds"] = time.perf_counter() - t0
    return call, detail


def profile_route(route: str = "multiclass_pg", m: int = 32768,
                  calls: int = 10, warmup: int = 5, cpu_ops: bool = False):
    from ia_spgemm_tpu_torch.bench import headline
    headline.apply_bench_tuning()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r} (one of {ROUTES})")
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA device")
    call, detail = _plan(route, m, torch.device("cuda"))
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    host_1 = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    host_n = (time.perf_counter() - t0) * 1e3 / calls

    activities = [ProfilerActivity.CUDA]
    if cpu_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not evs:
        raise RuntimeError("the profiler recorded no device activity")
    device_us = defaultdict(float)
    launches = defaultdict(list)
    for e in evs:
        us = e.time_range.end - e.time_range.start
        device_us[e.name[:100]] += us / calls
        k = _KERNEL.search(e.name)
        if k:
            launches[k.group()].append(us)
    positions = {}
    for name, durs in sorted(launches.items()):
        if len(durs) % calls:
            raise RuntimeError(f"{name}: {len(durs)} launches in {calls} "
                               f"calls")
        positions[name] = np.asarray(durs).reshape(calls, -1).mean(
            axis=0).tolist()
    window = (max(e.time_range.end for e in evs)
              - evs[0].time_range.start) / calls
    busy = sum(device_us.values())
    return {
        "route": route, "m": m, "calls": calls, "cpu_ops": cpu_ops,
        **detail,
        "device_us": dict(sorted(device_us.items(), key=lambda kv: -kv[1])),
        "positions_us": positions,
        "window_us": window, "busy_us": busy, "idle_share": 1 - busy / window,
        "host_ms_1": host_1, "host_ms_n": host_n,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--route", default="multiclass_pg", choices=ROUTES)
    p.add_argument("--m", type=int, default=32768)
    p.add_argument("--calls", type=int, default=10)
    p.add_argument("--cpu-ops", action="store_true",
                   help="also record host-side operators")
    args = p.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps(profile_route(args.route, m=args.m, calls=args.calls,
                                   cpu_ops=args.cpu_ops)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
