"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/control.py --workload NAME --seeds S [S ...]
                                 [--program] [--device cuda|cpu]

For each seed it makes the cell's matrix, computes the plain reference,
and reads the comparison's numbers (``benchlib/reference.py``) of

- the control: the reference in the program's place, computed in the
  traffic mix's ``control_dtype``, the nearest precision below the
  mix's (bfloat16 for float32, float32 for float64), in plain torch on
  the device (``reference.square`` with that ``dtype``);
- with ``--program``, one call of the planned product that the cell's
  window drives (``plan_csr_auto(A, A)``), read as it stored it
  (``benchlib/readout.py``).

One JSON line a seed, then a summary: the largest reading of the program
and the smallest of the control, number by number. A limit lies between
the two (PERF.md gives the readings and the limits). The benchmark's own
runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from benchlib import inputs, readout, reference, spec  # noqa: E402


def readings(workload, seeds, program=False, device="cuda", root=None):
    """[(seed, {"control": numbers, "program": numbers or None}), ...]"""
    import numpy as np
    import torch
    cell = spec.Cell(workload, root or HERE.parent)
    traffic = cell.traffic
    lowp = getattr(torch, traffic["control_dtype"])
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        a = inputs.generate(cell.family(), cell.config, seed)
        a = a.astype(np.dtype(traffic["dtype"]))
        ref = reference.square(a.indptr, a.indices, a.data, a.shape,
                               device=device)
        ctl = reference.square(a.indptr, a.indices, a.data, a.shape,
                               dtype=lowp, device=device)
        row = {"control": reference.compare(ctl.raw(), ctl.nnz, ref),
               "program": None}
        del ctl
        if program:
            from ia_spgemm_tpu_torch.formats.types import CSR
            from ia_spgemm_tpu_torch.ops import esc
            A = CSR.from_scipy(a, device=device)
            route, call = esc.plan_csr_auto(A, A)
            C = call()
            row["program"] = reference.compare(readout.read(C),
                                               int(C.nnz), ref)
            row["route"] = route
            del A, call, C
        row["seconds"] = time.perf_counter() - t0
        out.append((seed, row))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rows = readings(args.workload, args.seeds, args.program, args.device)
    for seed, row in rows:
        print(json.dumps({"workload": args.workload, "seed": seed, **row}),
              flush=True)
    summary = {}
    for side, pick in (("program", max), ("control", min)):
        vals = [r[side] for _, r in rows if r[side] is not None]
        if vals:
            summary[side] = {k: pick((v[k] if v[k] is not None
                                      else float("inf")) for v in vals)
                             for k in vals[0]}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
