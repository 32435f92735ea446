"""Run one cell several times, one process a run, and summarise.

    python3 benchmark/tools/repeat.py --workload NAME --seeds S [S ...]
        [--seconds S] [--trace 0|1] [--out FILE.jsonl]

Each run is ``benchmark/run.py`` as the check runs it, from the root of
the checkout. Every run's last line goes to ``--out`` (one JSON object a
line, with its seed, exit code and wall seconds); the summary gives each
metric's median and its spread: the distance between the first and the
third quartile (``statistics.quantiles(values, n=4)``) as a share of the
median, the measure the bounds in BENCHMARK.json are set from.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def spread(values):
    """(median, (q3 - q1) / median) of a list of numbers."""
    med = statistics.median(values)
    if len(values) < 2 or not med:
        return med, None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seconds = args.seconds
    if seconds is None:
        seconds = json.loads((ROOT / "BENCHMARK.json").read_text())[
            "run_seconds"]
    rows = []
    for seed in args.seeds:
        cmd = [sys.executable, "benchmark/run.py", "--workload",
               args.workload, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(args.trace)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            last = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            last = None
        info = [ln for ln in lines[:-1] if ln.startswith("{")]
        row = {"seed": seed, "rc": proc.returncode, "wall_s": wall,
               "info": [json.loads(ln) for ln in info], "line": last}
        if proc.returncode != 0 or last is None or not last.get("correct"):
            row["stderr_tail"] = proc.stderr[-3000:]
        rows.append(row)
        print(json.dumps({"seed": seed, "rc": proc.returncode,
                          "wall_s": round(wall, 2),
                          "correct": last and last.get("correct"),
                          "metrics": last and {
                              k: v["value"]
                              for k, v in last["metrics"].items()},
                          "checks": last and last.get("checks")}),
              flush=True)
        if args.out:
            with open(ROOT / args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    values = {}
    for row in rows:
        if row["line"]:
            for k, v in row["line"]["metrics"].items():
                values.setdefault(k, []).append(v["value"])
    print(json.dumps({"workload": args.workload, "runs": len(rows),
                      "summary": {k: dict(zip(("median", "spread"),
                                              spread(v)))
                                  for k, v in values.items()}}))
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
