"""Harvest the selector's training corpus on the card, then retrain
MatNet on it (PyTorch port of ``scripts/upcycle_tpu.py`` and
``scripts/retrain_from_checkpoint.py``).

The parent walks the corpus and harvests each matrix in a worker process
of its own session: past IA_HARVEST_TIMEOUT seconds (default 900) it
kills the worker's process group, and the worker's CUDA context goes
with it. Only the workers touch the card. A worker benchmarks the v3
menu with device timers on one entry (``upcycle.harvest_sample``,
float32, B = A unless the entry names its B) and saves the sample; the
parent appends it to the checkpoint after every matrix and records every
attempt in the harvest log, so a cut run keeps what it harvested and the
next run resumes by name.

Two faults of the JAX package's scripts stay out. A matrix whose worker
failed, timed out or found no winner is recorded in the log with its
exit code or timeout, never on a list that later runs skip: the next run
tries it again. And no path is parsed out of a file name: every output
path comes from the command line, and nothing lands in ``weights/``
unless a path there is given.

    python -m ia_spgemm_tpu_torch.models.harvest --out-dir DIR [--quick]
        [--max-seconds S] [--first P1,P2] [--names N1,N2] [--harvest-only]
        [--samples S.npz] [--weights-out W.npz] [--report R.json]
        [--harvest-log L.json] [--steps N] [--kfold K] [--device cuda|cpu]
    python -m ia_spgemm_tpu_torch.models.harvest --retrain S.npz
        [--menu A,B,C] (--out-dir DIR | --weights-out W.npz --report R.json)
        [--harvest-log L.json] [--steps N] [--kfold K] [--device cuda|cpu]
    python -m ia_spgemm_tpu_torch.models.harvest --list [--quick]
    python -m ia_spgemm_tpu_torch.models.harvest --ties S.npz REPEAT.npz
    python -m ia_spgemm_tpu_torch.models.harvest --summary L.json

``--out-dir DIR`` names DIR/samples.npz, DIR/upcycled.npz,
DIR/upcycle_report.json and DIR/harvest_log.json; a path given by its own
flag wins. ``--ties`` counts the labels whose runner-up lies within the
device timer's run-to-run spread, measured on the entries that REPEAT (a
second harvest, ``--names``) measured again; ``--summary`` puts a harvest
log in numbers.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from ia_spgemm_tpu_torch.bench.headline import build_matrix
from ia_spgemm_tpu_torch.io import suitesparse
from ia_spgemm_tpu_torch.models import upcycle

_REPO = Path(__file__).resolve().parents[2]
MODULE = "ia_spgemm_tpu_torch.models.harvest"
# the class menu of every harvested sample: one algorithm per
# accumulation strategy, that of weights/TPU_upcycled_v3.npz
MENU = upcycle.V3_MENU
TIMEOUT_ENV = "IA_HARVEST_TIMEOUT"
DEFAULT_TIMEOUT_S = 900.0
OUT_NAMES = {"samples": "samples.npz", "weights_out": "upcycled.npz",
             "report": "upcycle_report.json",
             "harvest_log": "harvest_log.json"}
# the keys of the JAX package's report (scripts/upcycle_tpu.py), to which
# this driver adds "failed"
REPORT_KEYS = ("menu", "n_samples", "class_counts", "min_class_count",
               "pick_accuracy_in_sample", "kfold_accuracy", "kfold_per_fold",
               "majority_baseline", "train_steps", "harvest_seconds")

Entry = Tuple[str, Callable[[], tuple]]


# ---------------------------------------------------------------------------
# the corpus: scripts/upcycle_tpu.py's entries, names and order
# ---------------------------------------------------------------------------

def _square(build):
    """An entry build of C = A @ A (B = None)."""
    return lambda: (build(), None)


def _diags(m, seed, offsets_of):
    """Random diagonals at the offsets offsets_of(rng) draws."""
    rng = np.random.default_rng(seed)
    offs = offsets_of(rng)
    diags = [rng.standard_normal(m) for _ in offs]
    return sp.diags(diags, offs, shape=(m, m)).tocsr()


def _scatdiag(m, seed):
    return _diags(m, seed, lambda rng: sorted(
        {0, 1, -1, 63, -63, 128 + seed, -(128 + seed), 511, -511}))


def _scatdiag5(m, seed):
    def offs(rng):
        nd = 7 + 4 * seed
        return sorted(set([0] + list(rng.integers(-m // 4, m // 4, nd))))
    return _diags(m, 100 + seed, offs)


def _scat64(m, seed):
    return _diags(m, 400 + seed, lambda rng: sorted(
        set([0] + list(rng.integers(-64, 64, 8)))))


def _rows_of(m, rng, lens):
    """A random-column matrix with the given row lengths."""
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.shape[0])
    return sp.coo_matrix((rng.standard_normal(rows.shape[0]), (rows, cols)),
                         shape=(m, m)).tocsr()


def _hugerow(m, seed):
    """Short rows and three of 6000 entries: beyond the width classes'
    lane budget."""
    rng = np.random.default_rng(200 + seed)
    lens = rng.integers(2, 10, m)
    lens[rng.integers(0, m, 3)] = 6000
    return _rows_of(m, rng, lens)


def _bskew(m, seed):
    """0.4% of the rows 300 long: B-skew, ragged fragments."""
    rng = np.random.default_rng(300 + seed)
    lens = np.where(rng.random(m) < 0.004, 300, rng.integers(4, 16, m))
    return _rows_of(m, rng, lens)


def _transpose(m, seed):
    a = build_matrix(m=m, band=2 + seed, extra_per_row=8, seed=seed)
    return a, a.T.tocsr()


def _fixture(path):
    from ia_spgemm_tpu_torch.io import mmio
    return mmio.read_mtx_to_csr(path, device="cpu").to_scipy()


def corpus(quick: bool = False) -> Iterator[Entry]:
    """(name, build) per entry, in scripts/upcycle_tpu.py's order under
    its names; build() returns (A, B), B None for C = A @ A. Nothing is
    built until an entry's build is called (the fixtures excepted: a
    fixture is read to learn whether it is square). quick: m = 1024,
    seeds 0 and 1, then the fixtures."""
    g = suitesparse
    P = functools.partial
    sizes = (1024,) if quick else (4096, 16384, 32768)
    seeds = (0, 1) if quick else (0, 1, 2, 3, 4, 5)

    def suite(seeds_):
        for m in sizes:
            for name, build in g.synthetic_entries(m, seeds_):
                yield name, _square(build)

    yield from suite(seeds)
    if not quick:
        # the headline's structure class: band + random off-band entries
        for m in (16384, 32768):
            for seed in seeds:
                yield f"bandrand_{m}_{seed}", _square(P(
                    build_matrix, m=m, band=2 + seed, extra_per_row=8,
                    seed=seed))
        yield from suite((6, 7, 8))
        # mixed-structure (A, B) pairs
        for m in (4096, 16384):
            for seed in (0, 1, 2):
                band = P(g.gen_banded, m, 2 + seed, seed)
                uni = P(g.gen_uniform, m, nnz_per_row=6 + seed, seed=seed)
                pow_ = P(g.gen_powerlaw, m, seed=seed)
                yield f"pair_band_uni_{m}_{seed}", lambda a=band, b=uni: (
                    a(), b())
                yield f"pair_uni_pow_{m}_{seed}", lambda a=uni, b=pow_: (
                    a(), b())
                yield f"pair_pow_band_{m}_{seed}", lambda a=pow_, b=band: (
                    a(), b())
        # B = A^T (the reference GPU driver's workload)
        for m in (16384, 32768):
            for seed in (0, 1, 2):
                yield f"transpose_{m}_{seed}", P(_transpose, m, seed)
        # wide pure bands / scattered diagonals
        for m in (4096, 16384):
            for seed in (0, 1):
                yield f"wideband_{m}_{seed}", _square(P(
                    g.gen_banded, m, bandwidth=12 + 4 * seed, seed=seed))
                yield f"scatdiag_{m}_{seed}", _square(P(_scatdiag, m, seed))
        # heavy-skew rows
        for m in (8192, 16384):
            for seed in (0, 1):
                yield f"heavyskew_{m}_{seed}", _square(P(
                    g.gen_powerlaw, m, mean_nnz=64, alpha=1.1, seed=seed))
        for m in (4096, 8192, 16384):
            for seed in (2, 3, 4, 5):
                yield f"scatdiag5_{m}_{seed}", _square(P(_scatdiag5, m, seed))
        for m in (8192, 16384):
            for seed in (0, 1, 2):
                yield f"hugerow_{m}_{seed}", _square(P(_hugerow, m, seed))
        # large-expansion uniforms
        for m in (32768, 65536):
            for seed in (0, 1):
                yield f"largeE_{m}_{seed}", _square(P(
                    g.gen_uniform, m, nnz_per_row=40 + 16 * seed, seed=seed))
        for m in (8192, 16384):
            for seed in (0, 1):
                yield f"bskew_{m}_{seed}", _square(P(_bskew, m, seed))
        yield from suite((9, 10, 11))
        # band x scattered diagonals
        for m in (4096, 8192):
            for seed in (0, 1):
                yield f"pair_band_scat_{m}_{seed}", lambda m=m, seed=seed: (
                    g.gen_banded(m, 3 + seed, seed), _scat64(m, seed))
        # dense wide bands
        for m in (4096, 8192, 16384):
            for bw in (32, 48):
                for seed in (0, 1):
                    yield f"denseband_{m}_{bw}_{seed}", _square(P(
                        g.gen_banded, m, bandwidth=bw, seed=seed))
        for m in (8192, 16384):
            for seed in (3, 4):
                yield f"hugerow_{m}_{seed}", _square(P(_hugerow, m, seed))
        # small but dense inputs (density 3-12%)
        for m in (1024, 2048, 4096):
            for div in (8, 16, 32):
                for seed in (0, 1):
                    if m // div < 8:
                        continue
                    yield f"smalldense_{m}_{div}_{seed}", _square(P(
                        g.gen_uniform, m, nnz_per_row=m // div, seed=seed))
        # SpMM-shaped pairs: sparse A, dense-ish B
        for m in (2048, 4096, 8192):
            for seed in (0, 1):
                yield f"pair_sp_dense_{m}_{seed}", lambda m=m, seed=seed: (
                    g.gen_uniform(m, nnz_per_row=6 + seed, seed=seed),
                    g.gen_uniform(m, nnz_per_row=max(8, m // 12),
                                  seed=seed + 1))
        # named SuiteSparse structure replicas at their published sizes
        for nm in ("poisson3Da", "m133-b3", "mac_econ_fwd500", "scircuit",
                   "cage12", "2cubes_sphere", "mc2depi", "majorbasis",
                   "mario002", "filter3D", "cop20k_A", "patents_main",
                   "offshore", "rma10", "shipsec1"):
            for seed in (0, 1):
                yield f"named_{nm}_{seed}", _square(P(g.gen_named, nm,
                                                      seed=seed))
    # the reference's fixture matrices, when the directory is there
    for name, path in sorted(g.local_collection().items()):
        try:
            a = _fixture(path)
        except (OSError, ValueError):
            continue
        if a.shape[0] == a.shape[1]:
            yield f"ref_{name}", lambda a=a: (a, None)


# ---------------------------------------------------------------------------
# the worker: one entry, on the card
# ---------------------------------------------------------------------------

def _launch_counts() -> dict:
    """This process's kernel launches, by kernel."""
    from ia_spgemm_tpu_torch.ops import (bitonic_kernels, dense_row_kernels,
                                         hash_kernels, slab_kernels)
    from ia_spgemm_tpu_torch.parallel import rdma_ring
    out = {}
    for mod in (bitonic_kernels, slab_kernels, dense_row_kernels,
                hash_kernels, rdma_ring):
        out.update(mod.launch_counts())
    return out


def worker(name: str, out: str, quick: bool = False,
           device: str = "cuda") -> int:
    """Harvest ONE corpus entry on `device` (the card unless "cpu" is
    named; raises without one) into the sample file `out` (none when no
    menu row ran); prints the kernel launches as its last line."""
    import torch

    from ia_spgemm_tpu_torch.formats.types import CSR
    at = {"imported": time.time()}
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("harvest worker: no CUDA card (name --device "
                           "cpu to harvest on the CPU)")
    build = dict(corpus(quick)).get(name)
    if build is None:
        print(f"{name}: not in the corpus", flush=True)
        return 3
    a, b = build()
    at["built"] = time.time()
    A = CSR.from_scipy(a.tocsr().astype(np.float32), device=dev)
    B = A if b is None else CSR.from_scipy(b.tocsr().astype(np.float32),
                                           device=dev)
    at["on_device"] = time.time()
    s = upcycle.harvest_sample(
        A, B, menu=MENU, name=name, iters=2,
        progress=lambda alg: print(f"  [{name}] {alg}", flush=True))
    if s is not None:
        upcycle.save_samples(out, [s], menu=MENU)
    at["done"] = time.time()
    launches = {k: n for k, n in _launch_counts().items() if n}
    print(json.dumps({"launches": launches, "at": at}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the parent: process isolation, checkpoint, resume
# ---------------------------------------------------------------------------

def _write_json(path: str, obj) -> None:
    tmp = f"{path}.partial"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def _save_samples(path: str, samples) -> None:
    """The checkpoint, replaced whole: a cut write leaves the last one."""
    tmp = f"{path}.partial.npz"
    upcycle.save_samples(tmp, samples, menu=MENU)
    os.replace(tmp, path)


def read_log(path: Optional[str]) -> dict:
    """The harvest log: every entry's last attempt and every run."""
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"menu": list(MENU), "entries": {}, "runs": []}


def _worker_command(name: str, out: str, quick: bool,
                    device: str) -> List[str]:
    cmd = [sys.executable, "-m", MODULE, "--worker", name, "--out", out,
           "--device", device]
    return cmd + ["--quick"] if quick else cmd


def _card() -> Optional[str]:
    """The card's name and power limit, from nvidia-smi (no CUDA
    context)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _run_worker(cmd: List[str], timeout_s: float):
    """(exit code or None on timeout, output) of one worker in its own
    session; past timeout_s its whole process group is killed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_REPO), env.get("PYTHONPATH")) if p)
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True, env=env)
    try:
        out = p.communicate(timeout=timeout_s)[0]
        return p.returncode, out
    except subprocess.TimeoutExpired:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        return None, p.communicate()[0]


def harvest(samples_path: str, log_path: str, *, quick: bool = False,
            device: str = "cuda", max_seconds: float = float("inf"),
            first: Sequence[str] = (), names: Optional[Sequence[str]] = None
            ) -> list:
    """Harvest every corpus entry the checkpoint at samples_path does not
    hold (only `names` when given; entries starting with a `first` prefix
    before the rest), one worker each, until max_seconds have passed;
    the checkpoint and the log are written after every matrix. Returns
    the samples."""
    timeout_s = float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S))
    if device == "cuda":
        # the workers only load the kernels; nvcc runs here, once
        from ia_spgemm_tpu_torch import _build
        _build.build()
    samples = (upcycle.load_samples(samples_path)
               if os.path.exists(samples_path) else [])
    done = {s.matrix_name for s in samples}
    if samples:
        print(f"resuming with {len(samples)} saved samples", flush=True)
    log = read_log(log_path)
    run = {"card": _card() if device == "cuda" else None, "device": device,
           "timeout_s": timeout_s, "attempted": 0, "harvested": 0,
           "seconds": 0.0, "launches": {}}
    log["runs"].append(run)
    entries = [n for n, _ in corpus(quick)]
    if names is not None:
        unknown = set(names) - set(entries)
        if unknown:
            raise ValueError(f"not in the corpus: {sorted(unknown)}")
        entries = [n for n in entries if n in set(names)]
    first = tuple(first)
    order = ([n for n in entries if n.startswith(first)]
             + [n for n in entries if not n.startswith(first)])
    t_start = time.time()
    with tempfile.TemporaryDirectory(prefix="ia_harvest_") as td:
        out = os.path.join(td, "one.npz")
        for name in order:
            if time.time() - t_start > max_seconds:
                print(f"--max-seconds {max_seconds:g} spent; stopping with "
                      f"{len(samples)} samples", flush=True)
                break
            if name in done:
                continue
            if os.path.exists(out):
                os.remove(out)
            t0 = time.time()
            rc, text = _run_worker(_worker_command(name, out, quick, device),
                                   timeout_s)
            sys.stdout.write(text)
            rec = {"rc": rc, "seconds": round(time.time() - t0, 3),
                   "winner": None, "launches": {}}
            lines = text.strip().splitlines()
            if lines and lines[-1].startswith('{"launches"'):
                tail = json.loads(lines[-1])
                rec["launches"] = tail["launches"]
                at = tail["at"]
                # the worker's wall seconds: start-up and imports, the
                # matrices built on the host, copied to the device (the
                # CUDA context's creation included), the harvest
                rec["phases"] = {
                    "start": round(at["imported"] - t0, 3),
                    "build": round(at["built"] - at["imported"], 3),
                    "to_device": round(at["on_device"] - at["built"], 3),
                    "harvest": round(at["done"] - at["on_device"], 3)}
            if rc is None:
                rec["status"] = "timeout"
            elif rc != 0:
                rec["status"] = "failed"
            elif not os.path.exists(out):
                rec["status"] = "no_winner"
            else:
                rec["status"] = "ok"
                got = upcycle.load_samples(out)
                samples.extend(got)
                rec["winner"] = got[-1].winner
                _save_samples(samples_path, samples)
                run["harvested"] += 1
            if rec["status"] != "ok":
                rec["output"] = text[-2000:]
            log["entries"][name] = rec
            run["attempted"] += 1
            for k, n in rec["launches"].items():
                run["launches"][k] = run["launches"].get(k, 0) + n
            run["seconds"] = round(time.time() - t_start, 3)
            _write_json(log_path, log)
            print(f"{name}: {rec['status']} rc={rc} winner={rec['winner']} "
                  f"({rec['seconds']} s)", flush=True)
    run["seconds"] = round(time.time() - t_start, 3)
    _write_json(log_path, log)
    counts = {a: sum(s.winner == a for s in samples) for a in MENU}
    print(f"harvest done: {len(samples)} samples {counts}; this run "
          f"attempted {run['attempted']}, harvested {run['harvested']}",
          flush=True)
    return samples


# ---------------------------------------------------------------------------
# retrain
# ---------------------------------------------------------------------------

def failures(log: dict, samples) -> list:
    """The log's entries whose last attempt failed, timed out or found no
    winner, and which the samples do not hold."""
    have = {s.matrix_name for s in samples}
    return [{"name": n, "status": e["status"], "rc": e["rc"],
             "seconds": e["seconds"]}
            for n, e in log["entries"].items()
            if e["status"] != "ok" and n not in have]


def retrain(samples_path: str, weights_out: str, report_path: str, *,
            menu: Optional[Sequence[str]] = None,
            log_path: Optional[str] = None, steps: int = 400, k: int = 5,
            device: str = "cuda") -> dict:
    """Retrain MatNet on a harvest checkpoint on `device` (the card
    unless "cpu" is named): relabel to `menu` when given, upcycle from
    the Intel weights, the in-sample pick accuracy, the weights with
    their menu, stratified k-fold accuracy against the majority class,
    and the report (the JAX report's keys and the failed entries)."""
    import torch
    from ia_spgemm_tpu_torch.models import weights
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("retrain: no CUDA card (name --device cpu to "
                           "train on the CPU)")
    samples = upcycle.load_samples(samples_path)
    if menu:
        menu = tuple(menu)
        samples = upcycle.relabel(samples, menu)
    else:
        menu = upcycle.load_samples_menu(samples_path)
        if menu is None:
            raise ValueError(f"{samples_path} records no menu: give --menu")
        menu = tuple(menu)
    counts = {a: sum(s.winner == a for s in samples) for a in menu}
    print(f"{samples_path}: {len(samples)} samples, menu {menu}, {counts}",
          flush=True)
    params, _, _ = upcycle.upcycle(samples, menu=menu, init_from="Intel",
                                   steps=steps, batch_size=16, device=dev)
    acc = upcycle.evaluate_pick_accuracy(params, samples, menu=menu,
                                         device=dev)
    weights.save_params_npz(weights_out, params, menu=menu)
    kfold_acc, folds, majority = upcycle.stratified_kfold_accuracy(
        samples, menu=menu, k=k, steps=steps, device=dev)
    log = read_log(log_path)
    report = {
        "menu": list(menu),
        "n_samples": len(samples),
        "class_counts": counts,
        "min_class_count": min(counts.values()),
        "pick_accuracy_in_sample": round(acc, 4),
        "kfold_accuracy": round(kfold_acc, 4),
        "kfold_per_fold": folds,
        "majority_baseline": round(majority, 4),
        "train_steps": steps,
        "harvest_seconds": (round(sum(r["seconds"] for r in log["runs"]), 1)
                            if log["runs"] else None),
        "failed": failures(log, samples),
    }
    _write_json(report_path, report)
    print(json.dumps(report), flush=True)
    return report


def log_summary(log: dict) -> dict:
    """A harvest log in numbers: the entries by status, the workers'
    wall seconds and their phases (sum, median, max), the kernel launches
    of every entry's last attempt, and each run."""
    entries = list(log["entries"].values())

    def stats(xs):
        return {"sum": round(float(np.sum(xs)), 3),
                "median": float(np.median(xs)) if xs else None,
                "max": max(xs, default=None)}

    status, launches, phases = {}, {}, {}
    for e in entries:
        status[e["status"]] = status.get(e["status"], 0) + 1
        for k, n in e["launches"].items():
            launches[k] = launches.get(k, 0) + n
        for k, t in e.get("phases", {}).items():
            phases.setdefault(k, []).append(t)
    return {"entries": len(entries), "status": status,
            "worker_seconds": stats([e["seconds"] for e in entries]),
            "phases": {k: stats(v) for k, v in phases.items()},
            "launches": launches,
            "runs": [{k: r[k] for k in ("card", "timeout_s", "attempted",
                                        "harvested", "seconds")}
                     for r in log["runs"]]}


# ---------------------------------------------------------------------------
# near ties
# ---------------------------------------------------------------------------

def _device_ms(s, menu) -> dict:
    return {n: t[0] for n, t in s.times.items() if n in menu and t[0] > 0}


def near_ties(samples, repeat, menu: Sequence[str] = MENU) -> dict:
    """The device timer's run-to-run spread (|t1 - t2| / min(t1, t2) of
    each menu row that two harvests timed on the same entry) and the
    labels whose runner-up lies within it ((t2nd - t1st) / t1st), at the
    spread's median and 90th percentile; and the entries whose winner
    differs between the two harvests."""
    again = {s.matrix_name: s for s in repeat}
    rel = []
    flips = []
    for s in samples:
        r = again.get(s.matrix_name)
        if r is None:
            continue
        a, b = _device_ms(s, menu), _device_ms(r, menu)
        rel += [abs(a[n] - b[n]) / min(a[n], b[n]) for n in a if n in b]
        if s.winner != r.winner:
            flips.append(s.matrix_name)
    margins = {}
    for s in samples:
        t = sorted(_device_ms(s, menu).values())
        if len(t) > 1:
            margins[s.matrix_name] = (t[1] - t[0]) / t[0]
    out = {"repeated_entries": sum(s.matrix_name in again for s in samples),
           "rows_timed_twice": len(rel), "winner_flips": flips,
           "samples": len(samples), "samples_with_a_runner_up": len(margins)}
    for q in (50, 90):
        spread = float(np.percentile(rel, q)) if rel else None
        ties = ([] if spread is None else
                sorted(n for n, m in margins.items() if m <= spread))
        out[f"spread_p{q}"] = spread
        out[f"near_ties_p{q}"] = len(ties)
        out[f"near_tie_names_p{q}"] = ties
    return out


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def _outputs(args) -> dict:
    """Every output path, from its flag or from --out-dir."""
    paths = {}
    for key, default in OUT_NAMES.items():
        given = getattr(args, key)
        if given is None and args.out_dir is not None:
            os.makedirs(args.out_dir, exist_ok=True)
            given = os.path.join(args.out_dir, default)
        paths[key] = given
    return paths


def _need(paths: dict, *keys) -> None:
    missing = [k for k in keys if paths[k] is None]
    if missing:
        raise SystemExit("give --out-dir or --" + ", --".join(
            k.replace("_", "-") for k in missing))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}",
                                 description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--worker", metavar="NAME")
    mode.add_argument("--retrain", metavar="SAMPLES")
    mode.add_argument("--list", action="store_true")
    mode.add_argument("--ties", nargs=2, metavar=("SAMPLES", "REPEAT"))
    mode.add_argument("--summary", metavar="LOG")
    ap.add_argument("--out", help="the worker's sample file")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out-dir")
    ap.add_argument("--samples")
    ap.add_argument("--weights-out")
    ap.add_argument("--report")
    ap.add_argument("--harvest-log")
    ap.add_argument("--max-seconds", type=float, default=float("inf"))
    ap.add_argument("--first", default="")
    ap.add_argument("--names", default=None)
    ap.add_argument("--harvest-only", action="store_true")
    ap.add_argument("--menu", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--kfold", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.worker is not None:
        if not args.out:
            ap.error("--worker needs --out")
        return worker(args.worker, args.out, args.quick, args.device)
    if args.list:
        names = [n for n, _ in corpus(args.quick)]
        print("\n".join(names))
        print(f"{len(names)} entries", flush=True)
        return 0
    if args.summary:
        print(json.dumps(log_summary(read_log(args.summary))))
        return 0
    if args.ties:
        print(json.dumps(near_ties(upcycle.load_samples(args.ties[0]),
                                   upcycle.load_samples(args.ties[1]))))
        return 0
    # the JAX script's training budget: 400 steps, 5 folds (quick: 120, 3)
    steps = args.steps or (120 if args.quick else 400)
    k = args.kfold or (3 if args.quick else 5)
    paths = _outputs(args)
    if args.retrain is not None:
        _need(paths, "weights_out", "report")
        retrain(args.retrain, paths["weights_out"], paths["report"],
                menu=args.menu.split(",") if args.menu else None,
                log_path=paths["harvest_log"], steps=steps, k=k,
                device=args.device)
        return 0
    _need(paths, "samples", "harvest_log",
          *(() if args.harvest_only else ("weights_out", "report")))
    harvest(paths["samples"], paths["harvest_log"], quick=args.quick,
            device=args.device, max_seconds=args.max_seconds,
            first=[p for p in args.first.split(",") if p],
            names=args.names.split(",") if args.names else None)
    if args.harvest_only:
        return 0
    # the retrain runs on the card: in a process of its own, since this
    # one never touches the card
    cmd = [sys.executable, "-m", MODULE, "--retrain", paths["samples"],
           "--weights-out", paths["weights_out"], "--report",
           paths["report"], "--harvest-log", paths["harvest_log"],
           "--steps", str(steps), "--kfold", str(k), "--device",
           args.device]
    rc, text = _run_worker(cmd, timeout_s=None)
    sys.stdout.write(text)
    return rc


if __name__ == "__main__":
    sys.exit(main())
