"""Drive the PyTorch/CUDA port (ia_spgemm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero and
prints no result line:

1. device check: a CUDA GPU must be present; prints the card's name and
   power limit (nvidia-smi), the CUDA version torch was built for, nvcc's
   version;
2. build: compiles csrc/*.cu for sm_90a (ia_spgemm_tpu_torch/_build.py);
3. kernels against their plain PyTorch versions on the card, on the
   inputs the main path gives them (the headline's width classes, the
   skew matrix's wide classes): structure exact, values within
   1e-5 * max(1, max|C|) (duplicates are summed in another order);
   median ms of each over CUDA events;
4. headline: bench.headline at m=32768 (nnz 7,086,306, checksum within
   1e-4 of scipy, scipy's sparsity pattern exactly);
5. skew: the width-class route on a row-skewed matrix whose classes need
   K2/K3 and K4, against scipy;
6. CLI: ``--mode bitonic --no-matnet`` on a .mtx file, in-process.

Every kernel wrapper counts its launches. Phases 4 and 5 drive the main
path (the width-class route), each on its own input: the counts are set
to 0 just before each and read just after it. K1 must have been launched
in phase 4, K2, K3 and K4 in phase 5. Phase 3's comparison launches and
phase 6's (the CLI takes the flat route where it is viable) are not
counted. The line before the last two is a JSON object with one entry
per kernel ("ms"/"plain_ms": summed medians over the phase-3 shapes;
"launches": phase 4's plus phase 5's, split in "launches_by_run"); then
the nvidia-smi line; the last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

TOL = 1e-5          # relative to max(1, max|C|)
ORACLE_TOL = 1e-4   # against scipy, as the JAX package's tests
HEADLINE_NNZ = 7_086_306
SOURCE = "ia_spgemm_tpu_torch/csrc/bitonic.cu"
REPLACES = {"K1": "ia_spgemm_tpu/ops/bitonic.py:1034",
            "K2": "ia_spgemm_tpu/ops/bitonic.py:977",
            "K3": "ia_spgemm_tpu/ops/bitonic.py:523",
            "K4": "ia_spgemm_tpu/ops/bitonic.py:241"}


def _compare(name, got, want):
    import torch
    (c1, v1, n1), (c2, v2, n2) = got, want
    torch.cuda.synchronize()
    if not (torch.equal(c1, c2) and torch.equal(n1, n2)):
        raise AssertionError(f"{name}: kernel and plain structure differ")
    if v1.numel() == 0:
        return 0.0
    err = (v1 - v2).abs().max().item()
    scale = max(1.0, v2.abs().max().item())
    if not err <= TOL * scale:
        raise AssertionError(f"{name}: max |dval| {err} > {TOL} * {scale}")
    return err


def _check_kernels(call, stats, label, time_ms, dev):
    """Each class of a planned call: its kernel(s) against the plain
    version(s) on the class's own inputs."""
    import torch

    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K

    def record(kname, shape, err, kern, plain):
        ms, pms = time_ms(kern, dev, 2, 20), time_ms(plain, dev, 2, 20)
        s = stats.setdefault(kname, {"ms": 0.0, "plain_ms": 0.0,
                                     "max_abs_err": 0.0})
        s["ms"] += ms
        s["plain_ms"] += pms
        s["max_abs_err"] = max(s["max_abs_err"], err)
        print(f"  {kname} {label} {shape}: max_abs_err={err} ms={ms} "
              f"plain_ms={pms}", flush=True)

    run = call.run
    for i, w in enumerate(call.widths):
        n = call.counts[i]
        shape = f"width={w} rows={n} run={run}"
        if w <= bt.TRANSPOSED_MAX_WIDTH:
            pack = bt._pg_pack(run, w) if call.pregather else 1
            g = call.frags[i] if call.pregather else call.table[
                call.frags[i].reshape(-1).long()].reshape(
                    call.kas[i], n, call.table.shape[1])
            avT = call.avts[i]
            kw = dict(ka=call.kas[i], run=run, width=w, start_kk=2 * run,
                      pack=pack)
            if w <= bt.FUSED_MAX_WIDTH:
                f = lambda fn: fn(g, avT, out_w=w, **kw)  # noqa: E731
                err = _compare(f"K1 {shape}", f(K.expand_sort_compress),
                               f(K.expand_sort_compress_plain))
                record("K1", f"{shape} pack={pack}", err,
                       lambda: f(K.expand_sort_compress),
                       lambda: f(K.expand_sort_compress_plain))
                continue
            key, val = K.expand_sort(g, avT, **kw)
            pkey, pval = K.expand_sort_plain(g, avT, **kw)
            torch.cuda.synchronize()
            if not torch.equal(key, pkey):
                raise AssertionError(f"K2 {shape}: sorted keys differ")
            # values within a duplicate run may sit in another order:
            # compare the run sums
            err = _compare(f"K2 {shape}",
                           K.compress_plain(key, val, width=w, out_w=w),
                           K.compress_plain(pkey, pval, width=w, out_w=w))
            record("K2", shape, err, lambda: K.expand_sort(g, avT, **kw),
                   lambda: K.expand_sort_plain(g, avT, **kw))
            for compact in (True, False):
                f = lambda fn: fn(key, val, width=w, out_w=w,  # noqa: E731
                                  compact=compact)
                err = _compare(f"K3 {shape} compact={compact}",
                               f(K.compress), f(K.compress_plain))
                record("K3", f"{shape} compact={compact}", err,
                       lambda: f(K.compress), lambda: f(K.compress_plain))
        else:
            key, val = bt._expand_rows(call.table, call.frags[i].T,
                                       call.avts[i].T, run=run, width=w)
            f = lambda fn: fn(key, val, width=w,  # noqa: E731
                              start_kk=2 * run)
            err = _compare(f"K4 {shape}", f(K.sort_compress_rows),
                           f(K.sort_compress_rows_plain))
            record("K4", shape, err, lambda: f(K.sort_compress_rows),
                   lambda: f(K.sort_compress_rows_plain))


def _against_scipy(name, C, want):
    d = abs(C.to_scipy() - want)
    err = d.max() if d.nnz else 0.0
    scale = max(1.0, abs(want).max())
    if not (int(C.nnz) == want.nnz and err <= ORACLE_TOL * scale):
        raise AssertionError(f"{name}: nnz {int(C.nnz)} vs {want.nnz}, "
                             f"max err {err} (scale {scale})")
    return err


def main() -> int:
    # the tuned fused width (reports/bench_tuning.json) must be in the
    # environment before the port's ops.bitonic is imported
    from ia_spgemm_tpu_torch.bench import headline
    headline.apply_bench_tuning()
    import numpy as np
    import torch

    # ---- 1. device check
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    from ia_spgemm_tpu_torch import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    print(f"[1] card: {smi}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; nvcc: {nvcc.strip().splitlines()[-1]}",
          flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"[2] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})", flush=True)
    print(_build.library_path().with_suffix(".log").read_text().strip()
          if _build.build_seconds is not None else "[2] (prebuilt)")

    from ia_spgemm_tpu_torch.bench.harness import time_ms
    from ia_spgemm_tpu_torch.cli import main as cli
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.io import mmio
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K

    def ell(a):
        return convert.csr_to_ell(CSR.from_scipy(a.astype(np.float32),
                                                 device=dev),
                                  check_guard=False)

    # ---- 3. kernels against plain versions at the main path's shapes
    print(f"[3] kernel vs plain (FUSED_MAX_WIDTH={bt.FUSED_MAX_WIDTH})",
          flush=True)
    stats = {}
    H = ell(headline.build_matrix())
    _check_kernels(bt.multiclass_planned(H, H, assemble="bcsr",
                                         pregather=True, run_override=8),
                   stats, "headline", time_ms, dev)
    skew = headline.build_skew_matrix()
    S = ell(skew)
    _check_kernels(bt.multiclass_planned(S, S, assemble="bcsr"), stats,
                   "skew", time_ms, dev)
    del H, S
    missing = set(K.KERNELS) - set(stats)
    if missing:
        raise AssertionError(f"phase 3 never reached {sorted(missing)}")

    # ---- 4. headline (main path, launch counts from 0)
    K.reset_launch_counts()
    result, C, c_ref = headline.run_headline(m=32768, device="cuda")
    torch.cuda.synchronize()
    by_run = {"headline": K.launch_counts()}
    det = result["detail"]
    c_ref = c_ref.tocsr()
    c_ref.sort_indices()
    got = C.to_scipy()
    if det["nnz_out"] != HEADLINE_NNZ or c_ref.nnz != HEADLINE_NNZ:
        raise AssertionError(f"headline nnz {det['nnz_out']} "
                             f"(scipy {c_ref.nnz}) != {HEADLINE_NNZ}")
    if not det["checksum_rel_err"] <= ORACLE_TOL:
        raise AssertionError(f"headline checksum rel err "
                             f"{det['checksum_rel_err']}")
    if not (np.array_equal(got.indptr, c_ref.indptr)
            and np.array_equal(got.indices, c_ref.indices)):
        raise AssertionError("headline sparsity pattern differs from scipy")
    if by_run["headline"]["K1"] == 0:
        raise AssertionError("headline never launched K1")
    print(f"[4] headline: device_ms={det['device_ms']} "
          f"GFLOPS={result['value']} scipy_ms={det['scipy_ms']} "
          f"rel_err={det['checksum_rel_err']} widths={det['widths']} "
          f"launches={by_run['headline']}", flush=True)
    print(json.dumps(result), flush=True)
    del C, got

    # ---- 5. skew slice (main path, launch counts from 0)
    S = ell(skew)
    K.reset_launch_counts()
    call = bt.multiclass_planned(S, S, assemble="bcsr")
    Cs = call()
    torch.cuda.synchronize()
    by_run["skew"] = K.launch_counts()
    err = _against_scipy("skew", Cs, (skew.astype(np.float64)
                                      @ skew.astype(np.float64)).tocsr())
    for name in ("K2", "K3", "K4"):
        if by_run["skew"][name] == 0:
            raise AssertionError(f"skew slice never launched {name}")
    print(f"[5] skew: widths={call.widths} nnz={int(Cs.nnz)} "
          f"max_err={err} launches={by_run['skew']}", flush=True)

    # ---- 6. CLI
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.mtx")
        mmio.write_mtx(path, CSR.from_scipy(headline.build_matrix(m=4096)))
        rc = cli.main([path, "--mode", "bitonic", "--no-matnet",
                       "--iters", "3"])
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    print("[6] CLI --mode bitonic: rc 0", flush=True)

    torch.cuda.synchronize()
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name],
                "launches": sum(c[name] for c in by_run.values()),
                "launches_by_run": {r: c[name] for r, c in by_run.items()},
                "max_abs_err": stats[name]["max_abs_err"],
                "ms": stats[name]["ms"],
                "plain_ms": stats[name]["plain_ms"]}
               for name in K.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
