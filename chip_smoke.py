"""Drive the PyTorch/CUDA port (ia_spgemm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero and
prints no result line:

1. device check: a CUDA GPU must be present; prints the card's name and
   power limit (nvidia-smi), the CUDA version torch was built for, nvcc's
   version;
2. build: compiles csrc/*.cu for sm_90a, one nvcc per source, in
   parallel (ia_spgemm_tpu_torch/_build.py);
3. kernels against their plain PyTorch versions on the card, on the
   inputs the main paths give them: K1-K4 on the headline's width
   classes and the skew matrix's wide classes, K8 + K3 on the headline's
   slab plan, K9 + K10 on its compensated slab plan. Structure exact,
   float32 values within 1e-5 * max(1, max|C|) (duplicates are summed in
   another order), compensated hi + lo within 1e-12 * max(1, max|C|);
   median ms of each over CUDA events, beside the plain version's;
4. headline: bench.headline at m=32768 (nnz 7,086,306, checksum within
   1e-4 of scipy, scipy's sparsity pattern exactly);
5. skew: the width-class route on a row-skewed matrix whose classes need
   K2/K3 and K4, against scipy;
6. CLI: ``--mode bitonic --no-matnet`` on a .mtx file, in-process;
7. slab: spgemm_csr_slab on the headline (nnz exact, slab_to_csr gives
   scipy's row pointers and columns, checksum within 1e-4);
8. global: spgemm_csr(engine="global") on the headline against scipy,
   then the workspace-sliced path (a small workspace_elems);
9. compensated: spgemm_csr_compensated on the headline, a SlabCSR with
   values_lo within 1e-12 * max|C| of the float64 oracle (scipy on the
   float32-rounded matrix);
10. auto: plan_csr_auto picks "hybrid" on build_hybrid_matrix(m=32768)
    and answers within 1e-4 of scipy, and picks the JAX package's cost
    model's route on the headline (HEADLINE_AUTO_ROUTE); the predicted ms
    of every route beside the measured device ms of each route run;
11. CLI: ``--mode csr``, ``esc`` and ``compensated`` with --no-matnet.

Every kernel wrapper counts its launches. Phases 4, 5, 7-10 each drive a
main path on its own input: the counts are set to 0 just before each run
and read just after it. K1 must have been launched in phase 4, K2, K3
and K4 in phase 5, K8 and K3 in phase 7, K9 and K10 in phase 9, K8 in
the hybrid run of phase 10. Phase 3's comparison launches and the CLI's
are not counted. The line before the last two is a JSON object with one
entry per kernel ("ms"/"plain_ms": summed medians over its phase-3
shapes; "launches": the sum over the main-path runs, split in
"launches_by_run"); then the nvidia-smi line; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

TOL = 1e-5          # relative to max(1, max|C|)
DD_TOL = 1e-12      # compensated hi + lo, relative to max(1, max|C|)
ORACLE_TOL = 1e-4   # against scipy, as the JAX package's tests
HEADLINE_NNZ = 7_086_306
# the route the JAX package's cost model (esc.predict_csr_route_ms) ranks
# first on the m=32768 headline (tests/test_torch_esc.py checks it)
HEADLINE_AUTO_ROUTE = "tiled"
HYBRID_M = 32768
SOURCES = {"bitonic": "ia_spgemm_tpu_torch/csrc/bitonic.cu",
           "slab": "ia_spgemm_tpu_torch/csrc/slab.cu"}
REPLACES = {"K1": "ia_spgemm_tpu/ops/bitonic.py:1034",
            "K2": "ia_spgemm_tpu/ops/bitonic.py:977",
            "K3": "ia_spgemm_tpu/ops/bitonic.py:523",
            "K4": "ia_spgemm_tpu/ops/bitonic.py:241",
            "K8": "ia_spgemm_tpu/ops/slab.py:99",
            "K9": "ia_spgemm_tpu/ops/slab.py:306",
            "K10": "ia_spgemm_tpu/ops/slab.py:369"}


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


def _compare_dd(name, got, want):
    """(col, hi, lo, nnz): structure exact, hi + lo (float64) within
    DD_TOL * max(1, max|C|)."""
    import torch
    (c1, h1, l1, n1), (c2, h2, l2, n2) = got, want
    torch.cuda.synchronize()
    if not (torch.equal(c1, c2) and torch.equal(n1, n2)):
        raise AssertionError(f"{name}: kernel and plain structure differ")
    v1 = h1.double() + l1.double()
    v2 = h2.double() + l2.double()
    err = (v1 - v2).abs().max().item()
    scale = max(1.0, v2.abs().max().item())
    if not err <= DD_TOL * scale:
        raise AssertionError(f"{name}: max |dval| {err} > {DD_TOL} * "
                             f"{scale}")
    return err


def _record(stats, time_ms, dev, kname, what, err, kern, plain):
    """Median ms of the kernel and of its plain version, into stats."""
    ms, pms = time_ms(kern, dev, 2, 20), time_ms(plain, dev, 2, 20)
    s = stats.setdefault(kname, {"ms": 0.0, "plain_ms": 0.0,
                                 "max_abs_err": 0.0})
    s["ms"] += ms
    s["plain_ms"] += pms
    s["max_abs_err"] = max(s["max_abs_err"], err)
    print(f"  {kname} {what}: max_abs_err={err} ms={ms} plain_ms={pms}",
          flush=True)


def _check_kernels(call, stats, label, time_ms, dev):
    """Each class of a planned call: its kernel(s) against the plain
    version(s) on the class's own inputs."""
    import torch

    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K

    def record(kname, shape, err, kern, plain):
        _record(stats, time_ms, dev, kname, f"{label} {shape}", err, kern,
                plain)

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


def _check_slab_kernels(A, stats, time_ms, dev):
    """K8 + K3 on the slab plan of C = A @ A, K9 + K10 on its compensated
    plan, each against its plain version at the plan's shapes."""
    import torch

    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    from ia_spgemm_tpu_torch.ops import slab
    from ia_spgemm_tpu_torch.ops import slab_kernels as SK

    for dd in (False, True):
        p = slab.plan_slab_csr(A, A, dd=dd).plan
        w, F_c = p.width, p.width // p.run
        g = p.table[p.mt.reshape(-1).long()].reshape(F_c, p.n_slabs,
                                                     p.table.shape[1])
        kw = dict(ka=F_c, run=p.run, width=w, n=p.n, start_kk=2 * p.run)
        shape = f"headline slabs={p.n_slabs} width={w} run={p.run}"
        exp, exp_plain = ((SK.expand_sort_lr_dd, SK.expand_sort_lr_dd_plain)
                          if dd else (SK.expand_sort_lr,
                                      SK.expand_sort_lr_plain))
        key, val = exp(g, p.avt, p.lrt, **kw)
        pkey, pval = exp_plain(g, p.avt, p.lrt, **kw)
        torch.cuda.synchronize()
        name = "K9" if dd else "K8"
        if not torch.equal(key, pkey):
            raise AssertionError(f"{name} {shape}: sorted keys differ")
        # values within a duplicate run may sit in another order:
        # compare the run sums
        if dd:
            err = _compare_dd(f"K9 {shape}",
                              SK.compress_dd_plain(key, val, width=w),
                              SK.compress_dd_plain(pkey, pval, width=w))
        else:
            err = _compare(f"K8 {shape}",
                           K.compress_plain(key, val, width=w, out_w=w),
                           K.compress_plain(pkey, pval, width=w, out_w=w))
        _record(stats, time_ms, dev, name, shape, err,
                lambda: exp(g, p.avt, p.lrt, **kw),
                lambda: exp_plain(g, p.avt, p.lrt, **kw))
        if dd:
            f = lambda fn: fn(key, val, width=w)  # noqa: E731
            err = _compare_dd(f"K10 {shape}", f(SK.compress_dd),
                              f(SK.compress_dd_plain))
            _record(stats, time_ms, dev, "K10", shape, err,
                    lambda: f(SK.compress_dd),
                    lambda: f(SK.compress_dd_plain))
        else:
            f = lambda fn: fn(key, val, width=w, out_w=w)  # noqa: E731
            err = _compare(f"K3 {shape}", f(K.compress),
                           f(K.compress_plain))
            _record(stats, time_ms, dev, "K3", shape, err,
                    lambda: f(K.compress), lambda: f(K.compress_plain))


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
    libs = ", ".join(_build.library_path(n).name for n in _build.SOURCES)
    print(f"[2] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s ({libs})", flush=True)
    for name in _build.SOURCES:
        print(_build.library_path(name).with_suffix(".log").read_text()
              .strip() if _build.build_seconds is not None
              else "[2] (prebuilt)")

    from ia_spgemm_tpu_torch.bench.harness import time_ms
    from ia_spgemm_tpu_torch.cli import main as cli
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR, SlabCSR
    from ia_spgemm_tpu_torch.io import mmio
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    from ia_spgemm_tpu_torch.ops import esc, slab
    from ia_spgemm_tpu_torch.ops import slab_kernels as SK

    kernel_names = list(K.KERNELS) + list(SK.KERNELS)
    source = {**{n: SOURCES["bitonic"] for n in K.KERNELS},
              **{n: SOURCES["slab"] for n in SK.KERNELS}}

    def reset_counts():
        K.reset_launch_counts()
        SK.reset_launch_counts()

    def counts():
        torch.cuda.synchronize()
        return {**K.launch_counts(), **SK.launch_counts()}

    def launched(run, names):
        missing = [n for n in names if by_run[run][n] == 0]
        if missing:
            raise AssertionError(f"{run} run never launched {missing}")

    def ell(a):
        return convert.csr_to_ell(CSR.from_scipy(a.astype(np.float32),
                                                 device=dev),
                                  check_guard=False)

    a32 = headline.build_matrix().astype(np.float32)
    A = CSR.from_scipy(a32, device=dev)

    # ---- 3. kernels against plain versions at the main paths' shapes
    print(f"[3] kernel vs plain (FUSED_MAX_WIDTH={bt.FUSED_MAX_WIDTH})",
          flush=True)
    stats = {}
    H = ell(a32)
    _check_kernels(bt.multiclass_planned(H, H, assemble="bcsr",
                                         pregather=True, run_override=8),
                   stats, "headline", time_ms, dev)
    skew = headline.build_skew_matrix()
    S = ell(skew)
    _check_kernels(bt.multiclass_planned(S, S, assemble="bcsr"), stats,
                   "skew", time_ms, dev)
    del H, S
    _check_slab_kernels(A, stats, time_ms, dev)
    missing = set(kernel_names) - set(stats)
    if missing:
        raise AssertionError(f"phase 3 never reached {sorted(missing)}")

    # ---- 4. headline (main path, launch counts from 0)
    reset_counts()
    result, C, c_ref = headline.run_headline(m=32768, device="cuda")
    by_run = {"headline": counts()}
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
    launched("headline", ["K1"])
    print(f"[4] headline: device_ms={det['device_ms']} "
          f"GFLOPS={result['value']} scipy_ms={det['scipy_ms']} "
          f"rel_err={det['checksum_rel_err']} widths={det['widths']} "
          f"launches={by_run['headline']}", flush=True)
    print(json.dumps(result), flush=True)
    del C, got
    ref_sum = float(c_ref.sum())

    def same_pattern(name, C):
        got = C.to_scipy()
        got.sort_indices()
        if not (np.array_equal(got.indptr, c_ref.indptr)
                and np.array_equal(got.indices, c_ref.indices)):
            raise AssertionError(f"{name}: sparsity pattern differs from "
                                 "scipy")
        return _against_scipy(name, C, c_ref)

    # ---- 5. skew slice (main path, launch counts from 0)
    S = ell(skew)
    reset_counts()
    call = bt.multiclass_planned(S, S, assemble="bcsr")
    Cs = call()
    by_run["skew"] = counts()
    err = _against_scipy("skew", Cs, (skew.astype(np.float64)
                                      @ skew.astype(np.float64)).tocsr())
    launched("skew", ["K2", "K3", "K4"])
    print(f"[5] skew: widths={call.widths} nnz={int(Cs.nnz)} "
          f"max_err={err} launches={by_run['skew']}", flush=True)
    del S, Cs, call

    # ---- 6. CLI
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.mtx")
        mmio.write_mtx(path, CSR.from_scipy(headline.build_matrix(m=4096)))
        rc = cli.main([path, "--mode", "bitonic", "--no-matnet",
                       "--iters", "3"])
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    print("[6] CLI --mode bitonic: rc 0", flush=True)

    measured = {"headline": {}, "hybrid": {}}

    # ---- 7. slab engine on the headline (launch counts from 0)
    reset_counts()
    Cs = slab.spgemm_csr_slab(A, A)
    by_run["slab"] = counts()
    launched("slab", ["K8", "K3"])
    if int(Cs.nnz) != HEADLINE_NNZ:
        raise AssertionError(f"slab nnz {int(Cs.nnz)} != {HEADLINE_NNZ}")
    rel = abs(float(Cs.checksum()) - ref_sum) / max(1.0, abs(ref_sum))
    if not rel <= ORACLE_TOL:
        raise AssertionError(f"slab checksum rel err {rel}")
    err = same_pattern("slab_to_csr", slab.slab_to_csr(Cs))
    scall = slab.plan_slab_csr(A, A)
    measured["headline"]["slab"] = time_ms(scall, dev, 1, 10)
    print(f"[7] slab: width={scall.plan.width} slabs={scall.plan.n_slabs} "
          f"nnz={int(Cs.nnz)} rel_err={rel} max_err={err} "
          f"device_ms={measured['headline']['slab']} "
          f"launches={by_run['slab']}", flush=True)
    del Cs

    # ---- 8. global engine on the headline, then sliced
    plan = esc.plan_spgemm(A, A)
    reset_counts()
    Cg = esc.spgemm_csr(A, A, plan, engine="global")
    by_run["global"] = counts()
    err = same_pattern("global", Cg)
    del Cg
    measured["headline"]["global"] = time_ms(
        lambda: esc.spgemm_csr(A, A, plan), dev, 1, 5)
    splan = esc.plan_spgemm(A, A, workspace_elems=1 << 21)
    if splan.slabs is None:
        raise AssertionError("workspace_elems=2^21 did not slice")
    err_s = same_pattern("global sliced", esc.spgemm_csr(A, A, splan))
    sliced_ms = time_ms(lambda: esc.spgemm_csr(A, A, splan), dev, 1, 3)
    print(f"[8] global: variant={plan.variant} b_run={plan.b_run} "
          f"max_err={err} device_ms={measured['headline']['global']}; "
          f"sliced: {len(splan.slabs) - 1} slabs max_err={err_s} "
          f"device_ms={sliced_ms}", flush=True)

    # ---- 9. compensated on the headline (launch counts from 0)
    want64 = (a32.astype(np.float64) @ a32.astype(np.float64)).tocsr()
    reset_counts()
    Cc = esc.spgemm_csr_compensated(A, A)
    by_run["compensated"] = counts()
    launched("compensated", ["K9", "K10"])
    if not (isinstance(Cc, SlabCSR) and Cc.values_lo is not None):
        raise AssertionError(f"compensated returned {type(Cc).__name__} "
                             "without values_lo")
    d = abs(Cc.to_scipy() - want64)
    err = (d.max() if d.nnz else 0.0) / max(1.0, abs(want64).max())
    if not (int(Cc.nnz) == want64.nnz and err <= DD_TOL):
        raise AssertionError(f"compensated: nnz {int(Cc.nnz)} vs "
                             f"{want64.nnz}, rel err {err}")
    del Cc, want64
    comp_ms = time_ms(lambda: esc.spgemm_csr_compensated(A, A), dev, 1, 10)
    print(f"[9] compensated: rel_err={err} device_ms={comp_ms} "
          f"launches={by_run['compensated']}", flush=True)

    # ---- 10. auto route: hybrid matrix, then the headline
    h = headline.build_hybrid_matrix(HYBRID_M).astype(np.float32)
    Hm = CSR.from_scipy(h, device=dev)
    pred = {"headline": esc.predict_csr_route_ms(A, A),
            "hybrid": esc.predict_csr_route_ms(Hm, Hm)}
    reset_counts()
    route, hcall = esc.plan_csr_auto(Hm, Hm)
    Ch = hcall()
    by_run["hybrid"] = counts()
    if route != "hybrid":
        raise AssertionError(f"plan_csr_auto picked {route} on the hybrid "
                             "matrix")
    launched("hybrid", ["K8"])
    err = _against_scipy("hybrid", Ch, (h.astype(np.float64)
                                        @ h.astype(np.float64)).tocsr())
    measured["hybrid"]["hybrid"] = time_ms(hcall, dev, 1, 5)
    hplan = esc.plan_spgemm(Hm, Hm)
    measured["hybrid"]["global"] = time_ms(
        lambda: esc.spgemm_csr(Hm, Hm, hplan), dev, 1, 5)
    print(f"[10] hybrid matrix m={HYBRID_M}: route={route} "
          f"n_heavy={hcall.n_heavy} nnz={int(Ch.nnz)} max_err={err} "
          f"launches={by_run['hybrid']}", flush=True)
    del Ch, hcall, Hm
    reset_counts()
    route, tcall = esc.plan_csr_auto(A, A)
    Ct = tcall()
    by_run["auto_headline"] = counts()
    if route != HEADLINE_AUTO_ROUTE:
        raise AssertionError(f"plan_csr_auto picked {route} on the "
                             f"headline, not {HEADLINE_AUTO_ROUTE}")
    err = same_pattern("auto headline", Ct)
    del Ct
    measured["headline"][route] = time_ms(tcall, dev, 1, 10)
    routes = {m: {r: {"predicted_ms": pred[m].get(r),
                      "device_ms": measured[m].get(r)}
                  for r in sorted(set(pred[m]) | set(measured[m]))}
              for m in pred}
    print(f"[10] headline: route={route} max_err={err} "
          f"launches={by_run['auto_headline']}", flush=True)
    print(json.dumps({"routes": routes, "compensated_device_ms": comp_ms,
                      "sliced_global_device_ms": sliced_ms}), flush=True)

    # ---- 11. CLI, the ESC modes
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.mtx")
        mmio.write_mtx(path, CSR.from_scipy(headline.build_matrix(m=4096)))
        for mode in ("csr", "esc", "compensated"):
            rc = cli.main([path, "--mode", mode, "--no-matnet", "--iters",
                           "3"])
            if rc != 0:
                raise AssertionError(f"CLI --mode {mode} returned {rc}")
    print("[11] CLI --mode csr / esc / compensated: rc 0", flush=True)

    torch.cuda.synchronize()
    kernels = [{"name": name, "route": "cuda",
                "source": source[name],
                "replaces": REPLACES[name],
                "launches": sum(c[name] for c in by_run.values()),
                "launches_by_run": {r: c[name] for r, c in by_run.items()},
                "max_abs_err": stats[name]["max_abs_err"],
                "ms": stats[name]["ms"],
                "plain_ms": stats[name]["plain_ms"]}
               for name in kernel_names]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
