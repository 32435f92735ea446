"""Drive the PyTorch/CUDA port (ia_spgemm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero and
prints no result line:

1. device check: a CUDA GPU must be present; prints the card's name,
   power limit and compute mode (nvidia-smi), the CUDA version torch was
   built for, nvcc's version;
2. build: compiles csrc/*.cu for sm_90a, one nvcc per source, in
   parallel (ia_spgemm_tpu_torch/_build.py);
3. kernels against their plain PyTorch versions on the card, on the
   inputs the main paths give them: K1-K4 on the headline's width
   classes and the skew matrix's wide classes, K8 + K3 on the headline's
   slab plan, K9 + K10 on its compensated slab plan, K7a + K7b on the
   headline's flat plan (width 1024, run 32; sorted packed keys
   bit-identical), K11 on build_matrix(m=16384) (A as ELL times dense B,
   16384 x 16384), K12 on the headline ELL pair (Ka = Kb = 29, H = 2048;
   each row's slots compared sorted by column); K5 and K6 + K3 (float64)
   on the float64 headline's chunked width classes, K5, K6 + K3 and K4
   (float64) on the skew x band classes, K6 + K3 on the flat float64
   headline (width 1024, run 32) and on the float32 wide x band flat
   plan (width 1024, run 8), and K5 at width 1024 beside K6 + K3 on those
   two. Structure exact, float32 values within 1e-5 * max(1, max|C|)
   (duplicates are summed in another order), float64 values and
   compensated hi + lo within 1e-12 * max(1, max|C|); median ms of each
   over CUDA events, beside the plain version's, one PyTorch call
   computing the same function where there is one (torch.sort of the
   keys for K4-K6, torch.sparse.mm for K11), and the bound (inputs read
   once and outputs written once at 3.35 TB/s, or K11's float32
   operations at 67 TFLOP/s, whichever is longer);
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
11. CLI: ``--mode csr``, ``esc`` and ``compensated`` with --no-matnet;
12. serve: spgemm_bitonic(value_mode="bf16", compact=False) on the
    headline: scipy's nnz and pattern exactly, checksum within
    SERVE_CHECKSUM_TOL (2e-2);
13. hash: spgemm_hash -> compact_ell -> ell_to_csr on the headline,
    scipy's pattern, within 1e-4;
14. dense_row: spgemm_dense_row on build_matrix(m=16384) against scipy
    within 1e-4;
15. selection: select_algorithm on the headline with the Intel, P100 and
    TPU weights must make the JAX package's picks (HEADLINE_PICKS);
    logits and the host time of features + images + MatNet, and of each
    of the three alone (Intel weights); then
    spgemm_auto with the TPU weights (bitonic, flat route) returns a flat
    CSR with scipy's pattern;
16. the input-aware CLI on the m=4096 .mtx: --mode all with MatNet
    (Intel), --mode autotune, --profile gpu, --imgs-dir, and --mode dia on
    a 5-point 2-D Laplacian (m = 262,144): rc 0, every row ok or skipped
    and none failed, a winner and a MatNet verdict, the dia row run;
17. f64_flat and f64_multiclass: the flat spgemm_bitonic (K6 + K3) and
    the chunked width-class route (K5, K6 + K3) on the headline in
    float64: scipy's nnz (7,086,306) and pattern, values and checksum
    within 1e-9 of the float64 oracle;
18. f64_skew: the width-class route on build_skew_matrix() times a
    7-diagonal band, float64 (classes 128 to 8192: K4 in float64);
19. f32_wide_flat: the flat route on build_matrix(extra_per_row=60)
    (rows of up to ~100 entries) times the band, float32, outside the
    gather budget (ka * 128 > 8192): K6 + K3, within 1e-4 of scipy;
20. the harness's baseline, bitonic and csr rows on the m=4096 CLI
    input in float64, each ok within the 1e-9 gate;
21. the isolated watchdog: a _test_slow worker (start-up grace lowered to
    3 s) times out and is killed, then an isolated bitonic row runs ok,
    then the CLI's --mode all --isolate --no-matnet on the m=4096 .mtx:
    rc 0, no row failed.

Every kernel wrapper counts its launches. Phases 4, 5, 7-10, 12-15 and
17-19 each drive a main path on its own input: the counts are set to 0
just before each run and read just after it. K1 must have been launched
in phase 4, K2, K3 and K4 in phase 5, K8 and K3 in phase 7, K9 and K10
in phase 9, K8 in the hybrid run of phase 10, K7a and K7b in phase 12,
K12 in 13, K11 in 14, the flat route's kernels in spgemm_auto (15), K6
and K3 in f64_flat and f32_wide_flat, K5, K6 and K3 in f64_multiclass,
K4 in f64_skew. Phase 3's comparison launches and the CLI's are not
counted. The line before the last two is a JSON object with one entry
per kernel ("ms"/"plain_ms"/"library_ms"/"bound_ms": summed over its
phase-3 shapes, "bound_by" the larger term; "launches": the sum over the
main-path runs, split in "launches_by_run"); then the nvidia-smi line;
the last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

TOL = 1e-5          # relative to max(1, max|C|)
F64_TOL = 1e-12     # float64 values, relative to max(1, max|C|)
DD_TOL = 1e-12      # compensated hi + lo, relative to max(1, max|C|)
ORACLE_TOL = 1e-4   # against scipy, as the JAX package's tests
F64_ORACLE_TOL = 1e-9   # float64 routes against scipy (the harness's gate)
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): device memory, and
# float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
HEADLINE_NNZ = 7_086_306
# the route the JAX package's cost model (esc.predict_csr_route_ms) ranks
# first on the m=32768 headline (tests/test_torch_esc.py checks it)
HEADLINE_AUTO_ROUTE = "tiled"
HYBRID_M = 32768
# the JAX package's MatNet picks on the headline, C = A @ A: (algorithm,
# class) per weight set (JAX on the CPU, float64 features; the logits'
# margins are wide: Intel [7.24, 3.04, -3.47, 0.47, -6.21], P100
# [-3.46, -9.80, 9.64], TPU [-0.68, 0.16, -4.37, -1.59, 7.62])
HEADLINE_PICKS = {"Intel": ("baseline", 0), "P100": ("bitonic", 2),
                  "TPU": ("bitonic", 4)}
DENSE_ROW_M = 16384      # dense B + C = 2.1 GB, within the 6 GiB budget
LAPLACIAN_SIDE = 512     # 5-point 2-D Laplacian, m = 262,144
SOURCES = {"bitonic": "ia_spgemm_tpu_torch/csrc/bitonic.cu",
           "slab": "ia_spgemm_tpu_torch/csrc/slab.cu",
           "dense_row": "ia_spgemm_tpu_torch/csrc/dense_row.cu",
           "hash": "ia_spgemm_tpu_torch/csrc/hash.cu"}
REPLACES = {"K1": "ia_spgemm_tpu/ops/bitonic.py:1034",
            "K2": "ia_spgemm_tpu/ops/bitonic.py:977",
            "K3": "ia_spgemm_tpu/ops/bitonic.py:523",
            "K4": "ia_spgemm_tpu/ops/bitonic.py:241",
            "K5": "ia_spgemm_tpu/ops/bitonic.py:657",
            "K6": "ia_spgemm_tpu/ops/bitonic.py:346",
            "K7a": "ia_spgemm_tpu/ops/bitonic.py:1056",
            "K7b": "ia_spgemm_tpu/ops/bitonic.py:1086",
            "K8": "ia_spgemm_tpu/ops/slab.py:99",
            "K9": "ia_spgemm_tpu/ops/slab.py:306",
            "K10": "ia_spgemm_tpu/ops/slab.py:369",
            "K11": "ia_spgemm_tpu/ops/dense_row.py:35",
            "K12": "ia_spgemm_tpu/ops/hash_spgemm.py:58"}


def _compare(name, got, want):
    """(col, val, nnz): structure exact, values within TOL (float32) or
    F64_TOL (float64) of max(1, max|C|)."""
    import torch
    (c1, v1, n1), (c2, v2, n2) = got, want
    torch.cuda.synchronize()
    if not (torch.equal(c1, c2) and torch.equal(n1, n2)
            and v1.dtype == v2.dtype):
        raise AssertionError(f"{name}: kernel and plain structure differ")
    if v1.numel() == 0:
        return 0.0
    tol = F64_TOL if v2.dtype == torch.float64 else TOL
    err = (v1 - v2).abs().max().item()
    scale = max(1.0, v2.abs().max().item())
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max |dval| {err} > {tol} * {scale}")
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


def _nbytes(x):
    """Bytes of the tensors in x (a tensor or nested tuples of them)."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(y) for y in x)
    return 0


def _record(stats, time_ms, dev, kname, what, err, kern, plain, ins,
            library=None, flops=0.0):
    """Into stats: median ms of the kernel, of its plain version and of
    `library` (one PyTorch call computing the same function, or None);
    and the bound's two terms: the inputs `ins` read once plus the
    kernel's outputs written once at PEAK_BYTES_PER_S, and `flops` (the
    float32 operations these inputs need) at PEAK_F32_FLOPS."""
    bytes_ms = (_nbytes(ins) + _nbytes(kern())) / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    ms, pms = time_ms(kern, dev, 2, 20), time_ms(plain, dev, 2, 20)
    lms = time_ms(library, dev, 2, 20) if library is not None else None
    s = stats.setdefault(kname, {"ms": 0.0, "plain_ms": 0.0,
                                 "max_abs_err": 0.0, "bytes_ms": 0.0,
                                 "ops_ms": 0.0, "library_ms": None})
    s["ms"] += ms
    s["plain_ms"] += pms
    s["bytes_ms"] += bytes_ms
    s["ops_ms"] += ops_ms
    if lms is not None:
        s["library_ms"] = (s["library_ms"] or 0.0) + lms
    s["max_abs_err"] = max(s["max_abs_err"], err)
    print(f"  {kname} {what}: max_abs_err={err} ms={ms} plain_ms={pms} "
          f"library_ms={lms} bound_ms={max(bytes_ms, ops_ms)}", flush=True)


def _torch_sort(key):
    """The library yardstick of the sort kernels (K4-K6): one stable
    torch.sort of the keys alone (the value gather is left out)."""
    import torch
    return lambda: torch.sort(key, dim=1, stable=True)


def _check_cols(stats, label, time_ms, dev, key, val, *, width, start_kk,
                out_w=None):
    """The kernels of pre-expanded rows (the torch _expand_ell's) against
    their plain versions, routed as the main paths route them: K5 up to
    FUSED_MAX_WIDTH, K6 + K3 up to TRANSPOSED_MAX_WIDTH, K4 above."""
    import torch

    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K

    out_w = width if out_w is None else out_w
    kw = dict(width=width, start_kk=start_kk)
    what = (f"{label} rows={key.shape[0]} width={width} "
            f"{str(val.dtype)[6:]}")
    lib = _torch_sort(key)
    if width > bt.TRANSPOSED_MAX_WIDTH:
        f = lambda fn: fn(key, val, **kw)  # noqa: E731
        err = _compare(f"K4 {what}", f(K.sort_compress_rows),
                       f(K.sort_compress_rows_plain))
        _record(stats, time_ms, dev, "K4", what, err,
                lambda: f(K.sort_compress_rows),
                lambda: f(K.sort_compress_rows_plain), (key, val), lib)
    elif width <= bt.FUSED_MAX_WIDTH:
        f = lambda fn: fn(key, val, out_w=out_w, **kw)  # noqa: E731
        err = _compare(f"K5 {what}", f(K.sort_compress),
                       f(K.sort_compress_plain))
        _record(stats, time_ms, dev, "K5", what, err,
                lambda: f(K.sort_compress), lambda: f(K.sort_compress_plain),
                (key, val), lib)
    else:
        sk, sv = K.sort_only(key, val, **kw)
        pk, pv = K.sort_only_plain(key, val, **kw)
        torch.cuda.synchronize()
        if not torch.equal(sk, pk):
            raise AssertionError(f"K6 {what}: sorted keys differ")
        # values within a duplicate run may sit in another order:
        # compare the run sums
        err = _compare(f"K6 {what}",
                       K.compress_plain(sk, sv, width=width, out_w=width),
                       K.compress_plain(pk, pv, width=width, out_w=width))
        _record(stats, time_ms, dev, "K6", what, err,
                lambda: K.sort_only(key, val, **kw),
                lambda: K.sort_only_plain(key, val, **kw), (key, val), lib)
        f = lambda fn: fn(sk, sv, width=width, out_w=out_w)  # noqa: E731
        err = _compare(f"K3 {what}", f(K.compress), f(K.compress_plain))
        _record(stats, time_ms, dev, "K3", what, err, lambda: f(K.compress),
                lambda: f(K.compress_plain), (sk, sv))


def _k5_beside_k6_k3(key, val, *, width, start_kk, time_ms, dev):
    """K5 at a width the main paths give K6 + K3 (1024): the same output,
    and the ms of each."""
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    kw = dict(width=width, start_kk=start_kk)
    k5 = lambda: K.sort_compress(key, val, out_w=width, **kw)  # noqa: E731
    k6_k3 = lambda: K.compress(*K.sort_only(key, val, **kw),  # noqa: E731
                               width=width, out_w=width)
    _compare(f"K5 vs K6 + K3 width={width}", k5(), k6_k3())
    return {"k5_ms": time_ms(k5, dev, 2, 20),
            "k6_k3_ms": time_ms(k6_k3, dev, 2, 20)}


def _check_kernels(call, stats, label, time_ms, dev):
    """Each class of a planned call: its kernel(s) against the plain
    version(s) on the class's own inputs. A ragged (float32) call's
    classes take the gather kernels; a chunked float64 call's the cols
    layout over the torch expand."""
    import torch

    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K

    def record(kname, shape, err, kern, plain, ins, library=None):
        _record(stats, time_ms, dev, kname, f"{label} {shape}", err, kern,
                plain, ins, library)

    run = call.run
    if not call.ragged:
        if call.A.dtype == torch.float32:
            raise AssertionError(f"{label}: a chunked float32 call")
        for i, w in enumerate(call.widths):
            ac = bt._take_rows(call.A.col_ind, call.idxs[i])[:, :call.kas[i]]
            av = bt._take_rows(call.A.values, call.idxs[i])[:, :call.kas[i]]
            key, val = bt._expand_ell(ac, av, call.B.col_ind, call.B.values,
                                      width=w, run=run, chunks=call.chunks)
            _check_cols(stats, f"{label} run={run}", time_ms, dev, key, val,
                        width=w, start_kk=2 * run,
                        out_w=min(call.out_w, w))
        return
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
                       lambda: f(K.expand_sort_compress_plain), (g, avT))
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
                   lambda: K.expand_sort_plain(g, avT, **kw), (g, avT))
            for compact in (True, False):
                f = lambda fn: fn(key, val, width=w, out_w=w,  # noqa: E731
                                  compact=compact)
                err = _compare(f"K3 {shape} compact={compact}",
                               f(K.compress), f(K.compress_plain))
                record("K3", f"{shape} compact={compact}", err,
                       lambda: f(K.compress), lambda: f(K.compress_plain),
                       (key, val))
        else:
            key, val = bt._expand_rows(call.table, call.frags[i].T,
                                       call.avts[i].T, run=run, width=w)
            f = lambda fn: fn(key, val, width=w,  # noqa: E731
                              start_kk=2 * run)
            err = _compare(f"K4 {shape}", f(K.sort_compress_rows),
                           f(K.sort_compress_rows_plain))
            record("K4", shape, err, lambda: f(K.sort_compress_rows),
                   lambda: f(K.sort_compress_rows_plain), (key, val),
                   _torch_sort(key))


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
                lambda: exp_plain(g, p.avt, p.lrt, **kw), (g, p.avt, p.lrt))
        if dd:
            f = lambda fn: fn(key, val, width=w)  # noqa: E731
            err = _compare_dd(f"K10 {shape}", f(SK.compress_dd),
                              f(SK.compress_dd_plain))
            _record(stats, time_ms, dev, "K10", shape, err,
                    lambda: f(SK.compress_dd),
                    lambda: f(SK.compress_dd_plain), (key, val))
        else:
            f = lambda fn: fn(key, val, width=w, out_w=w)  # noqa: E731
            err = _compare(f"K3 {shape}", f(K.compress),
                           f(K.compress_plain))
            _record(stats, time_ms, dev, "K3", shape, err,
                    lambda: f(K.compress), lambda: f(K.compress_plain),
                    (key, val))


def _values_err(name, got, want, tol):
    """max |got - want| on the card, within tol * max(1, max|want|)."""
    import torch
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max |dval| {err} > {tol} * {scale}")
    return err


def _sorted_tables(col, val):
    """Hash tables with each row's slots sorted by column (empty slots
    last): the kernel's hash order and the plain version's column order
    then compare slot by slot."""
    import torch
    key = torch.where(col >= 0, col, 2**31 - 1)
    key, order = torch.sort(key, dim=1)
    return key, torch.gather(val, 1, order)


def _check_input_aware_kernels(H, A16, A16_ell, B16, stats, time_ms, dev):
    """K7a/K7b on the headline's flat plan, K11 on the m=16384 dense-row
    input, K12 on the headline ELL pair, each against its plain version
    at those shapes."""
    import torch

    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    from ia_spgemm_tpu_torch.ops import dense_row_kernels as DK
    from ia_spgemm_tpu_torch.ops import hash_kernels as HK
    from ia_spgemm_tpu_torch.ops import hash_spgemm

    plan = bt.plan_bitonic(H, H)
    if (plan.width, plan.run, plan.chunks) != (1024, 32, 1):
        raise AssertionError(f"headline flat plan {plan}")
    g, avT = bt._expand_gather_emajor(H.col_ind, H.values, H.col_ind,
                                      H.values, run=plan.run)
    ka = H.max_nnz_per_row
    kw = dict(ka=ka, run=plan.run, width=plan.width, start_kk=2 * plan.run)
    shape = f"headline flat rows={H.nrows} width={plan.width} run={plan.run}"
    p = K.expand_sort_packed(g, avT, **kw)
    pp = K.expand_sort_packed_plain(g, avT, **kw)
    torch.cuda.synchronize()
    if not torch.equal(p, pp):
        raise AssertionError(f"K7a {shape}: sorted packed keys differ")
    _record(stats, time_ms, dev, "K7a", shape, 0.0,
            lambda: K.expand_sort_packed(g, avT, **kw),
            lambda: K.expand_sort_packed_plain(g, avT, **kw), (g, avT))
    for compact in (False, True):
        f = lambda fn: fn(p, width=plan.width,  # noqa: E731
                          out_w=plan.width, compact=compact)
        err = _compare(f"K7b {shape} compact={compact}",
                       f(K.compress_packed), f(K.compress_packed_plain))
        _record(stats, time_ms, dev, "K7b", f"{shape} compact={compact}",
                err, lambda: f(K.compress_packed),
                lambda: f(K.compress_packed_plain), (p,))
    del g, avT, p, pp

    f = lambda fn: fn(A16_ell.col_ind, A16_ell.values, B16)  # noqa: E731
    shape = (f"A ELL {tuple(A16_ell.col_ind.shape)} x dense B "
             f"{tuple(B16.shape)}")
    err = _values_err(f"K11 {shape}", f(DK.dense_row), f(DK.dense_row_plain),
                      TOL)
    # cuSPARSE SpMM (torch.sparse.mm of A as sparse CSR), the yardstick
    nnz16 = int(A16.nnz)
    a16_sp = torch.sparse_csr_tensor(A16.row_ptr, A16.col_ind[:nnz16],
                                     A16.values[:nnz16], size=A16.shape)
    _record(stats, time_ms, dev, "K11", shape, err,
            lambda: f(DK.dense_row), lambda: f(DK.dense_row_plain),
            (A16_ell.col_ind, A16_ell.values, B16),
            lambda: torch.sparse.mm(a16_sp, B16),
            flops=2.0 * nnz16 * B16.shape[1])

    Hs = hash_spgemm._next_pow2(2 * ka * ka)
    if Hs != 2048 or not hash_spgemm.hash_viable(ka, ka, H.ncols):
        raise AssertionError(f"headline hash table {Hs}, ka {ka}")
    f = lambda fn: fn(H.col_ind, H.values, H.col_ind,  # noqa: E731
                      H.values, table_size=Hs)
    c1, v1, n1 = f(HK.hash_accumulate)
    c2, v2, n2 = f(HK.hash_accumulate_plain)
    k1, s1 = _sorted_tables(c1, v1)
    k2, s2 = _sorted_tables(c2, v2)
    shape = f"headline ELL pair rows={H.nrows} Ka=Kb={ka} H={Hs}"
    err = _compare(f"K12 {shape}", (k1, s1, n1), (k2, s2, n2))
    _record(stats, time_ms, dev, "K12", shape, err,
            lambda: f(HK.hash_accumulate),
            lambda: f(HK.hash_accumulate_plain),
            (H.col_ind, H.values, H.col_ind, H.values))


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
    import scipy.sparse as sp
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
    # the isolated watchdog's workers share the card with this process:
    # that needs the Default compute mode, not EXCLUSIVE_PROCESS
    compute_mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    from ia_spgemm_tpu_torch import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    print(f"[1] card: {smi}; compute mode {compute_mode}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}; nvcc: "
          f"{nvcc.strip().splitlines()[-1]}", flush=True)

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
    from ia_spgemm_tpu_torch.ops import dense_row_kernels as DK
    from ia_spgemm_tpu_torch.ops import esc, slab
    from ia_spgemm_tpu_torch.ops import hash_kernels as HK
    from ia_spgemm_tpu_torch.ops import slab_kernels as SK

    modules = {"bitonic": K, "slab": SK, "dense_row": DK, "hash": HK}
    kernel_names = sorted((n for mod in modules.values()
                           for n in mod.KERNELS),
                          key=lambda n: (int(n[1:].rstrip("ab")), n))
    source = {n: SOURCES[src] for src, mod in modules.items()
              for n in mod.KERNELS}

    def reset_counts():
        for mod in modules.values():
            mod.reset_launch_counts()

    def counts():
        torch.cuda.synchronize()
        return {n: c for mod in modules.values()
                for n, c in mod.launch_counts().items()}

    def launched(run, names):
        missing = [n for n in names if by_run[run][n] == 0]
        if missing:
            raise AssertionError(f"{run} run never launched {missing}")

    def ell(a, dtype=np.float32):
        return convert.csr_to_ell(CSR.from_scipy(a.astype(dtype),
                                                 device=dev),
                                  check_guard=False)

    a64 = headline.build_matrix()
    a32 = a64.astype(np.float32)
    A = CSR.from_scipy(a32, device=dev)
    # the float64 and wide-A inputs (phases 17-19): the headline in
    # float64; the row-skewed matrix times a 7-diagonal band (m = 4096),
    # whose chunked plan has classes above 1024 (K4 in float64); a wide A
    # (rows of up to ~100 entries) times the band at m = 32768, outside
    # the flat route's gather budget in float32
    H64 = ell(a64, np.float64)
    skew_a = headline.build_skew_matrix().astype(np.float64)
    skew_b = headline.build_matrix(m=skew_a.shape[0], band=3,
                                   extra_per_row=0)
    SA64, SB64 = ell(skew_a, np.float64), ell(skew_b, np.float64)
    wide_a = headline.build_matrix(extra_per_row=60).astype(np.float32)
    band_b = headline.build_matrix(band=3, extra_per_row=0).astype(
        np.float32)
    WA, WB = ell(wide_a), ell(band_b)

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
    del S
    _check_slab_kernels(A, stats, time_ms, dev)
    a16 = headline.build_matrix(m=DENSE_ROW_M).astype(np.float32)
    A16 = CSR.from_scipy(a16, device=dev)
    A16_ell = convert.csr_to_ell(A16, check_guard=False)
    B16 = convert.csr_to_dense(A16)
    _check_input_aware_kernels(H, A16, A16_ell, B16.values, stats, time_ms,
                               dev)
    _check_kernels(bt.multiclass_planned(H64, H64, assemble="bcsr"), stats,
                   "headline f64", time_ms, dev)
    _check_kernels(bt.multiclass_planned(SA64, SB64, assemble="bcsr"),
                   stats, "skew x band f64", time_ms, dev)
    split = {}
    for label, (X, Y) in {"headline f64 flat": (H64, H64),
                          "wide x band f32 flat": (WA, WB)}.items():
        plan = bt.plan_bitonic(X, Y)
        key, val = bt._expand_ell(X.col_ind, X.values, Y.col_ind, Y.values,
                                  width=plan.width, run=plan.run,
                                  chunks=plan.chunks)
        kw = dict(width=plan.width, start_kk=2 * plan.run)
        _check_cols(stats, f"{label} run={plan.run}", time_ms, dev, key, val,
                    **kw)
        split[label] = _k5_beside_k6_k3(key, val, time_ms=time_ms, dev=dev,
                                        **kw)
        del key, val
    print(json.dumps({"k5_beside_k6_k3": split}), flush=True)
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

    from ia_spgemm_tpu_torch import autotune
    from ia_spgemm_tpu_torch.bench.harness import SERVE_CHECKSUM_TOL
    from ia_spgemm_tpu_torch.ops import density, dense_row, hash_spgemm
    input_aware = {}

    # ---- 12. serve lane on the headline (launch counts from 0)
    splan = bt.plan_bitonic(H, H)
    serve = lambda: bt.spgemm_bitonic(H, H, splan,  # noqa: E731
                                      value_mode="bf16", compact=False)
    reset_counts()
    Cv = serve()
    by_run["serve"] = counts()
    launched("serve", ["K7a", "K7b"])
    got = Cv.to_scipy()
    got.sort_indices()
    if not (int(Cv.nnz) == HEADLINE_NNZ
            and np.array_equal(got.indptr, c_ref.indptr)
            and np.array_equal(got.indices, c_ref.indices)):
        raise AssertionError(f"serve: nnz {int(Cv.nnz)} or pattern differs "
                             "from scipy")
    rel = abs(float(Cv.checksum()) - ref_sum) / max(1.0, abs(ref_sum))
    if not rel <= SERVE_CHECKSUM_TOL:
        raise AssertionError(f"serve checksum rel err {rel}")
    input_aware["serve_ms"] = time_ms(serve, dev, 1, 10)
    print(f"[12] serve (bf16, compact=False): width={splan.width} "
          f"nnz={int(Cv.nnz)} rel_err={rel} "
          f"device_ms={input_aware['serve_ms']} launches={by_run['serve']}",
          flush=True)
    del Cv, got

    # ---- 13. hash route on the headline (launch counts from 0)
    reset_counts()
    Ch = convert.ell_to_csr(convert.compact_ell(hash_spgemm.spgemm_hash(H,
                                                                        H)))
    by_run["hash"] = counts()
    launched("hash", ["K12"])
    err = same_pattern("hash", Ch)
    input_aware["hash_ms"] = time_ms(lambda: hash_spgemm.spgemm_hash(H, H),
                                     dev, 1, 10)
    input_aware["hash_route_ms"] = time_ms(
        lambda: convert.ell_to_csr(convert.compact_ell(
            hash_spgemm.spgemm_hash(H, H))), dev, 1, 5)
    print(f"[13] hash: nnz={int(Ch.nnz)} max_err={err} "
          f"device_ms={input_aware['hash_ms']} (with compact_ell + "
          f"ell_to_csr {input_aware['hash_route_ms']}) "
          f"launches={by_run['hash']}", flush=True)
    del Ch

    # ---- 14. dense-row route on build_matrix(m=16384) (counts from 0)
    want16 = convert.csr_to_dense(CSR.from_scipy(
        (a16.astype(np.float64) @ a16.astype(np.float64)).tocsr(),
        device=dev)).values
    reset_counts()
    Cd = dense_row.spgemm_dense_row(A16_ell, B16)
    by_run["dense_row"] = counts()
    launched("dense_row", ["K11"])
    err = _values_err("dense_row", Cd.values, want16, ORACLE_TOL)
    del Cd, want16
    input_aware["dense_row_ms"] = time_ms(
        lambda: dense_row.spgemm_dense_row(A16_ell, B16), dev, 1, 5)
    print(f"[14] dense_row m={DENSE_ROW_M}: max_err={err} "
          f"device_ms={input_aware['dense_row_ms']} "
          f"launches={by_run['dense_row']}", flush=True)
    del A16, A16_ell, B16

    # ---- 15. selection on the headline, then spgemm_auto (TPU weights)
    for w, (algo, cls) in HEADLINE_PICKS.items():
        sel = autotune.select_algorithm(A, A, weight_name=w)   # warm
        t0 = time.perf_counter()
        sel = autotune.select_algorithm(A, A, weight_name=w)
        torch.cuda.synchronize()
        sel_ms = (time.perf_counter() - t0) * 1e3
        input_aware[f"select_{w}_host_ms"] = sel_ms
        print(f"[15] MatNet {w}: class {sel.class_index} -> {sel.algorithm} "
              f"logits={[round(float(x), 4) for x in sel.logits]} "
              f"features+images+MatNet host_ms={sel_ms}", flush=True)
        if (sel.algorithm, sel.class_index) != (algo, cls):
            raise AssertionError(f"{w} picks {sel.algorithm} (class "
                                 f"{sel.class_index}), the JAX package "
                                 f"{algo} ({cls})")
    # the selection's parts, each timed alone (host clock, synchronised)
    from ia_spgemm_tpu_torch.models import matnet, weights
    from ia_spgemm_tpu_torch.ops import features
    params, arch = weights.import_reference_weights("Intel")
    parts = {
        "features": lambda: features.feature_vector(A, A),
        "images": lambda: (density.density_image_normalized(A),
                           density.density_image_normalized(A)),
        "matnet": lambda: matnet.predict_logits(
            params, img1, img1, fv, device=dev, **arch)}
    fv = features.feature_vector(A, A)
    img1 = density.density_image_normalized(A)
    for part, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        input_aware[f"select_{part}_host_ms"] = (time.perf_counter()
                                                 - t0) * 1e3
    print("[15] selection parts (Intel, host ms): " + ", ".join(
        f"{p} {input_aware[f'select_{p}_host_ms']}" for p in parts),
        flush=True)
    want_k = (["K1"] if splan.width <= bt.FUSED_MAX_WIDTH
              else ["K2", "K3"])
    reset_counts()
    Ca, sel = autotune.spgemm_auto(A, A, weight_name="TPU")
    by_run["auto_tpu"] = counts()
    launched("auto_tpu", want_k)
    if sel.algorithm != "bitonic" or type(Ca) is not CSR:
        raise AssertionError(f"spgemm_auto ran {sel.algorithm} and "
                             f"returned {type(Ca).__name__}")
    err = same_pattern("spgemm_auto", Ca)
    print(f"[15] spgemm_auto (TPU weights): {sel.algorithm} -> flat CSR "
          f"max_err={err} launches={by_run['auto_tpu']}", flush=True)
    del Ca

    # ---- 16. the input-aware CLI
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.mtx")
        a4096 = headline.build_matrix(m=4096)
        mmio.write_mtx(path, CSR.from_scipy(a4096))
        side = LAPLACIAN_SIDE
        T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(side, side))
        lap = (sp.kron(sp.identity(side), T)
               + sp.kron(T, sp.identity(side))).tocsr()
        lap_path = os.path.join(tmp, "laplacian.mtx")
        mmio.write_mtx(lap_path, CSR.from_scipy(lap))
        imgs = os.path.join(tmp, "imgs")
        runs = {"all": [path],
                "autotune": [path, "--mode", "autotune"],
                "gpu_all": [path, "--profile", "gpu"],
                "imgs": [path, "--mode", "csr", "--imgs-dir", imgs],
                "dia": [lap_path, "--mode", "dia", "--no-matnet"]}
        for name, argv in runs.items():
            out = os.path.join(tmp, f"{name}.json")
            rc = cli.main(argv + ["--iters", "3", "--json", out])
            if rc != 0:
                raise AssertionError(f"CLI {name} returned {rc}")
            if name == "autotune":
                print("[16] CLI autotune: rc 0", flush=True)
                continue
            with open(out) as f:
                rep = json.load(f)
            bad = [r["name"] for r in rep["results"]
                   if r["error"] or not (r["ok"] or r["skipped"])]
            if bad or not rep["winner"]:
                raise AssertionError(f"CLI {name}: rows {bad} failed, "
                                     f"winner {rep['winner']!r}")
            if name in ("all", "gpu_all") and not rep["matnet_pick"]:
                raise AssertionError(f"CLI {name}: no MatNet verdict")
            rows = {r["name"]: ("ok" if r["ok"] else "skipped")
                    for r in rep["results"]}
            if name == "dia" and rows["dia"] != "ok":
                raise AssertionError("CLI --mode dia skipped the dia row")
            print(f"[16] CLI {name}: rc 0 rows={rows} winner="
                  f"{rep['winner']} matnet_pick={rep['matnet_pick']}",
                  flush=True)
        # m >= 128: every stored entry adds one count to one cell
        for fname in ("img1.txt", "img2.txt"):
            img = density.read_density_image(os.path.join(imgs, fname))
            if img.shape != (128, 128) or img.sum() != a4096.nnz:
                raise AssertionError(f"{fname}: shape {img.shape}, sum "
                                     f"{img.sum()} != nnz {a4096.nnz}")
    print(json.dumps({"input_aware": input_aware}), flush=True)

    # ---- 17-19. the cols layout's routes (launch counts from 0)
    cols = {}

    def cols_run(run, fn, want, tol, kernels):
        """One main-path run: launches, scipy's pattern, values and
        checksum within tol, then the route's device ms."""
        reset_counts()
        C = fn()
        by_run[run] = counts()
        launched(run, kernels)
        want.sort_indices()
        got = C.to_scipy()
        got.sort_indices()
        if not (int(C.nnz) == want.nnz
                and np.array_equal(got.indptr, want.indptr)
                and np.array_equal(got.indices, want.indices)):
            raise AssertionError(f"{run}: nnz {int(C.nnz)} or pattern "
                                 f"differs from scipy ({want.nnz})")
        d = abs(got - want)
        err = (d.max() if d.nnz else 0.0) / max(1.0, abs(want).max())
        ref = float(want.sum())
        rel = abs(float(C.checksum()) - ref) / max(1.0, abs(ref))
        if not (err <= tol and rel <= tol):
            raise AssertionError(f"{run}: max err {err}, checksum rel err "
                                 f"{rel} > {tol}")
        ms = time_ms(fn, dev, 1, 10)
        cols[run] = {"device_ms": ms, "max_rel_err": err,
                     "checksum_rel_err": rel, "launches": by_run[run]}
        print(f"[{run}] nnz={int(C.nnz)} max_rel_err={err} "
              f"checksum_rel_err={rel} device_ms={ms} "
              f"launches={by_run[run]}", flush=True)

    fplan = bt.plan_bitonic(H64, H64)
    if (fplan.width, fplan.run, H64.max_nnz_per_row) != (1024, 32, 29):
        raise AssertionError(f"float64 headline flat plan {fplan}")
    cols_run("f64_flat", lambda: bt.spgemm_bitonic(H64, H64, fplan), c_ref,
             F64_ORACLE_TOL, ["K6", "K3"])
    mcall = bt.multiclass_planned(H64, H64, assemble="bcsr")
    if mcall.ragged or not any(w <= bt.FUSED_MAX_WIDTH
                               for w in mcall.widths):
        raise AssertionError(f"float64 headline plan: widths "
                             f"{mcall.widths}, ragged {mcall.ragged}")
    cols_run("f64_multiclass", mcall, c_ref, F64_ORACLE_TOL,
             ["K5", "K6", "K3"])
    cols["f64_multiclass"]["widths"] = list(mcall.widths)
    scall = bt.multiclass_planned(SA64, SB64, assemble="bcsr")
    cols_run("f64_skew", scall, (skew_a @ skew_b).tocsr(), F64_ORACLE_TOL,
             ["K4"])
    cols["f64_skew"]["widths"] = list(scall.widths)
    wplan = bt.plan_bitonic(WA, WB)
    lanes = max(128, 4 * wplan.run)
    if not (65 <= WA.max_nnz_per_row <= 128 and wplan.width == 1024
            and WA.max_nnz_per_row * wplan.chunks * lanes
            > bt._EXPAND_TILE_ELEMS):
        raise AssertionError(f"wide A: max row {WA.max_nnz_per_row}, plan "
                             f"{wplan}")
    cols_run("f32_wide_flat", lambda: bt.spgemm_bitonic(WA, WB, wplan),
             (wide_a.astype(np.float64) @ band_b.astype(np.float64)).tocsr(),
             ORACLE_TOL, ["K6", "K3"])
    print(json.dumps({"cols_layout": cols}), flush=True)
    del H64, SA64, SB64, WA, WB, mcall, scall

    from ia_spgemm_tpu_torch.bench import harness
    from ia_spgemm_tpu_torch.bench import isolated as iso
    a4096 = headline.build_matrix(m=4096)

    # ---- 20. the harness on a float64 CSR (1e-9 gate)
    A4 = CSR.from_scipy(a4096, device=dev)
    rep = harness.run_benchmark(A4, A4, ("baseline", "bitonic", "csr"))
    bad = [r.name for r in rep.results if r.error or not r.ok]
    if bad:
        raise AssertionError(f"float64 harness rows failed: "
                             f"{[(r.name, r.error) for r in rep.results]}")
    print("[20] harness float64 m=4096: " + ", ".join(
        f"{r.name} {r.run_time_ms} ms sum {r.verified_sum!r}"
        for r in rep.results), flush=True)

    # ---- 21. the isolated watchdog: a hung row killed, then rows after it
    A4 = CSR.from_scipy(a4096.astype(np.float32), device=dev)
    grace = iso.STARTUP_GRACE_S
    iso.STARTUP_GRACE_S = 3.0
    try:
        t0 = time.perf_counter()
        res = iso.bench_algorithm_isolated(A4, A4, "_test_slow",
                                           timeout_s=1.0)
        slow_s = time.perf_counter() - t0
    finally:
        iso.STARTUP_GRACE_S = grace
    if not (res.timed_out and slow_s < 1.0 + 3.0 + 5.0):
        raise AssertionError(f"_test_slow: {res}, {slow_s} s")
    t0 = time.perf_counter()
    res = iso.bench_algorithm_isolated(A4, A4, "bitonic", timeout_s=5.0)
    row_s = time.perf_counter() - t0
    if not (res.ok and res.run_time_ms > 0 and not res.error):
        raise AssertionError(f"isolated bitonic row: {res}")
    print(f"[21] isolated: _test_slow timed out and was killed after "
          f"{slow_s} s; bitonic ok, {res.run_time_ms} ms in a worker of "
          f"{row_s} s wall", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.mtx")
        mmio.write_mtx(path, CSR.from_scipy(a4096))
        out = os.path.join(tmp, "isolate.json")
        t0 = time.perf_counter()
        rc = cli.main([path, "--isolate", "--no-matnet", "--iters", "3",
                       "--json", out])
        iso_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"CLI --isolate returned {rc}")
        with open(out) as f:
            rep = json.load(f)
    bad = [r["name"] for r in rep["results"]
           if r["error"] or not (r["ok"] or r["skipped"])]
    if bad:
        raise AssertionError(f"CLI --isolate: rows {bad} failed")
    print(f"[21] CLI --mode all --isolate: rc 0 in {iso_s} s, rows=" + str(
        {r["name"]: ("ok" if r["ok"] else "skipped")
         for r in rep["results"]}), flush=True)

    torch.cuda.synchronize()
    kernels = []
    for name in kernel_names:
        st = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in by_run.values()),
            "launches_by_run": {r: c[name] for r, c in by_run.items()},
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": max(st["bytes_ms"], st["ops_ms"]),
            "bound_by": ("operations" if st["ops_ms"] > st["bytes_ms"]
                         else "bytes"),
            "library_ms": st["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
