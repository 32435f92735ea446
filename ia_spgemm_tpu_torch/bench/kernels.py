"""K1-K9, K11 and K13 on the card at the shapes of ``chip_smoke.py``
phase 3, on inputs made from a seed: for each, the wrapper's call time
(CUDA events, median of 20), the host's microseconds per call
(``time.perf_counter`` around unsynchronised calls), the kernel's own
device time per launch (``torch.profiler``), and beside them the PyTorch
call computing the same function where there is one (``torch.sort`` of
the keys, ``torch.sparse.mm``, two ``torch.roll``s). Every output is
checked against the plain version first (structure exact, values within
1e-5 / 1e-12 of max(1, max|C|); K2's, K6's, K8's and K9's sorted keys
exactly and their run sums; K7a's sorted packed keys, K11 and K13 bit
for bit).

    python -m ia_spgemm_tpu_torch.bench.kernels [--json PATH]

Prints one JSON line: the card's name and power limit, then one entry per
shape. K1's, K2's, K3's, K5's, K7a's, K7b's, K8's and K9's cases are
``network_cases``, which ``chip_smoke.py`` phase 3 also runs: K1 on the
headline's and the skew matrix's width classes up to FUSED_MAX_WIDTH (the
tuned 512), K2 on their 1024 classes (the headline's from its pregathered
g, the skew matrix's from the table) and on the headline's flat plan
(from the table), K4t on the skew matrix's and the benchmark's cant
replica's classes above TRANSPOSED_MAX_WIDTH (beside it the torch expand
and K4 it replaced), K7a on that flat plan and K7b on K7a's sorted keys, K5
on the float64 headline's and the skew x band's chunked classes up to
FUSED_MAX_WIDTH, K3 on the rows K2, K8 and K6 sort for the main paths'
1024-slot rows, K8 and K9 on the headline's slab plan; each beside its
bytes bound (what the kernel must read, once, and its outputs written
once, at 3.35 TB/s: K5 the rows, K7b the packed keys; ``gather_bytes``
for K1 and K2 on g, ``table_read_bytes`` for the table sources of K2,
K4t, K7a, K8 and K9). K4's and K6's inputs are rows in their
input layout (sorted runs of start_kk / 2 slots, ascending and
descending in turn; keys uniform below 32768, a fifth SENTINEL); K11's A
is ``build_matrix(m=16384)`` as ELL (16384, 29) times itself dense;
K13's the headline's B block shapes (32768 / D rows of 29 int32 columns
and 29 float32 values) at D = 4 and 8 shards of one card, as a public
call (fresh receivers) and as the ring calls it (the previous hop's
receivers hopped into the other set).

``PROFILE_NAMES`` names the kernels whose own device time (and host us
per call) is recorded at each shape, here and in ``chip_smoke.py`` phase
3: the register network's K1-K3, K4t, K5, K7a, K7b, K8 and K9, K10 and
K12, which are left as they are while they run within twice their
bound, and K14, the global engine's expansion (at
``esc_expand_cases``' shapes, in ``chip_smoke.py`` alone).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from functools import partial
from typing import Callable, NamedTuple

import numpy as np

# (label, rows, width, start_kk, value type): the skew matrix's wide
# classes in float32 and (skew x band) float64, and one shard of the
# headline's ring over 4 shards
K4_SHAPES = (("skew", 32, 2048, 16, "float32"),
             ("skew", 20, 8192, 16, "float32"),
             ("skew x band", 32, 2048, 16, "float64"),
             ("skew x band", 20, 8192, 16, "float64"),
             ("ring shard", 8192, 1024, 64, "float32"))
# K6: the float32 wide x band flat route (run 8), the float64 headline's
# flat route and its width-1024 class (run 32)
K6_SHAPES = (("f32 wide x band flat", 32768, 1024, 16, "float32"),
             ("f64 headline flat", 32768, 1024, 64, "float64"),
             ("f64 headline class", 20480, 1024, 64, "float64"))
DENSE_ROW_M = 16384
K13_SHARDS = (4, 8)
HEADLINE_ROWS, HEADLINE_KB = 32768, 29
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): device memory, and
# float32 and float64 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
# the kernels measured alone at each of their shapes, by the name the
# profiler gives each
PROFILE_NAMES = {"K1": "k1_expand_sort_compress", "K2": "k2_expand_sort",
                 "K3": "k3_compress", "K4t": "k4_expand_sort_compress",
                 "K5": "k5_sort_compress",
                 "K7a": "k7a_expand_sort_packed",
                 "K7b": "k7b_compress_packed", "K8": "k8_expand_sort_lr",
                 "K9": "k9_expand_sort_lr_dd", "K10": "k10_compress_dd",
                 "K12": "k12_hash", "K14": "k14_esc_expand"}
# the network kernels whose output is the sorted row, not the compress
SORTED_CASES = ("K2", "K8", "K9")


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of fn, time.perf_counter around calls
    that are not synchronised (the card's work is left queued)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def kernel_us(fn, name: str, calls: int = 20, tries: int = 3) -> float:
    """Device microseconds per launch of the kernels whose name holds
    `name`, from torch.profiler over `calls` calls of fn. The profiler
    now and then records none of a window's launches (torch 2.11 on an
    H100): such a window is profiled again, up to `tries` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        durs = [e.time_range.end - e.time_range.start
                for e in prof.events()
                if e.device_type == DeviceType.CUDA and name in e.name]
        if durs:
            return sum(durs) / len(durs)
    raise RuntimeError(f"the profiler saw no {name} launch in {tries} "
                       "windows")


def k4_rows(m, width, start_kk, dtype, seed=0):
    """(key, val) on the host in K4's input layout for start_kk."""
    import torch
    rng = np.random.default_rng(seed + width + m)
    k = rng.integers(0, 32768, (m, width))
    k[rng.random((m, width)) < 0.2] = 2**31 - 1
    v = rng.standard_normal((m, width)).astype(dtype)
    half = start_kk // 2
    kr = k.reshape(m, width // half, half)
    order = np.argsort(kr, axis=2, kind="stable")
    order[:, 1::2] = order[:, 1::2, ::-1]
    k = np.take_along_axis(kr, order, 2).reshape(m, width)
    v = np.take_along_axis(v.reshape(m, width // half, half), order,
                           2).reshape(m, width)
    return (torch.from_numpy(k.astype(np.int32)), torch.from_numpy(v))


def _check_k4(got, want, dtype, name="K4"):
    import torch
    (c1, v1, n1), (c2, v2, n2) = got, want
    torch.cuda.synchronize()
    if not (torch.equal(c1, c2) and torch.equal(n1, n2)):
        raise AssertionError(f"{name} structure differs from the plain "
                             "version")
    tol = 1e-12 if dtype == "float64" else 1e-5
    err = (v1 - v2).abs().max().item()
    if not err <= tol * max(1.0, v2.abs().max().item()):
        raise AssertionError(f"{name} values off by {err}")
    return err


def _check_sorted(got, want, width, dtype, name="K6"):
    """Sorted keys equal; values within a duplicate run may sit in
    another order, so the run sums (the plain compress) are compared."""
    import torch

    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"{name} sorted keys differ from the plain "
                             "version")
    return _check_k4(K.compress_plain(*got, width=width, out_w=width),
                     K.compress_plain(*want, width=width, out_w=width),
                     dtype, name)


def _timings(call, library, kernel_name, dev):
    """The call's and the library's ms and host us, the kernel's us."""
    from ia_spgemm_tpu_torch.bench.harness import time_ms
    return {"call_ms": time_ms(call, dev, 2, 20),
            "call_host_us": host_us(call),
            "kernel_us": kernel_us(call, kernel_name),
            "library_ms": time_ms(library, dev, 2, 20),
            "library_host_us": host_us(library)}


def k11_segment_bytes(a_col, n, itemsize, rows=8, slots=32) -> int:
    """Bytes of B that K11 reads: one n-wide row segment per distinct
    column of each tile of ``rows`` rows and pass of kcp slots (kcp = K
    rounded up to a power of two, at most ``slots``); rows=1 counts one
    segment per live slot, as the one-row-a-block kernel read them."""
    a = np.asarray(a_col)
    m, K = a.shape
    kcp = 1
    while kcp < K and kcp < slots:
        kcp *= 2
    pad = np.full((-(-m // rows) * rows, -(-K // kcp) * kcp), -1, np.int64)
    pad[:m, :K] = a
    t = pad.reshape(-1, rows, pad.shape[1] // kcp, kcp).transpose(0, 2, 1, 3)
    t = np.sort(t.reshape(t.shape[0], t.shape[1], -1), axis=2)
    heads = (t[..., 1:] != t[..., :-1]) & (t[..., 1:] >= 0)
    segs = int(heads.sum()) + int((t[..., 0] >= 0).sum())
    return segs * n * itemsize


def _measure_k11(dev) -> dict:
    """K11 on the dense-row route's input, bit for bit against the plain
    version, beside torch.sparse.mm of A as sparse CSR (cuSPARSE SpMM)."""
    import torch

    from ia_spgemm_tpu_torch.bench.headline import build_matrix
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.ops import dense_row_kernels as DK
    A = CSR.from_scipy(build_matrix(m=DENSE_ROW_M).astype(np.float32),
                       device=dev)
    E = convert.csr_to_ell(A, check_guard=False)
    B = convert.csr_to_dense(A).values
    call = lambda: DK.dense_row(E.col_ind, E.values, B)  # noqa: E731
    got, want = call(), DK.dense_row_plain(E.col_ind, E.values, B)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K11 differs from the plain version")
    del got, want
    nnz = int(A.nnz)
    a_sp = torch.sparse_csr_tensor(A.row_ptr, A.col_ind[:nnz],
                                   A.values[:nnz], size=A.shape)
    a_col = E.col_ind.cpu().numpy()
    return {"shape": f"A ELL {tuple(E.col_ind.shape)} x dense B "
                     f"{tuple(B.shape)} float32", "max_abs_err": 0.0,
            "b_segment_gb": k11_segment_bytes(a_col, B.shape[1], 4) / 1e9,
            "b_segment_gb_one_row": k11_segment_bytes(
                a_col, B.shape[1], 4, rows=1) / 1e9,
            **_timings(call, lambda: torch.sparse.mm(a_sp, B),
                       "k11_dense_row", dev)}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def gather_bytes(run, avT) -> int:
    """Bytes a fragment-gather kernel (K1, K2 on g) must read: of each of
    the avT.shape[0] x avT.shape[1] fragments its run columns and run
    value bits (one half of the fragment's 4 * run lanes of g, the
    forward half for even fragments and the reversed half for odd; the
    other half and the lanes padding g's rows to 128 are never read),
    then avT once."""
    return avT.numel() * 2 * run * 4 + _nbytes(avT)


def table_read_bytes(table, rT, run, *arrays) -> int:
    """Bytes a table-source kernel (K2, K4t and K7a from the wide table, K8
    and K9 from the slab table) must read: the fragment index rT and the
    arrays beside it (avT; K8 and K9 also lrT) once, and of the packed
    table each half (2 * run lanes: run columns and run value bits) that
    some fragment reads, once: fragment e reads table row rT[e] at its
    forward half for even e and its reversed half for odd e (the fill row
    of empty and padding slots included). The table stays in L2, so this
    counts each read half once however many rows read it."""
    import torch
    half = torch.arange(rT.shape[0], device=rT.device)[:, None] & 1
    read = torch.unique(rT.long() * 2 + half).numel()
    return read * 2 * run * table.element_size() + _nbytes(rT, *arrays)


def class_inputs(call, i):
    """(src, avT, kw) of class i of a ragged multiclass call, as K2 takes
    them (``_multiclass_fn``): the pregathered (lane-packed) g, or the
    table with the class's fragment index (kw["rT"]; K1 takes the gather
    of its rows, ``table_gather``)."""
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    run, w = call.run, call.widths[i]
    kw = dict(ka=call.kas[i], run=run, width=w, start_kk=2 * run)
    if call.pregather:
        return call.frags[i], call.avts[i], dict(kw,
                                                 pack=bt._pg_pack(run, w))
    return call.table, call.avts[i], dict(kw, rT=call.frags[i])


def chunked_class_rows(call, i):
    """Class i of a chunked (float64) multiclass call as the torch
    ``_expand_ell`` expands it: (key, val), each (rows, width)."""
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    ac = bt._take_rows(call.A.col_ind, call.idxs[i])[:, :call.kas[i]]
    av = bt._take_rows(call.A.values, call.idxs[i])[:, :call.kas[i]]
    return bt._expand_ell(ac, av, call.B.col_ind, call.B.values,
                          width=call.widths[i], run=call.run,
                          chunks=call.chunks)


def flat_rows(X, Y):
    """The flat plan of X @ Y and its rows as ``_expand_ell`` expands
    them: (plan, key, val)."""
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    plan = bt.plan_bitonic(X, Y)
    key, val = bt._expand_ell(X.col_ind, X.values, Y.col_ind, Y.values,
                              width=plan.width, run=plan.run,
                              chunks=plan.chunks)
    return plan, key, val


def flat_operands(X):
    """The flat plan of X @ X (float32) and its table-source operands
    ((table, rT, avT), kw), as the serve lane and the flat route's K2 take
    them."""
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    plan = bt.plan_bitonic(X, X)
    ops = bt._flat_table(X.col_ind, X.values, X.col_ind, X.values,
                         run=plan.run, chunks=plan.chunks)
    return plan, ops, dict(ka=ops[1].shape[0], run=plan.run,
                           width=plan.width, start_kk=2 * plan.run)


def slab_operands(p):
    """A slab plan's kernel operands ((table, mt, avT, lrT), kw), as K8
    and K9 take them."""
    return ((p.table, p.mt, p.avt, p.lrt),
            dict(ka=p.width // p.run, run=p.run, width=p.width, n=p.n,
                 start_kk=2 * p.run))


class Case(NamedTuple):
    """One kernel at one phase-3 shape: its wrapper call and its plain
    version on the same inputs, the bytes it must read (what it writes
    is counted from what it returns), and the one PyTorch call computing
    the same function where there is one (``torch.sort`` of K5's keys;
    for K4t the torch expand then K4, the path it replaced)."""
    kernel: str
    source: str
    shape: str
    call: Callable
    plain: Callable
    read_bytes: int
    library: Callable | None = None


def _k3_case(source, shape, key, val, width, out_w, compact=True):
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    kw = dict(width=width, out_w=out_w, compact=compact)
    return Case("K3", source, f"{shape} compact={compact}",
                partial(K.compress, key, val, **kw),
                partial(K.compress_plain, key, val, **kw), _nbytes(key, val))


def k4_on_expanded_rows(table, rT, avT, *, ka, run, width, start_kk):
    """K4 on the rows the torch expand writes: what K4t replaced."""
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    key, val = K.expand_rows_plain(table, rT.T, avT.T, run=run, width=width)
    return K.sort_compress_rows(key, val, width=width, start_kk=start_kk)


def _ragged_cases(call, source):
    """K1 on each class of at most FUSED_MAX_WIDTH slots; K3, compacted
    and in place, on the rows K2 sorts for each class above it, up to
    TRANSPOSED_MAX_WIDTH; K4t on the wider ones (the ragged layout's
    fragment index is never pregathered there)."""
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    for i, w in enumerate(call.widths):
        src, avT, kw = class_inputs(call, i)
        shape = f"{source} width={w} rows={call.counts[i]} run={call.run}"
        if w > bt.TRANSPOSED_MAX_WIDTH:
            ops = (call.table, call.frags[i], avT)
            kw = dict(ka=call.kas[i], run=call.run, width=w,
                      start_kk=2 * call.run)
            yield Case("K4t", source, shape,
                       partial(K.expand_sort_compress_rows, *ops, **kw),
                       partial(K.expand_sort_compress_rows_plain, *ops,
                               **kw),
                       table_read_bytes(call.table, call.frags[i],
                                        call.run, avT),
                       partial(k4_on_expanded_rows, *ops, **kw))
            continue
        if w <= bt.FUSED_MAX_WIDTH:
            rT = kw.pop("rT", None)
            g = src if rT is None else K.table_gather(src, rT)
            kw.setdefault("pack", 1)
            yield Case("K1", source, f"{shape} pack={kw['pack']}",
                       partial(K.expand_sort_compress, g, avT, out_w=w,
                               **kw),
                       partial(K.expand_sort_compress_plain, g, avT,
                               out_w=w, **kw),
                       gather_bytes(call.run, avT))
            continue
        read = (gather_bytes(call.run, avT) if "rT" not in kw else
                table_read_bytes(src, kw["rT"], call.run, avT))
        yield Case("K2", source,
                   f"{shape} {'table' if 'rT' in kw else 'gather'}",
                   partial(K.expand_sort, src, avT, **kw),
                   partial(K.expand_sort_plain, src, avT, **kw), read)
        key, val = K.expand_sort(src, avT, **kw)
        for compact in (True, False):
            yield _k3_case(source, shape, key, val, w, w, compact)


def _flat_cases(source, X):
    """K2, K3 on K2's rows, K7a and K7b on the flat plan of X @ X
    (float32), from the table source: the kernels of spgemm_auto's
    bitonic pick and of the serve lane. The headline's plan is width
    1024, run 32, in one chunk at every m; any other plan raises, so that
    these kernels are held at the serve lane's shape."""
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    plan, ops, kw = flat_operands(X)
    if (plan.width, plan.run, plan.chunks) != (1024, 32, 1):
        raise AssertionError(f"{source} plan {plan}")
    table, rT, avT = ops
    shape = f"{source} rows={X.nrows} width={plan.width} run={plan.run}"
    read = table_read_bytes(table, rT, plan.run, avT)
    yield Case("K2", source, f"{shape} table",
               partial(K.expand_sort, table, avT, rT=rT, **kw),
               partial(K.expand_sort_plain, table, avT, rT=rT, **kw), read)
    key, val = K.expand_sort(table, avT, rT=rT, **kw)
    yield _k3_case(source, shape, key, val, plan.width, plan.width)
    del key, val
    yield Case("K7a", source, shape,
               partial(K.expand_sort_packed, *ops, **kw),
               partial(K.expand_sort_packed_plain, *ops, **kw), read)
    yield from _k7b_cases(source, shape, K.expand_sort_packed(*ops, **kw),
                          plan.width)


def _k7b_cases(source, shape, p, width):
    """K7b on K7a's sorted keys p, in place (compact=False, the serve
    lane's call) and compacted: it reads the packed keys once."""
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    for compact in (False, True):
        kw = dict(width=width, out_w=width, compact=compact)
        yield Case("K7b", source, f"{shape} compact={compact}",
                   partial(K.compress_packed, p, **kw),
                   partial(K.compress_packed_plain, p, **kw), _nbytes(p))


def _cols_cases(source, key, val, *, width, start_kk, out_w):
    """The network kernels of pre-expanded rows as the main paths route
    them: K5 up to FUSED_MAX_WIDTH (it reads the rows once; beside it one
    stable torch.sort of the keys), K3 on the rows K6 sorts above it, up
    to TRANSPOSED_MAX_WIDTH."""
    import torch

    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    shape = f"{source} rows={key.shape[0]} width={width} " \
            f"{str(val.dtype)[6:]}"
    if width <= bt.FUSED_MAX_WIDTH:
        kw = dict(width=width, start_kk=start_kk, out_w=out_w)
        yield Case("K5", source, shape, partial(K.sort_compress, key, val,
                                                **kw),
                   partial(K.sort_compress_plain, key, val, **kw),
                   _nbytes(key, val),
                   partial(torch.sort, key, dim=1, stable=True))
        return
    if width > bt.TRANSPOSED_MAX_WIDTH:
        return
    key, val = K.sort_only(key, val, width=width, start_kk=start_kk)
    yield _k3_case(source, shape, key, val, width, out_w)


def _benchmark_file(*parts):
    """A file of the repository's ``benchmark/`` directory: a module
    (loaded, under its file's stem) or a configuration (parsed JSON)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[2].joinpath("benchmark", *parts)
    if path.suffix == ".json":
        return json.loads(path.read_text())
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cant_matrix(grid=(9, 9, 257), seed=0):
    """The benchmark's cant replica (``benchmark/inputs/hex_mesh.py`` at
    ``benchmark/configs/cant.json``'s structure seed) on a hex mesh of
    `grid` nodes, 3 dof a node, nnz scaled with the rows; 9 x 9 x 257 is
    the configuration itself (C = A @ A in width classes 2048-8192, run
    32). Values standard normal from `seed`, float32."""
    hex_mesh = _benchmark_file("inputs", "hex_mesh.py")
    cfg = _benchmark_file("configs", "cant.json")
    m = int(np.prod(grid)) * cfg["dof"]
    a = hex_mesh.build(dict(cfg, grid=list(grid), m=m, n=m,
                            nnz=round(cfg["nnz"] * m / cfg["m"])),
                       cfg["structure_seed"])
    a.data = np.random.default_rng(seed).standard_normal(a.nnz)
    return a.astype(np.float32)


def benchmark_replica(config, dtype=np.float32, seed=0):
    """The benchmark's replica of `config` (``benchmark/configs/<config>
    .json``: its family's generator in ``benchmark/inputs/`` at the
    configuration's structure seed, nnz calibrated as
    ``benchmark/benchlib/inputs.py`` does), values standard normal from
    `seed`, as scipy CSR of `dtype`."""
    cfg = _benchmark_file("configs", f"{config}.json")
    inputs = _benchmark_file("benchlib", "inputs.py")
    family = _benchmark_file("inputs", f"{cfg['family']}.py")
    return inputs.generate(family, cfg, seed).astype(dtype)


def esc_expand_cases(dev):
    """K14's inputs at the benchmark's global-engine shapes, one at a
    time: (label, the wrapper's positional operands, its keywords). The
    cage12 replica in float64 through the global engine's plan (41.9 M
    slots, int64 keys); the webbase-1M replica's heavy rows (the
    hybrid's global part: 8.4 M slots, float32, int64 keys)."""
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.ops import esc, slab
    a = CSR.from_scipy(benchmark_replica("cage12", np.float64), device=dev)
    yield ("cage12 float64",) + esc_expand_operands(a, a,
                                                    esc.plan_spgemm(a, a))
    del a
    w = CSR.from_scipy(benchmark_replica("webbase-1M"), device=dev)
    call = slab.plan_slab_hybrid(w, w)
    yield ("webbase-1M heavy rows",) + esc_expand_operands(
        call.A_heavy, call.B, call.heavy_plan)


def esc_expand_operands(A, B, plan):
    """(args, kw) of the global engine's K14 call for C = A @ B under an
    unsliced plan."""
    import torch
    return ((A.row_ptr, A.col_ind, A.values, A.nnz, B.row_ptr, B.col_ind,
             B.values),
            dict(e_cap=plan.expansion_capacity, m=A.nrows, k=A.ncols,
                 n=B.ncols, val_dtype=torch.promote_types(A.values.dtype,
                                                          B.values.dtype)))


def esc_expand_read_bytes(args) -> int:
    """What K14 must read, once: A's and B's CSR arrays and the entries'
    slot offsets (int32, one an entry of A)."""
    a_rp, a_col, a_val, _, b_rp, b_col, b_val = args
    return _nbytes(a_rp, a_col, a_val, b_rp, b_col, b_val) + 4 * len(a_col)


def network_cases(dev, m=HEADLINE_ROWS):
    """The register network's phase-3 cases (K1-K3, K4t, K5, K7a, K7b,
    K8, K9), one at a time, so that the float64 rows of one shape are
    freed before the next is built: K1 on the headline's classes
    (pregathered, run 8) and the skew matrix's, K2 on their 1024 classes
    (the pregathered g; the table), K4t on the skew matrix's classes
    above TRANSPOSED_MAX_WIDTH and on the cant replica's (the tiled
    route's plan: 9 x 9 x 257 nodes at the headline's m, 9 x 9 x 8 below
    it); K2, K7a and K7b (in place and compacted)
    on the headline's flat plan (width 1024, run 32, the table:
    spgemm_auto's bitonic pick and the serve lane); K8 and K9 on the
    headline's slab plan (the slab and compensated routes); K5 on the
    float64 headline's and the skew x band float64 chunked classes up to
    FUSED_MAX_WIDTH; K3 on the rows that K2 sorts for those 1024 classes
    and the flat plan, that K8 sorts on the headline's slab plan, and
    that K6 sorts for the float64 headline's and the skew x band float64
    chunked 1024 classes and on the float64 headline's and the float32
    wide x band flat plans. ``m`` is the headline's rows (a smaller m
    rehearses the cases on the CPU)."""
    from ia_spgemm_tpu_torch.bench import headline
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import esc, slab
    from ia_spgemm_tpu_torch.ops import slab_kernels as SK

    def ell(a, dtype=np.float32):
        return convert.csr_to_ell(CSR.from_scipy(a.astype(dtype),
                                                 device=dev),
                                  check_guard=False)

    a64 = headline.build_matrix(m=m)
    H = ell(a64)
    yield from _ragged_cases(bt.multiclass_planned(
        H, H, assemble="bcsr", pregather=True, run_override=8), "headline")
    yield from _flat_cases("headline flat", H)
    del H
    skew = headline.build_skew_matrix()
    S = ell(skew)
    yield from _ragged_cases(bt.multiclass_planned(S, S, assemble="bcsr"),
                             "skew")
    del S
    C = CSR.from_scipy(
        cant_matrix((9, 9, max(8, 257 * m // HEADLINE_ROWS))), device=dev)
    yield from _ragged_cases(esc.plan_csr_tiled(C, C), "cant")
    del C
    A = CSR.from_scipy(a64.astype(np.float32), device=dev)
    p = slab.plan_slab_csr(A, A).plan
    ops, kw = slab_operands(p)
    shape = f"headline slabs={p.n_slabs} width={p.width} run={p.run}"
    read = table_read_bytes(*ops[:2], p.run, *ops[2:])
    for name, fn, plain in (
            ("K8", SK.expand_sort_lr, SK.expand_sort_lr_plain),
            ("K9", SK.expand_sort_lr_dd, SK.expand_sort_lr_dd_plain)):
        yield Case(name, "headline slabs",
                   shape + (" float64" if name == "K9" else ""),
                   partial(fn, *ops, **kw), partial(plain, *ops, **kw), read)
    key, val = SK.expand_sort_lr(*ops, **kw)
    yield _k3_case("headline slabs", shape, key, val, p.width, p.width)
    del A, p, ops, key, val
    H64 = ell(a64, np.float64)
    for source, X, Y in (
            ("headline f64", H64, H64),
            ("skew x band f64", ell(skew, np.float64),
             ell(headline.build_matrix(m=skew.shape[0], band=3,
                                       extra_per_row=0), np.float64))):
        call = bt.multiclass_planned(X, Y, assemble="bcsr")
        for i, w in enumerate(call.widths):
            key, val = chunked_class_rows(call, i)
            yield from _cols_cases(f"{source} run={call.run}", key, val,
                                   width=w, start_kk=2 * call.run,
                                   out_w=min(call.out_w, w))
            del key, val
        del call, X, Y
    for source, X, Y in (
            ("headline f64 flat", H64, H64),
            ("wide x band f32 flat",
             ell(headline.build_matrix(m=m, extra_per_row=60)),
             ell(headline.build_matrix(m=m, band=3, extra_per_row=0)))):
        plan, key, val = flat_rows(X, Y)
        del X, Y
        yield from _cols_cases(f"{source} run={plan.run}", key, val,
                               width=plan.width, start_kk=2 * plan.run,
                               out_w=plan.width)
        del key, val
    del H64


def check_case(c, got, want) -> float:
    """A network case's output against its plain version's: K1, K3, K5
    and K7b structure exact and values within 1e-5 (float32) / 1e-12
    (float64) of max(1, max|C|); K2, K8 and K9 (the sorted row) sorted
    keys exactly and their run sums within the same; K7a's sorted packed
    keys bit for bit. Returns the largest value error."""
    if c.kernel == "K7a":
        import torch
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("K7a sorted packed keys differ from the "
                                 "plain version")
        return 0.0
    dtype = str(want[1].dtype)[6:]
    if c.kernel in SORTED_CASES:
        return _check_sorted(got, want, want[0].shape[1], dtype, c.kernel)
    return _check_k4(got, want, dtype, c.kernel)


def _measure_network(dev) -> dict:
    """Each network case against its plain version, then its call ms,
    host us and kernel us, its bytes bound, and its library call's ms."""
    from ia_spgemm_tpu_torch.bench.harness import time_ms
    out = {"K1": [], "K2": [], "K3": [], "K4t": [], "K5": [], "K7a": [],
           "K7b": [], "K8": [], "K9": []}
    for c in network_cases(dev):
        got, want = c.call(), c.plain()
        err = check_case(c, got, want)
        bound_ms = (c.read_bytes + _nbytes(*got)) / PEAK_BYTES_PER_S * 1e3
        del got, want
        out[c.kernel].append({
            "shape": c.shape, "max_abs_err": err,
            "call_ms": time_ms(c.call, dev, 2, 20),
            "call_host_us": host_us(c.call),
            "kernel_us": kernel_us(c.call, PROFILE_NAMES[c.kernel]),
            "bound_ms": bound_ms,
            "library_ms": (time_ms(c.library, dev, 2, 20)
                           if c.library is not None else None)})
        print(json.dumps({c.kernel: out[c.kernel][-1]}), file=sys.stderr,
              flush=True)
    return out


def measure(dev) -> dict:
    import torch

    from ia_spgemm_tpu_torch.bench.harness import time_ms
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    from ia_spgemm_tpu_torch.parallel import rdma_ring as RR

    out = {**_measure_network(dev), "K4": [], "K6": [], "K11": [],
           "K13": []}
    for label, m, width, start_kk, dtype in K4_SHAPES:
        key, val = (t.to(dev) for t in k4_rows(m, width, start_kk, dtype))
        call = lambda: K.sort_compress_rows(  # noqa: E731
            key, val, width=width, start_kk=start_kk)
        err = _check_k4(call(), K.sort_compress_rows_plain(
            key, val, width=width, start_kk=start_kk), dtype)
        sort = lambda: torch.sort(key, dim=1, stable=True)  # noqa: E731
        out["K4"].append({
            "shape": f"{label} {m} x {width} {dtype} start_kk={start_kk}",
            "max_abs_err": err, "call_ms": time_ms(call, dev, 2, 20),
            "call_host_us": host_us(call),
            "kernel_us": kernel_us(call, "k4_sort_compress_rows"),
            "torch_sort_ms": time_ms(sort, dev, 2, 20),
            "torch_sort_host_us": host_us(sort)})
        print(json.dumps(out["K4"][-1]), file=sys.stderr, flush=True)
    for label, m, width, start_kk, dtype in K6_SHAPES:
        key, val = (t.to(dev) for t in k4_rows(m, width, start_kk, dtype))
        call = lambda: K.sort_only(  # noqa: E731
            key, val, width=width, start_kk=start_kk)
        err = _check_sorted(call(), K.sort_only_plain(
            key, val, width=width, start_kk=start_kk), width, dtype)
        out["K6"].append({
            "shape": f"{label} {m} x {width} {dtype} start_kk={start_kk}",
            "max_abs_err": err, **_timings(
                call, lambda: torch.sort(key, dim=1, stable=True),
                "k6_sort_rows", dev)})
        print(json.dumps(out["K6"][-1]), file=sys.stderr, flush=True)
        del key, val
    out["K11"].append(_measure_k11(dev))
    print(json.dumps(out["K11"][-1]), file=sys.stderr, flush=True)
    out["K13"] = measure_k13(dev)
    return out


def measure_k13(dev) -> list:
    """K13 at the headline's B block shapes (K13_SHARDS), as a public
    call and as the ring calls it, beside two torch.rolls; with the
    host's microseconds split by ``k13_host_split``."""
    import torch

    from ia_spgemm_tpu_torch.bench.harness import time_ms
    from ia_spgemm_tpu_torch.parallel import rdma_ring as RR

    out = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for D in K13_SHARDS:
        rows = HEADLINE_ROWS // D
        cols = [torch.randint(-1, HEADLINE_ROWS, (rows, HEADLINE_KB),
                              generator=gen, device=dev, dtype=torch.int32)
                for _ in range(D)]
        vals = [torch.randn((rows, HEADLINE_KB), generator=gen, device=dev)
                for _ in range(D)]
        sets = [RR.alloc_receivers(cols, vals) for _ in range(2)]
        first = RR.ring_hop_rdma(cols, vals, out=sets[0])
        want = RR.ring_hop_plain(*first)
        got = RR.ring_hop_rdma(*first, out=sets[1])
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for ga, wa in zip(got, want)
                   for g, w in zip(ga, wa)):
            raise AssertionError(f"K13 D={D} differs from the plain hop")
        stk = [torch.stack(x) for x in (cols, vals)]
        public = lambda: RR.ring_hop_rdma(cols, vals)  # noqa: E731
        ring = lambda: RR.ring_hop_rdma(*first, out=sets[1])  # noqa: E731
        roll = lambda: [torch.roll(x, -1, 0) for x in stk]  # noqa: E731
        out.append({
            "shape": f"D={D} x ({rows}, {HEADLINE_KB}) int32 + float32",
            "call_ms": time_ms(public, dev, 2, 20),
            "call_host_us": host_us(public),
            "ring_call_ms": time_ms(ring, dev, 2, 20),
            "ring_call_host_us": host_us(ring),
            "kernel_us": kernel_us(ring, "k13_ring_hop"),
            "torch_roll_ms": time_ms(roll, dev, 2, 20),
            "torch_roll_host_us": host_us(roll),
            "host_split_us": k13_host_split((cols, vals))})
        print(json.dumps(out[-1]), file=sys.stderr, flush=True)
    return out


def k13_host_split(arrays, calls: int = 200) -> dict:
    """Host microseconds per call (``host_us``) of the parts of a public
    K13 call (``ring_hop_rdma`` without out=) on these blocks: the
    layout's lookup, the fresh receivers' allocation, the hop into
    receivers made once (the ring's call: the table's pointers, the
    launch), and the whole public call."""
    from ia_spgemm_tpu_torch.parallel import rdma_ring as RR
    hit = RR._layout(arrays, None)
    sets = [RR.alloc_receivers(*arrays) for _ in range(2)]
    first = RR.ring_hop_rdma(*arrays, out=sets[0])
    return {"layout_us": host_us(lambda: RR._layout(arrays, None), calls),
            "alloc_us": host_us(lambda: RR._alloc(hit), calls),
            "into_receivers_us": host_us(
                lambda: RR.ring_hop_rdma(*first, out=sets[1]), calls),
            "public_us": host_us(lambda: RR.ring_hop_rdma(*arrays), calls)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)
    # the tuned fused width must be set before ops.bitonic is imported
    from ia_spgemm_tpu_torch.bench import headline
    headline.apply_bench_tuning()
    import torch
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    res = {"card": card, **measure(torch.device("cuda", 0))}
    line = json.dumps(res)
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
