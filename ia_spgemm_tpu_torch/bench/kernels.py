"""K4, K6, K11 and K13 on the card at the shapes of ``chip_smoke.py``
phase 3, on inputs made from a seed: for each, the wrapper's call time
(CUDA events, median of 20), the host's microseconds per call
(``time.perf_counter`` around unsynchronised calls), the kernel's own
device time per launch (``torch.profiler``), and beside them the PyTorch
call computing the same function (``torch.sort`` of the keys,
``torch.sparse.mm``, two ``torch.roll``s). Every output is checked
against the plain version first (structure exact, values within 1e-5 /
1e-12 of max(1, max|C|); K6's sorted keys exactly and its run sums;
K11 and K13 bit for bit).

    python -m ia_spgemm_tpu_torch.bench.kernels [--json PATH]

Prints one JSON line: the card's name and power limit, then one entry per
shape. K4's and K6's inputs are rows in their input layout (sorted runs
of start_kk / 2 slots, ascending and descending in turn; keys uniform
below 32768, a fifth SENTINEL); K11's A is ``build_matrix(m=16384)`` as
ELL (16384, 29) times itself dense; K13's the headline's B block shapes (32768 / D rows
of 29 int32 columns and 29 float32 values) at D = 4 and 8 shards of one
card, as a public call (fresh receivers) and as the ring calls it (the
previous hop's receivers hopped into the other set).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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


def kernel_us(fn, name: str, calls: int = 20) -> float:
    """Device microseconds per launch of the kernels whose name holds
    `name`, from torch.profiler over `calls` calls of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == DeviceType.CUDA and name in e.name]
    if not durs:
        raise RuntimeError(f"the profiler saw no {name} launch")
    return sum(durs) / len(durs)


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


def _check_k6(got, want, width, dtype):
    """Sorted keys equal; values within a duplicate run may sit in
    another order, so the run sums (the plain compress) are compared."""
    import torch

    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        raise AssertionError("K6 sorted keys differ from the plain version")
    return _check_k4(K.compress_plain(*got, width=width, out_w=width),
                     K.compress_plain(*want, width=width, out_w=width),
                     dtype, "K6")


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


def measure(dev) -> dict:
    import torch

    from ia_spgemm_tpu_torch.bench.harness import time_ms
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    from ia_spgemm_tpu_torch.parallel import rdma_ring as RR

    out = {"K4": [], "K6": [], "K11": [], "K13": []}
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
        err = _check_k6(call(), K.sort_only_plain(
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
        out["K13"].append({
            "shape": f"D={D} x ({rows}, {HEADLINE_KB}) int32 + float32",
            "call_ms": time_ms(public, dev, 2, 20),
            "call_host_us": host_us(public),
            "ring_call_ms": time_ms(ring, dev, 2, 20),
            "ring_call_host_us": host_us(ring),
            "kernel_us": kernel_us(ring, "k13_ring_hop"),
            "torch_roll_ms": time_ms(roll, dev, 2, 20),
            "torch_roll_host_us": host_us(roll)})
        print(json.dumps(out["K13"][-1]), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)
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
