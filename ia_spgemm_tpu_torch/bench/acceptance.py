"""Acceptance run of the port (PyTorch port of ``scripts/acceptance.py``):
every SpGEMM route on the headline matrix read against the card's
roofline, the width-class routes and the ESC fallback on a row-skewed
matrix against scipy, the cost-model router on that matrix, dense_row on
its SpMM-shaped workload, and the reference's fixture matrices through
the full harness.

    python -m ia_spgemm_tpu_torch.bench.acceptance [--rooflines-only]
        [--inputs DIR] [--rooflines-out PATH] [--sweeps-out PATH]
        [--smoke] [--device cuda|cpu] [--chip h100_sxm|h100_pcie]

It runs on the card unless ``--device cpu`` is named, and raises without
one. The roofline reads the card's peaks from its name
(``roofline.detect_chip``); a CPU rehearsal names the peaks it reads its
host times against with ``--chip`` (such shares are not the card's).
Output lands only at the paths given. ``--smoke`` (or
``IA_SPGEMM_BENCH_SMOKE=1``) cuts the headline to m=256 and the skew
matrix to m=512 with heavy rows of 64. The width-class routes take
``IA_SPGEMM_FUSED_MAX_WIDTH`` from the environment (default 256).

What each time is, on the card:

- ``time_ms`` / ``wall_ms``: the median over calls of CUDA-event ms
  around one call (``profiling.time_op``): the device span of that call,
  host gaps inside it included, plan excluded;
- ``device_ms``: ms per call of a chain of calls between two CUDA events
  (``profiling.device_time_ms``);
- ``pipelined_wall_ms``: host ms per call of 8 calls and one
  synchronisation; ``single_wall_ms``: one synchronised call's host ms;
- ``scipy_ms`` / ``scipy_csr_at_dense_ms``: scipy on the host, the
  median of 3.

On the CPU every time is the host's. Each route's C is held once, before
it is timed, to scipy's float64 product: the pattern of nonzero entries
exact, values within 1e-4 of max(1, max|C|) (compensated: 1e-12), the
checksum within 1e-4; a route that fails raises. Each roofline entry's
cost model is the JAX package's (``costs=`` returns them).

Two departures from the JAX script: ``multiclass_skew_ell`` (the ELL
assembly on the skew matrix, a loser the port does not carry) is left
out, and ``vs_global_sort`` divides the global sort's time by the tiled
route's, as its name says (the script divides the slab engine's time
whenever slab is viable).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import scipy.sparse as sp

from ia_spgemm_tpu_torch.bench import roofline
from ia_spgemm_tpu_torch.bench.headline import build_matrix

# the fixture sweep's menu beyond the reference's (harness.ALGORITHMS)
SWEEP_EXTRA = ("bitonic", "compensated", "dense")
ORACLE_TOL = 1e-4   # float32 routes against scipy's float64 product
DD_TOL = 1e-12      # compensated hi + lo against it
N_DENSE = 2048      # columns of dense_row's B (an SpMM-shaped C)
CHIPS = {c.name: c for c in (roofline.H100_SXM, roofline.H100_PCIE)}


def skew_matrix(smoke: bool = False) -> sp.csr_matrix:
    """The JAX script's heavy-skew workload, float32: 0.2% of the rows
    hold 400 entries (smoke: 64), the rest 8-23 (smoke: 2-5), columns
    uniform; m = 32768 (smoke: 512). The flat bitonic plan is not viable
    on it at full size."""
    rng = np.random.default_rng(3)
    m = 512 if smoke else 32768
    lens = np.where(rng.random(m) < 0.002, 64 if smoke else 400,
                    rng.integers(2, 6, m) if smoke
                    else rng.integers(8, 24, m))
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.shape[0])
    a = sp.coo_matrix(
        (rng.standard_normal(rows.shape[0]).astype(np.float32),
         (rows, cols)), shape=(m, m)).tocsr()
    a.sum_duplicates()
    return a


def _oracle(a: sp.csr_matrix, b) -> sp.csr_matrix:
    """scipy's float64 a @ b, nonzero entries only, sorted."""
    c = (a.astype(np.float64) @ b.astype(np.float64)).tocsr()
    c.sum_duplicates()
    c.eliminate_zeros()
    return c


def hold(key: str, C, want, tol: float = ORACLE_TOL) -> float:
    """C (any result type of the port) against scipy's float64 product
    `want` (sparse; a dense ndarray for a Dense C): the pattern of
    nonzero entries exact, values within tol * max(1, max|C|), the
    checksum within ORACLE_TOL. Returns max |dval|; raises otherwise."""
    if isinstance(want, np.ndarray):
        d = C.values.double().cpu().numpy() - want
        err = float(np.abs(d).max(initial=0.0))
        scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    else:
        got = C.to_scipy().tocsr().astype(np.float64)
        got.sum_duplicates()
        got.eliminate_zeros()
        if not (got.shape == want.shape
                and np.array_equal(got.indptr, want.indptr)
                and np.array_equal(got.indices, want.indices)):
            raise AssertionError(f"{key}: pattern differs from scipy's "
                                 f"(nnz {got.nnz} vs {want.nnz})")
        err = float(np.abs(got.data - want.data).max(initial=0.0))
        scale = max(1.0, float(np.abs(want.data).max(initial=0.0)))
    ref = float(want.sum())
    rel = abs(float(C.checksum()) - ref) / max(1.0, abs(ref))
    if not (err <= tol * scale and rel <= ORACLE_TOL):
        raise AssertionError(f"{key}: max |dval| {err} (tol {tol} * "
                             f"{scale}), checksum rel err {rel}")
    return err


def _cost(costs, key, model, cost, **extra):
    if costs is not None:
        costs[key] = {"model": model, "flops": cost.flops,
                      "bytes": cost.bytes, **extra}
    return cost


def shares_above(out: Dict, costs: Dict, chip: roofline.ChipSpec,
                 limit: float = 105.0) -> Dict[str, float]:
    """{key: share %} of each roofline entry whose time beats `limit`
    percent of its least time: the entry's cost model, or its
    ``least_bytes`` where the JAX count is no lower bound on the card
    (dense_row's). A share above 100% is a count at fault or a wrong
    timer."""
    bad = {}
    for key, c in costs.items():
        least = roofline.KernelCost(c["flops"],
                                    c.get("least_bytes", c["bytes"]))
        for name, entry in ((key, out[key]),
                            (f"{key}.roofline_device",
                             out[key].get("roofline_device"))):
            if entry and "time_ms" in entry:
                pct = roofline.analyze(entry["time_ms"], least,
                                       chip)["pct_of_sol"]
                if pct > limit:
                    bad[name] = pct
    return bad


def headline_rooflines(device, *, chip: Optional[roofline.ChipSpec] = None,
                       smoke: bool = False,
                       costs: Optional[Dict] = None) -> Dict:
    """The JAX script's headline roofline table (its keys, in its order,
    but ``multiclass_skew_ell``), each entry from the port's counterpart
    of the JAX call, on `device` (the card unless "cpu"; raises without
    one). chip: the peaks (default the card's, ``detect_chip``; the CPU
    needs one named). costs, when given, gets {key: {"model", "flops",
    "bytes"}} of every roofline entry (dense_row's also "least_bytes":
    A, B and C once each)."""
    import torch

    from ia_spgemm_tpu_torch.bench import profiling
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR, Dense, checked_device
    from ia_spgemm_tpu_torch.ops import bitonic, dense_row, dia, esc
    from ia_spgemm_tpu_torch.ops import slab as slab_mod

    dev = checked_device(device)
    if chip is None:
        if dev.type != "cuda":
            raise ValueError("headline_rooflines on the CPU: name the "
                             "peaks (chip=)")
        chip = roofline.detect_chip(dev)

    def analyze(ms, cost):
        return roofline.analyze(ms, cost, chip)

    a = build_matrix(m=256) if smoke else build_matrix()
    a32 = a.astype(np.float32)
    A = CSR.from_scipy(a32, device=dev)
    nnz = int(A.nnz)
    want = _oracle(a32, a32)
    out = {}

    plan = esc.plan_spgemm(A, A)
    C = esc.spgemm_csr(A, A, plan, engine="global")
    hold("esc_csr_global_sort", C, want)
    cost = roofline.cost_esc(plan.expansion_capacity, nnz, nnz, int(C.nnz))
    # the ESC engine as the harness benches it: the slab engine when
    # viable (SlabCSR out), the global sort otherwise
    scall = slab_mod.plan_slab_csr(A, A)
    if scall is not None:
        Cs = scall()
        hold("esc_csr", Cs, want)
        r = profiling.time_op(scall, iters=5)
        dv = profiling.device_time_ms(scall, chain=8)["device_ms"]
        out["esc_csr"] = analyze(r["median_ms"], cost)
        out["esc_csr"]["device_ms"] = dv
        out["esc_csr"]["engine"] = "slab"
        out["esc_csr"]["roofline_device"] = (analyze(dv, cost) if dv > 0
                                             else None)
        _cost(costs, "esc_csr", "cost_esc", cost)
        # the SlabCSR flattened to exact CSR: by gathers (production), and
        # by the scatter form it replaced
        for key, engine in (("esc_csr_to_flat", "gather"),
                            ("esc_csr_to_flat_scatter", "scatter")):
            flat = lambda: slab_mod.slab_to_csr(  # noqa: E731
                Cs, out_cap=scall.plan.out_cap, engine=engine)
            hold(key, flat(), want)
            r = profiling.time_op(flat, iters=3)
            out[key] = analyze(r["median_ms"], cost)
            if engine == "gather":   # the JAX script names this one only
                out[key]["engine"] = engine
            _cost(costs, key, "cost_esc", cost)
    r = profiling.time_op(
        lambda: esc.spgemm_csr(A, A, plan, engine="global"), iters=5)
    out["esc_csr_global_sort"] = analyze(r["median_ms"], cost)
    _cost(costs, "esc_csr_global_sort", "cost_esc", cost)
    if scall is None:
        out["esc_csr"] = dict(out["esc_csr_global_sort"],
                              engine="global_sort")
        _cost(costs, "esc_csr", "cost_esc", cost)

    # the production csr path (the tiled width-class route when viable),
    # planned once as the harness does
    tiled = esc.plan_csr_tiled(A, A)
    if tiled is not None:
        hold("esc_auto_tiled", tiled(), want)
        r = profiling.time_op(tiled, iters=5)
        out["esc_auto_tiled"] = analyze(r["median_ms"], cost)
        out["esc_auto_tiled"]["vs_global_sort"] = round(
            out["esc_csr_global_sort"]["time_ms"] / r["median_ms"], 2)
        _cost(costs, "esc_auto_tiled", "cost_esc", cost)

    A_ell = convert.csr_to_ell(A, check_guard=False)
    bplan = bitonic.plan_bitonic(A_ell, A_ell)
    if bplan.viable:
        run = lambda: bitonic.spgemm_bitonic(A_ell, A_ell, bplan)  # noqa
        hold("bitonic", run(), want)
        r = profiling.time_op(run, iters=5)
        cost_b = roofline.cost_bitonic(A.nrows, bplan.width, nnz)
        out["bitonic"] = analyze(r["median_ms"], cost_b)
        _cost(costs, "bitonic", "cost_bitonic", cost_b)

    comp = lambda: esc.spgemm_csr_compensated(A, A)  # noqa: E731
    hold("compensated", comp(), want, tol=DD_TOL)
    r = profiling.time_op(comp, iters=3)
    cost_c = roofline.cost_esc(plan.expansion_capacity, nnz, nnz,
                               int(C.nnz), value_bytes=8)
    out["compensated"] = analyze(r["median_ms"], cost_c)
    dv = profiling.device_time_ms(comp, chain=4)["device_ms"]
    out["compensated"]["device_ms"] = dv
    if dv > 0:
        out["compensated"]["roofline_device"] = analyze(dv, cost_c)
    _cost(costs, "compensated", "cost_esc", cost_c)
    del C

    # dense_row against a dense B of N_DENSE columns (the headline's
    # square dense B would be 4.3 GB): an SpMM-shaped C
    b_dr = np.random.default_rng(0).standard_normal(
        (A.ncols, N_DENSE)).astype(np.float32)
    B_dr = Dense(values=torch.from_numpy(b_dr).to(dev))
    run = lambda: dense_row.spgemm_dense_row(A_ell, B_dr)  # noqa: E731
    hold("dense_row", run(), a32.astype(np.float64) @ b_dr.astype(
        np.float64))
    r = profiling.time_op(run, iters=5)
    ka = A_ell.col_ind.shape[1]
    cost_d = roofline.cost_dense_row(A.nrows, ka, N_DENSE, nnz)
    out["dense_row"] = analyze(r["median_ms"], cost_d)
    # the JAX count charges 8 rows of B per A entry (a TPU tile's pull);
    # the least the card must move reads A, B and C once each
    _cost(costs, "dense_row", "cost_dense_row", cost_d,
          least_bytes=nnz * 8 + (A.ncols + A.nrows) * N_DENSE * 4)
    del B_dr, b_dr

    nd = len(convert.plan_dia_offsets(A))
    if nd <= 64:   # the headline's random entries occupy ~every diagonal
        Ad = convert.csr_to_dia(A, check_guard=False)
        run = lambda: dia.spgemm_dia(Ad, Ad)  # noqa: E731
        hold("dia", run(), want)
        r = profiling.time_op(run, iters=3)
        cost_dia = roofline.cost_dia(A.nrows, nd, nd, 2 * nd)
        out["dia"] = analyze(r["median_ms"], cost_dia)
        _cost(costs, "dia", "cost_dia", cost_dia)

    # the heavy-skew workload: the flat bitonic plan is not viable, the
    # width-class route keeps each row at its own pow2 width; against
    # scipy (the vendor-baseline role)
    a_skew = skew_matrix(smoke)
    A_skew = CSR.from_scipy(a_skew, device=dev)
    S_ell = convert.csr_to_ell(A_skew, check_guard=False)
    if not smoke and bitonic.plan_bitonic(S_ell, S_ell).viable:
        raise AssertionError("the skew matrix's flat plan is viable")
    want_skew = _oracle(a_skew, a_skew)
    t0 = time.perf_counter()
    call0 = bitonic.multiclass_planned(S_ell, S_ell)
    plan_s = time.perf_counter() - t0
    C_skew = call0()
    hold("multiclass_skew (ell)", C_skew, want_skew)
    c_ref = a_skew @ a_skew
    st = []
    for _ in range(3):
        t0 = time.perf_counter()
        a_skew @ a_skew
        st.append((time.perf_counter() - t0) * 1e3)
    scipy_skew_ms = float(np.median(st))
    ref = float(c_ref.sum())
    rel = abs(float(C_skew.checksum()) - ref) / max(1.0, abs(ref))
    mx = int(C_skew.nnz_row.max())
    ow = 128
    while ow < mx:
        ow *= 2
    del C_skew
    # steady state: planned once, output capped to the observed width;
    # bcsr is the production assembly for skewed outputs
    _, W = bitonic.plan_multiclass(
        S_ell.nnz_row.cpu().numpy(), S_ell.max_nnz_per_row,
        a_col_dev=S_ell.col_ind, b_len_dev=S_ell.nnz_row)
    class_rows = [(int((W == w).sum()), int(w)) for w in np.unique(W)]
    cost_mc = roofline.cost_multiclass(class_rows, int(A_skew.nnz),
                                       int(c_ref.nnz))
    for key, pg in (("multiclass_skew", False), ("multiclass_skew_pg",
                                                 True)):
        call = bitonic.multiclass_planned(S_ell, S_ell, out_width=ow,
                                          assemble="bcsr", pregather=pg)
        hold(key, call(), want_skew)
        r = profiling.time_op(call, iters=3)
        dv = profiling.device_time_ms(call, chain=6)["device_ms"]
        out[key] = {
            "wall_ms": r["median_ms"],
            "device_ms": dv,
            "plan_seconds": round(plan_s, 1),
            "scipy_ms": scipy_skew_ms,
            "speedup_vs_scipy": scipy_skew_ms / r["median_ms"],
            "checksum_rel_err": rel,
            "nnz": int(A_skew.nnz),
            "flat_plan_viable": False,
            "assembly": "bcsr_pg" if pg else "bcsr",
            "roofline_device": analyze(dv, cost_mc) if dv > 0 else None,
        }
        _cost(costs, key, "cost_multiclass", cost_mc)
        del call

    # the ESC fallback on the skew matrix: the slab engine when its width
    # cap admits the heavy rows, else slab for the light rows and the
    # global sort for the heavy ones, else the global sort
    run = slab_mod.plan_slab_csr(A_skew, A_skew)
    engine = "slab"
    if run is None:
        run = slab_mod.plan_slab_hybrid(A_skew, A_skew)
        if run is not None:
            engine = f"slab+global_hybrid({run.n_heavy} heavy rows)"
        else:
            skew_plan = esc.plan_spgemm(A_skew, A_skew)
            run = lambda: esc.spgemm_csr(  # noqa: E731
                A_skew, A_skew, skew_plan, engine="global")
            engine = "global_sort"
    hold("skew_esc_fallback", run(), want_skew)
    r = profiling.time_op(run, iters=3)
    dv = profiling.device_time_ms(run, chain=2)["device_ms"]
    out["skew_esc_fallback"] = {
        "wall_ms": r["median_ms"], "device_ms": dv, "engine": engine,
        "scipy_ms": scipy_skew_ms,
        "speedup_vs_scipy": scipy_skew_ms / r["median_ms"],
    }
    del run

    # the cost-model router (esc.plan_csr_auto) on the skew matrix
    route, call = esc.plan_csr_auto(A_skew, A_skew)
    hold("esc_auto_skew", call(), want_skew)
    dt = profiling.device_time_ms(call, chain=6)
    pipe = profiling.pipelined_wall_ms(call, n=8)["pipelined_wall_ms"]
    out["esc_auto_skew"] = {
        "route": route,
        "device_ms": dt["device_ms"],
        "pipelined_wall_ms": pipe,
        "single_wall_ms": dt["single_ms"],
        "scipy_ms": scipy_skew_ms,
        "speedup_vs_scipy": scipy_skew_ms / pipe,
    }
    del call

    # dense_row's winning workload, C = A_sparse @ B_dense (n = N_DENSE),
    # against scipy's CSR @ dense ndarray
    b_np = np.random.default_rng(1).standard_normal(
        (A.ncols, N_DENSE)).astype(np.float32)
    st = []
    for _ in range(3):
        t0 = time.perf_counter()
        a32 @ b_np
        st.append((time.perf_counter() - t0) * 1e3)
    scipy_spmm_ms = float(np.median(st))
    B2 = Dense(values=torch.from_numpy(b_np).to(dev))
    run = lambda: dense_row.spgemm_dense_row(A_ell, B2)  # noqa: E731
    hold("dense_row_spmm_win", run(), a32.astype(np.float64) @ b_np.astype(
        np.float64))
    r = profiling.time_op(run, iters=5)
    out["dense_row_spmm_win"] = {
        "wall_ms": r["median_ms"],
        "scipy_csr_at_dense_ms": scipy_spmm_ms,
        "speedup_vs_scipy": scipy_spmm_ms / r["median_ms"],
        "n_dense": N_DENSE,
    }
    return out


def fixture_sweeps(inputs_dir: str, device) -> Dict:
    """Every .mtx of `inputs_dir` (``suitesparse.local_collection``,
    sorted by name), read in float32 on `device`, through the harness's
    reference menu and SWEEP_EXTRA with 2 timed runs: A @ A for a square
    A, A @ A^T for a rectangular one. {name: the report's JSON dict plus
    sweep_seconds}, or {name: {"error": ...}} where the reader fails."""
    from ia_spgemm_tpu_torch.bench import harness
    from ia_spgemm_tpu_torch.bench import report as report_mod
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import checked_device
    from ia_spgemm_tpu_torch.io import mmio, suitesparse

    dev = checked_device(device)
    out = {}
    for name, path in sorted(suitesparse.local_collection(
            inputs_dir).items()):
        try:
            A = mmio.read_mtx_to_csr(path, dtype=np.float32, device=dev)
        except Exception as e:  # noqa: BLE001 - record it, sweep on
            out[name] = {"error": str(e)}
            continue
        B = A if A.nrows == A.ncols else convert.transpose_csr(A)
        t0 = time.time()
        rep = harness.run_benchmark(A, B, harness.ALGORITHMS + SWEEP_EXTRA,
                                    matrix_a=name, matrix_b=name, iters=2)
        d = json.loads(report_mod.to_json(rep))
        d["sweep_seconds"] = round(time.time() - t0, 1)
        out[name] = d
        ok = [r["name"] for r in d["results"] if r["ok"]]
        print(f"{name}: winner={d['winner']} ok={ok}", flush=True)
    return out


def _write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from ia_spgemm_tpu_torch.formats.types import checked_device
    from ia_spgemm_tpu_torch.io import suitesparse

    ap = argparse.ArgumentParser(
        prog="python -m ia_spgemm_tpu_torch.bench.acceptance",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--rooflines-only", action="store_true")
    ap.add_argument("--inputs", default=suitesparse.REFERENCE_INPUTS,
                    help="directory of the fixture .mtx files")
    ap.add_argument("--rooflines-out")
    ap.add_argument("--sweeps-out")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--chip", choices=sorted(CHIPS),
                    help="the peaks a CPU rehearsal reads against")
    args = ap.parse_args(argv)
    dev = checked_device(args.device)
    if dev.type == "cpu" and args.chip is None:
        ap.error("--device cpu needs --chip (on the card its name gives "
                 "the peaks)")
    if dev.type == "cuda" and args.chip is not None:
        ap.error("--chip is for CPU rehearsals: the card's name gives its "
                 "peaks")
    chip = CHIPS[args.chip] if args.chip else None
    if not args.rooflines_only:
        sweeps = fixture_sweeps(args.inputs, dev)
        if args.sweeps_out:
            _write_json(args.sweeps_out, sweeps)
    smoke = args.smoke or os.environ.get("IA_SPGEMM_BENCH_SMOKE") == "1"
    roofs = headline_rooflines(dev, chip=chip, smoke=smoke)
    if args.rooflines_out:
        _write_json(args.rooflines_out, roofs)
    print(json.dumps({k: {"time_ms": v.get("time_ms", v.get("wall_ms")),
                          "pct_of_sol": v.get("pct_of_sol")}
                      for k, v in roofs.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
