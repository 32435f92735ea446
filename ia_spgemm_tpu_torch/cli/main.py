"""spgemm-run for the PyTorch port.

Usage (the JAX package's CLI, plus --device):

    python -m ia_spgemm_tpu_torch.cli A.mtx [B.mtx] [--mode all|autotune|ALG]
        [--weights Intel|Amd|P100|TPU|path.npz] [--profile cpu|gpu]
        [--imgs-dir DIR] [--no-matnet] [--device cuda|cpu] [--isolate]
        [--iters N] [--json OUT.json] [--testing]
    python -m ia_spgemm_tpu_torch.cli A.mtx [B.mtx] --mode dist|ring
        [--shards D] [--device cuda|cpu] [--iters N] [--json OUT.json]

With one matrix the workload is C = A @ A (reference README.md:10).
MatNet predicts the fastest algorithm first (unless --no-matnet), from
the features and density images of A and B. ``--mode all`` (the default)
then runs the whole menu beside the scipy baseline and prints the winner
and MatNet's verdict; ``--mode autotune`` runs only the predicted
algorithm (``autotune.spgemm_auto``); ``--mode ALG`` runs one of
baseline, csr (the production auto route), esc, coo, ell, dia, dense,
bitonic, dense_row, compensated, hash, serve (the bf16 lane, checksum
held to its 2e-2 bound). ``--profile gpu`` is the reference GPU
program: P100 weights, B = A^T when no B is given, 20x size guards, the
(coo, csr, bitonic) menu. ``--imgs-dir`` writes the density images
img1.txt / img2.txt. ``--isolate`` runs every row but the baseline in
its own process on ``--device``, killed at the row's watchdog budget
(bench/isolated.py): a CUDA kernel cannot be cancelled in process, so
this is the watchdog that frees the card. ``--mode dist`` and ``--mode
ring`` run C = A @ B row-sharded over ``--shards`` shards of the mesh
(``parallel/``): dist all-gathers B's row blocks, ring streams them
between neighbours (K13 on the card). The mesh counts every visible
device IA_SPGEMM_SHARDS_PER_DEVICE times (default 1), so
``IA_SPGEMM_SHARDS_PER_DEVICE=4 ... --shards 4`` runs four shards on one
card; more shards than that exit 2. With IA_SPGEMM_COORDINATOR set, the
process joins a multi-process group first (``parallel/multihost``).

Matrices are read as float32, the type the CLI runs; the float64 routes
(the bitonic row's flat and width-class routes, K3-K6 in float64) are
reached through the API and ``bench.harness.run_benchmark``. ``--device
cuda`` (the default) refuses to run without a GPU; ``--device cpu`` runs
the kernels' plain PyTorch versions. Unlike the JAX CLI, a failed or
mismatching row fails the run (exit code 3); a row its guard skips does
not.
"""

from __future__ import annotations

import argparse
import os
import sys

DIST_MODES = ("dist", "ring")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spgemm-run",
        description="input-aware SpGEMM, PyTorch/CUDA port "
                    "(ia_spgemm_tpu_torch)")
    p.add_argument("matrix_a", help=".mtx file for A")
    p.add_argument("matrix_b", nargs="?", default=None,
                   help=".mtx file for B (default: B = A)")
    p.add_argument("testing_mode", nargs="?", default=None,
                   help="reference-CLI compat: nonzero third positional "
                        "arg == --testing")
    p.add_argument("--mode", default="all",
                   help="all (every algorithm + MatNet verdict) | autotune "
                        "(the predicted algorithm only) | baseline|csr|esc|"
                        "coo|ell|dia|dense|bitonic|dense_row|compensated|"
                        "hash|serve, each beside the scipy baseline | "
                        "dist|ring (row-sharded over the mesh: all-gathered"
                        " B / the ring; see --shards)")
    p.add_argument("--shards", type=int, default=None,
                   help="mesh size for --mode dist/ring (default: every "
                        "visible shard, IA_SPGEMM_SHARDS_PER_DEVICE per "
                        "device)")
    p.add_argument("--weights", default="Intel",
                   help="MatNet weight set: Intel|Amd|P100 (reference "
                        "sets), TPU (retrained on TPU winners) or a "
                        "path.npz")
    p.add_argument("--profile", default="cpu", choices=("cpu", "gpu"),
                   help="composed reference profile: cpu = the CPU program "
                        "(Intel weights, 50x size guards, 5-class menu); "
                        "gpu = the GPU program (P100 weights, B = A^T when "
                        "no B is given, 20x size guards, coo/csr/bitonic)")
    p.add_argument("--testing", action="store_true",
                   help="print input matrices (reference testing_mode)")
    p.add_argument("--json", default=None, help="write JSON report here")
    p.add_argument("--imgs-dir", default=None,
                   help="write img1.txt / img2.txt density images here "
                        "(reference main.cpp:567-643)")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--no-matnet", action="store_true",
                   help="skip the MatNet prediction")
    p.add_argument("--transpose-b", action="store_true",
                   help="use B = A^T (the reference GPU program's workload)")
    p.add_argument("--isolate", action="store_true",
                   help="run each row in its own process, killed at the "
                        "watchdog budget (frees the card)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the kernels run (default cuda)")
    return p


def _print_csr(name, A):
    import numpy as np
    nnz = int(A.nnz)
    print(f"{name}: row:{A.nrows} col:{A.ncols} nnz:{nnz}")
    print(",".join(map(str, A.row_ptr.cpu().numpy())) + ",")
    print(",".join(map(str, A.col_ind[:nnz].cpu().numpy())) + ",")
    print(",".join(f"{v:.2f}" for v in
                   np.asarray(A.values[:nnz].cpu().numpy())) + ",")


def _refuse(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 2


def _run_distributed(A, B, args, device) -> int:
    """--mode dist/ring: C = A @ B row-sharded over a 1-D shard mesh, the
    scale-out the single-process reference lacks (SURVEY.md §2.7). dist
    all-gathers B's row blocks; ring streams them between neighbours.
    Median device ms per call from CUDA events on the card, host ms on
    the CPU. Exit 2 for more shards than the mesh has, 3 for a checksum
    off scipy's by 1e-4 or more."""
    from ia_spgemm_tpu_torch.bench.harness import time_ms
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.parallel import distributed, multihost, ring
    from ia_spgemm_tpu_torch.parallel.mesh import make_mesh, visible_devices

    if os.environ.get("IA_SPGEMM_COORDINATOR"):
        multihost.initialize()
    ndev = len(visible_devices(device.type))
    D = args.shards or ndev
    if not 1 <= D <= ndev:
        return _refuse(f"--shards {D} > {ndev} visible shard(s) (set "
                       "IA_SPGEMM_SHARDS_PER_DEVICE for more per device)")
    mesh = make_mesh(D, device_type=device.type)
    print(f"mesh: {mesh.num_shards} shard(s) on "
          f"{sorted({str(d) for d in mesh.devices})}, route={args.mode}, "
          "balance=flops")

    if args.mode == "dist":
        e_cap, out_cap = distributed.plan_dist_spgemm(A, B, D,
                                                      balance="flops")
        As = distributed.partition_rows(A, D, balance="flops", B=B,
                                        mesh=mesh)
        Bs = distributed.partition_rows(B, D, mesh=mesh)

        def run():
            return distributed.dist_spgemm(As, Bs, mesh, e_cap=e_cap,
                                           out_cap=out_cap)

        C = multihost.replicate_to_hosts(run())
    else:
        A_ell = convert.csr_to_ell(A, check_guard=False)
        B_ell = convert.csr_to_ell(B, check_guard=False)
        plan = ring.plan_ring(A_ell, B_ell, D)
        As = ring.partition_rows_ell(A_ell, D, mesh=mesh)
        Bs = ring.partition_rows_ell(B_ell, D, mesh=mesh)

        def run():
            return ring.ring_spgemm(As, Bs, mesh, plan)

        C = convert.ell_to_csr(ring.gather_result_ell(run()))

    wall = time_ms(run, device, 0, max(args.iters, 1))

    c_ref = A.to_scipy() @ B.to_scipy()
    ref = float(c_ref.sum())
    rel = abs(float(C.checksum()) - ref) / max(1.0, abs(ref))
    status = "ok" if rel < 1e-4 else f"CHECKSUM MISMATCH ({rel:.3g})"
    print(f"C: {C.nrows}x{C.ncols} nnz={int(C.nnz)} "
          f"verified_sum={float(C.checksum()):.10g} [{status}]")
    print(f"run_time(ms): {wall:.3f}  ({D}-shard {args.mode})")
    if args.json:
        import json as _json
        with open(args.json, "w") as f:
            _json.dump({"mode": args.mode, "shards": D,
                        "run_time_ms": wall, "nnz_out": int(C.nnz),
                        "checksum_rel_err": rel}, f, indent=1)
    return 0 if rel < 1e-4 else 3


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.testing_mode is not None and args.testing_mode not in ("0", ""):
        args.testing = True
    if args.shards is not None and args.mode not in DIST_MODES:
        return _refuse("--shards applies only to --mode dist and ring")
    if args.isolate and args.mode in DIST_MODES:
        return _refuse(f"--isolate does not apply to --mode {args.mode}")

    import numpy as np
    import torch

    from ia_spgemm_tpu_torch import autotune, config as cfg
    from ia_spgemm_tpu_torch.bench import harness, report as report_mod
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.io import mmio
    from ia_spgemm_tpu_torch.ops import density

    if args.device == "cuda" and not torch.cuda.is_available():
        return _refuse("--device cuda: no CUDA GPU is available "
                       "(use --device cpu for the plain versions)")
    device = torch.device(args.device)
    run_config = cfg.DEFAULT_CONFIG
    if args.profile == "gpu":
        # the reference GPU program (main.cu:30-557): P100 weights, B =
        # A^T, 20x size guards, the CUSP/cuSPARSE/NSPARSE menu
        run_config = cfg.SpGEMMConfig(
            size_guard_ratio=cfg.SIZE_GUARD_RATIO_GPU)
        if args.weights == "Intel":      # the CPU default was not asked for
            args.weights = "P100"
        if args.matrix_b is None:
            args.transpose_b = True

    try:
        A = mmio.read_mtx_to_csr(args.matrix_a, dtype=np.float32,
                                 device=device)
        B = A if not args.matrix_b else mmio.read_mtx_to_csr(
            args.matrix_b, dtype=np.float32, device=device)
    except (OSError, mmio.MatrixMarketError) as e:
        print(f"cannot read input: {e}", file=sys.stderr)
        return 1
    print(f"-------------- {args.matrix_a}, "
          f"{args.matrix_b or args.matrix_a} --------------")
    print(f"Weight Matrix (A): {A.nrows}x{A.ncols} nnz={int(A.nnz)}")
    if args.transpose_b:
        B = convert.transpose_csr(B)
    print(f"Activation Matrix (B): {B.nrows}x{B.ncols} nnz={int(B.nnz)}")
    if A.ncols != B.nrows:
        print(f"shape mismatch: {A.shape} @ {B.shape}", file=sys.stderr)
        return 2
    if args.testing:
        from ia_spgemm_tpu_torch.formats.types import CSR
        _print_csr("A_csr", A)
        _print_csr("B_csr", B)
        c_sp = (A.to_scipy() @ B.to_scipy()).tocsr()
        c_sp.sum_duplicates()
        _print_csr("C_csr", CSR.from_scipy(c_sp, device=device))

    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu (plain versions)")
    print(f"device: {device_name}")
    if args.imgs_dir:
        os.makedirs(args.imgs_dir, exist_ok=True)
        for fname, M in (("img1.txt", A), ("img2.txt", B)):
            density.write_density_image(os.path.join(args.imgs_dir, fname),
                                        density.density_image(M))

    pick = None
    if not args.no_matnet:
        try:
            sel = autotune.select_algorithm(A, B, weight_name=args.weights)
            pick = sel.algorithm
            print(f"MatNet prediction: class {sel.class_index} -> {pick}")
        except FileNotFoundError:
            print("MatNet weights not found; skipping prediction")

    if args.mode in DIST_MODES:
        return _run_distributed(A, B, args, device)

    if args.mode == "autotune":
        C, sel = autotune.spgemm_auto(A, B, weight_name=args.weights)
        print(f"ran algorithm: {sel.algorithm}")
        print(f"C: {C.nrows}x{C.ncols} nnz={int(C.nnz)} "
              f"verified_sum={float(C.checksum()):.10g}")
        return 0

    if args.mode != "all":
        algorithms = ("baseline", args.mode)
    elif args.profile == "gpu":
        algorithms = ("baseline",) + autotune.GPU_CLASS_TO_ALGORITHM
    else:
        algorithms = harness.PORTED_ALGORITHMS
    rep = harness.run_benchmark(
        A, B, algorithms,
        matrix_a=args.matrix_a, matrix_b=args.matrix_b or args.matrix_a,
        config=run_config, matnet_pick=pick, iters=args.iters,
        isolate=args.isolate, isolate_device=args.device)
    print(report_mod.format_table(rep))
    if args.json:
        with open(args.json, "w") as f:
            f.write(report_mod.to_json(rep))
    # unlike the JAX CLI, a failed or mismatching row fails the run
    failed = [r.name for r in rep.results
              if r.error or not (r.ok or r.skipped)]
    return 3 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
