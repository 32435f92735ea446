"""spgemm-run for the PyTorch port.

Usage (the JAX package's CLI flags, plus --device):

    python -m ia_spgemm_tpu_torch.cli A.mtx [B.mtx] \\
        --mode bitonic|csr|esc|compensated --no-matnet \\
        [--device cuda|cpu] [--iters N] [--json OUT.json]

With one matrix the workload is C = A @ A (reference README.md:10). The
ported modes run beside the scipy baseline row: ``bitonic`` (flat or
width-class bitonic route), ``csr`` (the production auto route),
``esc`` (slab / hybrid / global ESC) and ``compensated`` (float64-grade
sums). Every other mode, and the MatNet prediction, exit non-zero saying
so. Matrices are read as float32, the type the kernels take. ``--device
cuda`` (the default) refuses to run without a GPU; ``--device cpu`` runs
the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys

PORTED_MODES = ("bitonic", "csr", "esc", "compensated")


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
                   help="ported: bitonic | csr (auto route) | esc | "
                        "compensated, each beside the scipy baseline")
    p.add_argument("--shards", type=int, default=None,
                   help="mesh size for --mode dist/ring (not ported)")
    p.add_argument("--weights", default="Intel",
                   help="MatNet weight set (MatNet is not ported)")
    p.add_argument("--profile", default="cpu", choices=("cpu", "gpu"),
                   help="composed reference profile: gpu = B = A^T when no "
                        "B is given (its size guards and menu are not "
                        "ported)")
    p.add_argument("--testing", action="store_true",
                   help="print input matrices (reference testing_mode)")
    p.add_argument("--json", default=None, help="write JSON report here")
    p.add_argument("--imgs-dir", default=None,
                   help="density images (not ported)")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--no-matnet", action="store_true",
                   help="skip the MatNet prediction (required: MatNet is "
                        "not ported)")
    p.add_argument("--transpose-b", action="store_true",
                   help="use B = A^T (the reference GPU program's workload)")
    p.add_argument("--isolate", action="store_true",
                   help="subprocess watchdog (not ported)")
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.testing_mode is not None and args.testing_mode not in ("0", ""):
        args.testing = True
    if args.mode not in PORTED_MODES:
        return _refuse(f"--mode {args.mode} is not ported yet (ported: "
                       f"{', '.join(PORTED_MODES)})")
    if not args.no_matnet:
        return _refuse("MatNet is not ported yet: pass --no-matnet")
    for flag, given in (("--imgs-dir", args.imgs_dir),
                        ("--isolate", args.isolate),
                        ("--shards", args.shards)):
        if given:
            return _refuse(f"{flag} is not ported yet")

    import numpy as np
    import torch

    from ia_spgemm_tpu_torch.bench import harness, report as report_mod
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.io import mmio

    if args.device == "cuda" and not torch.cuda.is_available():
        return _refuse("--device cuda: no CUDA GPU is available "
                       "(use --device cpu for the plain versions)")
    device = torch.device(args.device)
    if args.profile == "gpu" and args.matrix_b is None:
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
        _print_csr("C_csr", CSR.from_scipy(c_sp))

    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu (plain versions)")
    print(f"device: {device_name}")
    rep = harness.run_benchmark(
        A, B, ("baseline", args.mode),
        matrix_a=args.matrix_a, matrix_b=args.matrix_b or args.matrix_a,
        iters=args.iters)
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
