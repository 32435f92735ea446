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
   inputs the main paths give them: first K1-K3, K5, K7a, K7b, K8 and K9
   at every case of ia_spgemm_tpu_torch.bench.kernels.network_cases (the
   one definition of the register network's shapes, which
   bench/kernels.py measures too: K1 on the headline's and the skew
   matrix's classes, K2 on their 1024 classes (from the headline's
   pregathered g, and from the B table through the skew class's
   fragment index) and on the headline's flat plan (width 1024, run 32,
   from the table), K8 and K9 on the headline's slab plan, sorted keys
   exactly and run sums within tolerance; K7a on the flat plan, sorted
   packed keys bit-identical, and K7b on K7a's sorted keys, in place and
   compacted; K5 on the float64 headline's and the skew x band's chunked
   classes up to FUSED_MAX_WIDTH; K3 on the rows that K2, K8 and K6 sort
   for the inputs named next); then K4 on the skew matrix's wide
   classes, K10 on K9's sorted slabs, K11 on build_matrix(m=16384) (A as
   ELL times dense B, 16384 x 16384; bit for bit, and its float64
   instance bit for bit on build_matrix(m=4096)), K12 on the headline
   ELL pair (Ka = Kb = 29, H = 2048; each row's slots compared sorted by
   column); K6 (float64) on the float64 headline's chunked 1024 class,
   K6 and K4 (float64) on the skew x band's wider classes, K6 on the flat
   float64 headline (width 1024, run 32) and on the float32 wide x band
   flat plan (width 1024, run 8), and K5 at width 1024 beside K6 + K3 on
   those two; K13 on the headline's B blocks at D = 4 and 8 shards (bit
   for bit, the library yardstick a torch.roll of each stacked array
   along the shard axis) and K4 on one shard's products of the D = 4
   ring (8192 x 1024, run 32). Structure exact, float32 values within
   1e-5 * max(1, max|C|) (duplicates are summed in another order),
   float64 values and compensated hi + lo within 1e-12 * max(1,
   max|C|), K13 bit for bit; median ms of each over CUDA events, beside
   the plain version's, one PyTorch call computing the same function
   where there is one (torch.sort of the keys for K4-K6,
   torch.sparse.mm for K11, K1 and K12, torch.roll for K13), and the
   bound (what the kernel must read, once, and its outputs written once
   at 3.35 TB/s, or K11's float32 operations at 67 TFLOP/s, whichever
   is longer; of g, the gather kernels K1 and K2 read only each
   fragment's 2 * run lanes: bench.kernels.gather_bytes; the table
   sources of K2, K7a, K8 and K9 read each table half a fragment names
   once, and the fragment index, avT and (K8, K9) lrT:
   bench.kernels.table_read_bytes); K13 also into receivers passed in
   (the ring's way), with the host's microseconds per call
   (time.perf_counter around unsynchronised calls) beside each
   CUDA-event time and the kernel's own device time (torch.profiler),
   and K13 across processes: two worker processes x 2 shards of the
   card (multihost --hops-only) chain the headline's B blocks through
   20 hops of the new instance (the barrier and the delivery as stream
   waits, a copy launch per source card), each bit for bit against the
   plain hop of torch.distributed, with ms per hop of both and the
   kernel's profiler time; the kernels of bench.kernels.PROFILE_NAMES
   (K1-K3, K5, K7a, K7b, K8-K10, K12) with the same two beside each
   shape's CUDA-event time (a kernel_split JSON line); then cuSPARSE's
   CSR @ CSR of the headline (torch.sparse.mm), the library time of K12
   and of K1 (beside the headline's K1 launches; that plan also launches
   K2 + K3);
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
    and none failed, a winner and a MatNet verdict, the dia row run; then
    the port's spgemm-run binary (ia_spgemm_tpu_torch/cli/binary.py
    builds csrc/spgemm_run.cpp with the host C++ compiler and
    python3-config --embed; a failed build fails the run) with --mode
    all on the same .mtx, on the card: rc 0, its winner and verdict
    lines;
17. f64_flat and f64_multiclass: the flat spgemm_bitonic (K6 + K3) and
    the chunked width-class route (K5, K6 + K3) on the headline in
    float64: scipy's nnz (7,086,306) and pattern, values and checksum
    within 1e-9 of the float64 oracle;
18. f64_skew: the width-class route on build_skew_matrix() times a
    7-diagonal band, float64 (classes 128 to 8192: K4 in float64);
19. f32_wide_flat: the flat route on build_matrix(extra_per_row=60)
    (rows of up to ~100 entries) times the band, float32, outside the
    gather budget (ka * 128 > 8192): K6 + K3, within 1e-4 of scipy;
20. the harness's baseline, bitonic, csr and dense_row rows on the
    m=4096 CLI input in float64, each ok within the 1e-9 gate;
21. the isolated watchdog: a _test_slow worker (start-up grace lowered to
    3 s) times out and is killed, then an isolated bitonic row runs ok,
    then the CLI's --mode all --isolate --no-matnet on the m=4096 .mtx:
    rc 0, no row failed;
22. ring: ring_spgemm on the headline over 4 shards of the card (one
    process), through K13 (use_rdma="auto"), through the plain hop, and
    with a flops-balanced (permuted) B through K13: scipy's nnz
    (7,086,306) and pattern, checksum within 1e-4, device ms per call;
23. dist: dist_spgemm on the headline over the same 4 shards, B
    all-gathered and B replicated, against scipy;
24. CLI: --mode ring and --mode dist with --shards 4 on the m=4096 .mtx
    (IA_SPGEMM_SHARDS_PER_DEVICE=4): rc 0, checksum ok;
25. multi-process: the ring across processes sharing the card, over
    gloo (python -m ia_spgemm_tpu_torch.parallel.multihost ... --matrix
    headline): 2 processes x 2 shards, then 4 x 1 (on a machine with
    several cards the workers see dev's card alone); then, where there
    are two or more cards, 2 processes x every card, a shard on each
    (each card's launch copies the blocks it holds, storing into its
    neighbour card's receivers and, from shard 0's card, the left
    process's by peer access; one line says it did not run on one
    card). Each worker runs the
    96 x 96 dist and ring checks (MULTIPROC_OK), then the ring on the
    headline with --rdma auto: K13 across processes on each of the
    process's cards in every one of the D - 1 steps (its launches
    counted; the hop of step s on side streams beside the gather of
    step s), its rows against scipy's A @ A (pattern exact, values
    within 1e-4 of max |C|, checksum within 1e-4), one hop of the
    headline's B blocks through K13 bit for bit against the plain hop of
    torch.distributed, the ms per hop of both over 20 hops, with the
    kernel's profiler time in worker 0, and the ring's ms per call
    through K13 and through the plain hop in the same run (a multiproc
    JSON line, the hop's bound beside: bytes once through each card's
    memory and once over NVLink between cards, multihost.hop_bound_ms;
    worker 0's steps of one ring call from its home card's events:
    gather, hop issue, barrier, copies, delivery wait);
26. scaling: bench.scaling's ring scaling on the headline at D = 1, 2, 4
    shards of the card, reported simulated (the shards share the card);
27. the selector's training path: the harvest (models.upcycle's
    harvest_report and sample_from_report, the two halves of
    harvest_sample) with device timers and the menu of
    weights/TPU_upcycled_v3.npz on four named replicas at their
    published sizes (HARVEST_NAMES: poisson3Da, m133-b3, scircuit,
    majorbasis; io.suitesparse.gen_named): every row ok or skipped (none
    failed, every checksum within the harness's gate), each ok row run
    once more (its launches not counted) and its C held to scipy's
    float64 A @ A (the pattern of nonzero entries exact, values within
    ORACLE_TOL), a device-time winner for each, each replica's device
    and wall ms per algorithm beside v3's pick; upcycle (50 steps, batch 16, from
    random init) with finite losses and a 5-class head; train on
    synthetic_dataset (60 steps, batch 16, lr 3e-3) ending below 0.8x
    its first loss; ms per training step at batch 16 and 32 (CUDA
    events, TF32 off, the batch on the card); one step on the card
    against the CPU (loss within 1e-5, gradients within 1e-4 of each
    tensor's max) and over 4 shards of the card against one (loss and
    gradients within 1e-5); save_params_npz / load_params_npz give the
    same logits; evaluate_pick_accuracy on the harvest with the trained
    weights and with TPU_upcycled_v3; graft_entry.dryrun_multichip(4) on
    4 shards of the card;
28. the corpus driver (python -m ia_spgemm_tpu_torch.models.harvest):
    the quick corpus (m = 1024) harvested on the card into a temporary
    directory, one worker process per entry, no worker started after
    HARVEST_QUICK_S: every entry it attempted gave a sample, at least
    two; a second run over those entries resumes and harvests nothing;
    a retrain of 20 steps and 2 folds on the card writes the JAX
    report's keys; then the committed card-labelled weights
    (weights/H100_upcycled.npz) pick on phase 27's four replicas,
    printed beside phase 27's winners and v3's picks (not a gate);
29. the acceptance run (ia_spgemm_tpu_torch.bench.acceptance, the port
    of scripts/acceptance.py), in process: headline_rooflines at full
    width (the m=32768 headline through the slab engine, its flattening
    by gathers and by scatter, the global sort, the tiled route, the
    flat bitonic route, compensated and dense_row against a dense B of
    2048 columns; the m=32768 skew matrix through the width classes,
    with and without the pregather, the ESC fallback and plan_csr_auto;
    dense_row against scipy's CSR @ dense): every route's C held to
    scipy's float64 product before it is timed (pattern exact, values
    within 1e-4 of max(1, max|C|), compensated 1e-12), one line per key
    (ms, device ms, share of the speed of light), the router's pick
    beside the manual routes' device ms, and no share above SHARE_LIMIT
    (105%) of its least time (the JAX cost model's; dense_row's: A, B
    and C once each, since its JAX count charges 8 rows of B per A
    entry); then fixture_sweeps over three .mtx files (build_matrix(m=
    4096), a 3000 x 4096 random matrix for A @ A^T, a 5-point Laplacian
    on 64 x 64): every row ok or skipped, none failed, a winner each; an
    acceptance JSON line (the rooflines, their costs, the winners, the
    phase's seconds).

Every kernel wrapper counts its launches. Phases 4, 5, 7-10, 12-15,
17-19, 22-23, 25, 27's harvest, 28's quick harvest and 29's rooflines
each drive a main path on its own input: the counts are set to 0 just
before each run and read just after it (a worker process starts from
0).
K1, K2 and K3 must have been launched in phase 4, K2, K3 and K4 in
phase 5, K8 and K3 in phase 7, K9 and K10 in phase 9, K8 in the hybrid
run of phase 10, K7a and K7b in phase 12, K12 in 13, K11 in 14, the flat
route's kernels in spgemm_auto (15), K6 and K3 in f64_flat and
f32_wide_flat, K5, K6 and K3 in f64_multiclass, K4 in f64_skew, K13 and
K4 in the K13 ring runs of 22 (no K13 in the plain-hop run), none in the
plain-torch dist runs of 23, K13 and K4 in the workers of 25 (their
counts summed: ring_multiproc_2x2, ring_multiproc_4x1 and, on several
cards, ring_multiproc_2xevery), at least one
kernel in the harvest of 27 and in the workers of 28 (harvest_quick),
K1-K4 and K8-K11 in the rooflines of 29 (acceptance). Phase 3's
comparison launches and those of the CLI, the workers' other runs, the
scaling phase and 29's fixture sweep are not counted. The line before
the last two is a JSON object with one entry per kernel
("ms"/"plain_ms"/"library_ms"/"bound_ms": summed over its phase-3
shapes, "bound_by" the larger term; "launches": the sum over the
main-path runs, split in "launches_by_run"; "kernel_alone_ms" for the
kernels of PROFILE_NAMES: the kernel alone, summed over its shapes;
K13's "across_processes": phase 3's hop check and, per run of phase 25,
the ms per hop through K13 and through the plain hop, the kernel's us
(per card, per launch, and per hop the longest card's), the hop's bound and the ring's ms per call through each); then the
nvidia-smi line; the last line is {"ok": true, "device": {...}}.
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
           "hash": "ia_spgemm_tpu_torch/csrc/hash.cu",
           "ring": "ia_spgemm_tpu_torch/csrc/ring.cu"}
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
            "K12": "ia_spgemm_tpu/ops/hash_spgemm.py:58",
            "K13": "ia_spgemm_tpu/parallel/rdma_ring.py:31"}
RING_SHARDS = 4          # the ring / dist phases: 4 shards of the one card
# phase 25: (main-path run, processes, shards per process) of the ring on
# the headline across processes sharing the card; and, on a machine with
# several cards, (run, processes) of the layout whose every process holds
# a shard on each card (None: not run on one card)
MULTIPROC_RUNS = (("ring_multiproc_2x2", 2, 2), ("ring_multiproc_4x1", 4, 1))
MULTIPROC_EVERY_CARD = ("ring_multiproc_2xevery", 2)
# phase 27: named replicas at their published sizes, one per structural
# family (irregular, exact-k, power law, stencil), harvested with the
# menu of weights/TPU_upcycled_v3.npz
HARVEST_NAMES = ("poisson3Da", "m133-b3", "scircuit", "majorbasis")
# phase 28: the quick corpus's harvest stops starting workers after this
# many seconds (a worker pays for a torch import and a CUDA context)
HARVEST_QUICK_S = 40
# one training step: the loss on the card against the CPU's, and the
# loss and each gradient (relative to its tensor's max |g|) of 4 shards
# of the card against one, within TRAIN_TOL; the card's gradients
# against the CPU's (cuDNN against the CPU's convolutions, TF32 off)
# within GRAD_TOL, the JAX parity tests' bound. Stepped weights are not
# compared: Adam's first step moves each weight by about lr * sign(g),
# so a gradient near 0 turns a rounding difference into up to 2 * lr.
TRAIN_TOL = 1e-5
GRAD_TOL = 1e-4
# phase 29: the kernels the acceptance run must launch, and the share of
# its least time no route may beat (a count at fault or a wrong timer)
ACCEPTANCE_KERNELS = ("K1", "K2", "K3", "K4", "K8", "K9", "K10", "K11")
SHARE_LIMIT = 105.0


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
    """Bytes of the tensors in x (a tensor or nested tuples of them), or
    x itself where it is already a count of bytes."""
    import torch
    if isinstance(x, int):
        return x
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(y) for y in x)
    return 0


def _record(stats, time_ms, dev, kname, what, err, kern, plain, ins,
            library=None, flops=0.0):
    """Into stats: median ms of the kernel, of its plain version and of
    `library` (one PyTorch call computing the same function, or None);
    and the bound's two terms: what the kernel must read, `ins` (the
    input tensors, each read once, or a count of bytes) plus its outputs
    written once, at PEAK_BYTES_PER_S, and `flops` (the float32
    operations these inputs need) at PEAK_F32_FLOPS. For the kernels of
    PROFILE_NAMES also the kernel alone (torch.profiler, us per launch)
    and the host's us per call (unsynchronised calls), summed into
    "kernel_alone_ms" and listed per shape under "split". Returns the
    kernel's ms."""
    from ia_spgemm_tpu_torch.bench.kernels import (PEAK_BYTES_PER_S,
                                                   PEAK_F32_FLOPS,
                                                   PROFILE_NAMES, host_us,
                                                   kernel_us)
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
    split = ""
    if kname in PROFILE_NAMES:
        k_us, h_us = kernel_us(kern, PROFILE_NAMES[kname]), host_us(kern)
        s["kernel_alone_ms"] = s.get("kernel_alone_ms", 0.0) + k_us / 1e3
        s.setdefault("split", []).append({
            "shape": what, "ms": ms, "kernel_us": k_us, "host_us": h_us,
            "bound_ms": max(bytes_ms, ops_ms), "plain_ms": pms})
        split = f" kernel_us={k_us} host_us={h_us}"
    print(f"  {kname} {what}: max_abs_err={err} ms={ms} plain_ms={pms} "
          f"library_ms={lms} bound_ms={max(bytes_ms, ops_ms)}{split}",
          flush=True)
    return ms


def _torch_sort(key):
    """The library yardstick of the sort kernels (K4-K6): one stable
    torch.sort of the keys alone (the value gather is left out)."""
    import torch
    return lambda: torch.sort(key, dim=1, stable=True)


def _check_cols(stats, label, time_ms, dev, key, val, *, width,
                start_kk):
    """The kernels of pre-expanded rows (the torch _expand_ell's) against
    their plain versions, routed as the main paths route them: K6 up to
    TRANSPOSED_MAX_WIDTH, K4 above (K5, which takes the rows up to
    FUSED_MAX_WIDTH, and K3 on K6's rows are cases of
    bench.kernels.network_cases)."""
    import torch

    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K

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
    elif width > bt.FUSED_MAX_WIDTH:
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
    classes up to TRANSPOSED_MAX_WIDTH take K1, or K2 + K3 (cases of
    bench.kernels.network_cases), the wider ones K4 (here); a chunked
    float64 call's the cols layout over the torch expand."""
    import torch

    from ia_spgemm_tpu_torch.bench import kernels as KB
    from ia_spgemm_tpu_torch.ops import bitonic as bt
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K

    def record(kname, shape, err, kern, plain, ins, library=None):
        return _record(stats, time_ms, dev, kname, f"{label} {shape}", err,
                       kern, plain, ins, library)

    run = call.run
    if not call.ragged:
        if call.A.dtype == torch.float32:
            raise AssertionError(f"{label}: a chunked float32 call")
        for i, w in enumerate(call.widths):
            key, val = KB.chunked_class_rows(call, i)
            _check_cols(stats, f"{label} run={run}", time_ms, dev, key, val,
                        width=w, start_kk=2 * run)
        return
    for i, w in enumerate(call.widths):
        if w <= bt.TRANSPOSED_MAX_WIDTH:
            continue
        shape = f"width={w} rows={call.counts[i]} run={run}"
        key, val = bt._expand_rows(call.table, call.frags[i].T,
                                   call.avts[i].T, run=run, width=w)
        f = lambda fn: fn(key, val, width=w,  # noqa: E731
                          start_kk=2 * run)
        err = _compare(f"K4 {shape}", f(K.sort_compress_rows),
                       f(K.sort_compress_rows_plain))
        record("K4", shape, err, lambda: f(K.sort_compress_rows),
               lambda: f(K.sort_compress_rows_plain), (key, val),
               _torch_sort(key))


def _check_network(stats, time_ms, dev):
    """K1-K3, K5, K7a, K7b, K8 and K9 against their plain versions at
    every case of bench.kernels.network_cases (the main paths' shapes);
    returns their ms on the headline's pregathered classes."""
    from ia_spgemm_tpu_torch.bench import kernels as KB
    ms = {}
    for c in KB.network_cases(dev):
        err = KB.check_case(c, c.call(), c.plain())
        t = _record(stats, time_ms, dev, c.kernel, c.shape, err, c.call,
                    c.plain, c.read_bytes, c.library)
        if c.source == "headline":
            ms[c.kernel] = ms.get(c.kernel, 0.0) + t
    return ms


def _check_k10(A, stats, time_ms, dev):
    """K10 on K9's sorted slabs of the compensated plan of C = A @ A
    against its plain version (K8 and K9 are cases of
    bench.kernels.network_cases)."""
    from ia_spgemm_tpu_torch.bench import kernels as KB
    from ia_spgemm_tpu_torch.ops import slab
    from ia_spgemm_tpu_torch.ops import slab_kernels as SK

    p = slab.plan_slab_csr(A, A, dd=True).plan
    ops, kw = KB.slab_operands(p)
    key, val = SK.expand_sort_lr_dd(*ops, **kw)
    shape = f"headline slabs={p.n_slabs} width={p.width} run={p.run}"
    f = lambda fn: fn(key, val, width=p.width)  # noqa: E731
    err = _compare_dd(f"K10 {shape}", f(SK.compress_dd),
                      f(SK.compress_dd_plain))
    _record(stats, time_ms, dev, "K10", shape, err, lambda: f(SK.compress_dd),
            lambda: f(SK.compress_dd_plain), (key, val))


def _values_err(name, got, want, tol):
    """max |got - want| on the card, within tol * max(1, max|want|)."""
    import torch
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max |dval| {err} > {tol} * {scale}")
    return err


def _same_bits(name, got, want):
    """Bit for bit (K11 on an ELL built from canonical CSR): returns 0."""
    import torch
    torch.cuda.synchronize()
    if not (got.dtype == want.dtype and torch.equal(got, want)):
        err = (got.double() - want.double()).abs().max().item()
        raise AssertionError(f"{name}: not bit for bit (max |dval| {err})")
    return 0.0


def _sorted_tables(col, val):
    """Hash tables with each row's slots sorted by column (empty slots
    last): the kernel's hash order and the plain version's column order
    then compare slot by slot."""
    import torch
    key = torch.where(col >= 0, col, 2**31 - 1)
    key, order = torch.sort(key, dim=1)
    return key, torch.gather(val, 1, order)


def _check_input_aware_kernels(H, A16, A16_ell, B16, stats, time_ms, dev):
    """K11 on the m=16384 dense-row input and K12 on the headline ELL
    pair, each against its plain version at those shapes."""
    import torch

    from ia_spgemm_tpu_torch.bench import kernels as KB
    from ia_spgemm_tpu_torch.bench.headline import build_matrix
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.ops import dense_row_kernels as DK
    from ia_spgemm_tpu_torch.ops import hash_kernels as HK
    from ia_spgemm_tpu_torch.ops import hash_spgemm

    ka = H.max_nnz_per_row
    f = lambda fn: fn(A16_ell.col_ind, A16_ell.values, B16)  # noqa: E731
    shape = (f"A ELL {tuple(A16_ell.col_ind.shape)} x dense B "
             f"{tuple(B16.shape)}")
    err = _same_bits(f"K11 {shape}", f(DK.dense_row), f(DK.dense_row_plain))
    # cuSPARSE SpMM (torch.sparse.mm of A as sparse CSR), the yardstick
    nnz16 = int(A16.nnz)
    a16_sp = torch.sparse_csr_tensor(A16.row_ptr, A16.col_ind[:nnz16],
                                     A16.values[:nnz16], size=A16.shape)
    _record(stats, time_ms, dev, "K11", shape, err,
            lambda: f(DK.dense_row), lambda: f(DK.dense_row_plain),
            (A16_ell.col_ind, A16_ell.values, B16),
            lambda: torch.sparse.mm(a16_sp, B16),
            flops=2.0 * nnz16 * B16.shape[1])
    del a16_sp
    # the float64 instance (the harness's dense_row row on a float64 CSR)
    A4 = CSR.from_scipy(build_matrix(m=4096), device=A16.device)
    E4 = convert.csr_to_ell(A4, check_guard=False)
    B4 = convert.csr_to_dense(A4).values
    f = lambda fn: fn(E4.col_ind, E4.values, B4)  # noqa: E731
    got = f(DK.dense_row)
    _same_bits("K11 float64", got, f(DK.dense_row_plain))
    # its bound (bytes, or float64 operations at KB.PEAK_F64_FLOPS) and
    # cuSPARSE SpMM in float64 on the same input
    nnz4 = int(A4.nnz)
    a4_sp = torch.sparse_csr_tensor(A4.row_ptr, A4.col_ind[:nnz4],
                                    A4.values[:nnz4], size=A4.shape)
    bound4 = max((_nbytes((E4.col_ind, E4.values, B4)) + _nbytes(got))
                 / KB.PEAK_BYTES_PER_S,
                 2.0 * nnz4 * B4.shape[1] / KB.PEAK_F64_FLOPS) * 1e3
    print(f"  K11 float64 A ELL {tuple(E4.col_ind.shape)} x dense B "
          f"{tuple(B4.shape)}: bit for bit, ms="
          f"{time_ms(lambda: f(DK.dense_row), dev, 2, 20)} plain_ms="
          f"{time_ms(lambda: f(DK.dense_row_plain), dev, 2, 20)} "
          f"library_ms="
          f"{time_ms(lambda: torch.sparse.mm(a4_sp, B4), dev, 2, 20)} "
          f"bound_ms={bound4}", flush=True)
    del A4, E4, B4, got, a4_sp

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


def _check_ring_kernels(H, stats, time_ms, dev):
    """K13 on the headline's B blocks at the ring's shapes (D = 4 and 8
    shards of the card), bit for bit against the plain hop, a public call
    (fresh receivers) and the ring's (receivers passed in), with the
    host's microseconds per call and the kernel's own device time; K4 on
    one shard's products of the D = 4 ring."""
    import torch

    from ia_spgemm_tpu_torch.bench.kernels import (host_us, k13_host_split,
                                                   kernel_us)
    from ia_spgemm_tpu_torch.ops import bitonic_kernels as K
    from ia_spgemm_tpu_torch.parallel import rdma_ring as RR
    from ia_spgemm_tpu_torch.parallel import ring
    from ia_spgemm_tpu_torch.parallel.mesh import make_mesh

    for D in (RING_SHARDS, 2 * RING_SHARDS):
        Bs = ring.partition_rows_ell(H, D, mesh=make_mesh(
            devices=[dev] * D))
        blocks = (Bs.col_ind, Bs.values)
        got, want = RR.ring_hop_rdma(*blocks), RR.ring_hop_plain(*blocks)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for ga, wa in zip(got, want)
                   for g, w in zip(ga, wa)):
            raise AssertionError(f"K13 D={D}: blocks differ from the plain "
                                 "hop")
        # the ring's way: a hop of the previous hop's receivers into the
        # other set of two made once
        sets = [RR.alloc_receivers(*blocks) for _ in range(2)]
        first = RR.ring_hop_rdma(*blocks, out=sets[0])
        got = RR.ring_hop_rdma(*first, out=sets[1])
        want = RR.ring_hop_plain(*RR.ring_hop_plain(*blocks))
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for ga, wa in zip(got, want)
                   for g, w in zip(ga, wa)):
            raise AssertionError(f"K13 D={D} into reused receivers: blocks "
                                 "differ from the plain hop")
        stk = [torch.stack(x) for x in blocks]
        what = (f"headline B blocks D={D} x ({Bs.rows_per_shard}, "
                f"{Bs.width}) int32 + float32")
        call = lambda: RR.ring_hop_rdma(*blocks)  # noqa: E731
        ring_call = lambda: RR.ring_hop_rdma(  # noqa: E731
            *first, out=sets[1])
        roll = lambda: [torch.roll(x, -1, 0) for x in stk]  # noqa: E731
        _record(stats, time_ms, dev, "K13", what, 0.0, call,
                lambda: RR.ring_hop_plain(*blocks), blocks, roll)
        host = {"D": D, "call_event_ms": time_ms(call, dev, 2, 20),
                "call_host_us": host_us(call),
                "ring_call_event_ms": time_ms(ring_call, dev, 2, 20),
                "ring_call_host_us": host_us(ring_call),
                "roll_event_ms": time_ms(roll, dev, 2, 20),
                "roll_host_us": host_us(roll),
                "kernel_us": kernel_us(ring_call, "k13_ring_hop"),
                "host_split_us": k13_host_split(blocks)}
        print(f"  K13 D={D} host: {json.dumps(host)}", flush=True)
        del got, want, stk, sets, first
    mesh = make_mesh(devices=[dev] * RING_SHARDS)
    S = ring.partition_rows_ell(H, RING_SHARDS, mesh=mesh)
    plan = ring.plan_ring(H, H, RING_SHARDS)
    if (plan.width, plan.run, plan.chunks) != (1024, 32, 1):
        raise AssertionError(f"headline ring plan {plan}")
    keys, vals = ring.ring_products(S, S, mesh, plan)
    key, val = keys[0], vals[0]
    kw = dict(width=plan.width, start_kk=2 * plan.run)
    what = f"ring shard rows={key.shape[0]} width={plan.width} run=32"
    err = _compare(f"K4 {what}", K.sort_compress_rows(key, val, **kw),
                   K.sort_compress_rows_plain(key, val, **kw))
    _record(stats, time_ms, dev, "K4", what, err,
            lambda: K.sort_compress_rows(key, val, **kw),
            lambda: K.sort_compress_rows_plain(key, val, **kw), (key, val),
            _torch_sort(key))


def _against_scipy(name, C, want):
    d = abs(C.to_scipy() - want)
    err = d.max() if d.nnz else 0.0
    scale = max(1.0, abs(want).max())
    if not (int(C.nnz) == want.nnz and err <= ORACLE_TOL * scale):
        raise AssertionError(f"{name}: nnz {int(C.nnz)} vs {want.nnz}, "
                             f"max err {err} (scale {scale})")
    return err


def _distributed_phases(A, H, ref_sum, by_run, reset_counts, counts,
                        launched, same_pattern, time_ms, dev):
    """Phases 22-26: the ring and dist routes on the headline over
    RING_SHARDS shards of the card, the CLI's --mode ring / dist, the
    ring across processes sharing the card (MULTIPROC_RUNS; returns
    their summaries), and the ring's scaling (simulated)."""
    import torch

    from ia_spgemm_tpu_torch.bench import scaling
    from ia_spgemm_tpu_torch.cli import main as cli
    from ia_spgemm_tpu_torch.formats import convert
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.io import mmio
    from ia_spgemm_tpu_torch.bench import headline
    from ia_spgemm_tpu_torch.parallel import distributed as pdist
    from ia_spgemm_tpu_torch.parallel import ring
    from ia_spgemm_tpu_torch.parallel.mesh import (SHARDS_PER_DEVICE_ENV,
                                                   make_mesh)

    D = RING_SHARDS
    mesh = make_mesh(devices=[dev] * D)
    dist_info = {}

    def route(run, fn, to_csr, kernels, no_kernels=()):
        """One main-path run: launches, scipy's nnz and pattern, the
        checksum within 1e-4, then the route's device ms per call."""
        reset_counts()
        out = fn()
        by_run[run] = counts()
        launched(run, kernels)
        extra = [k for k in no_kernels if by_run[run][k]]
        if extra:
            raise AssertionError(f"{run} launched {extra}")
        C = to_csr(out)
        err = same_pattern(run, C)
        rel = abs(float(C.checksum()) - ref_sum) / max(1.0, abs(ref_sum))
        if not rel <= ORACLE_TOL:
            raise AssertionError(f"{run}: checksum rel err {rel}")
        ms = time_ms(fn, dev, 1, 10)
        dist_info[run] = {"device_ms": ms, "nnz": int(C.nnz),
                          "max_err": err, "checksum_rel_err": rel,
                          "launches": by_run[run]}
        print(f"[{run}] shards={D} nnz={int(C.nnz)} max_err={err} "
              f"rel_err={rel} device_ms={ms} launches={by_run[run]}",
              flush=True)

    # ---- 22. the ring: K13, the plain hop, a permuted B
    plan = ring.plan_ring(H, H, D)
    As = ring.partition_rows_ell(H, D, mesh=mesh)
    Bf = ring.partition_rows_ell(H, D, mesh=mesh, balance="flops", B=H)
    ell_csr = lambda Ce: convert.ell_to_csr(  # noqa: E731
        ring.gather_result_ell(Ce))
    for run, Bs, rdma, want, never in (
            ("ring", As, "auto", ["K13", "K4"], ()),
            ("ring_plain_hop", As, False, ["K4"], ("K13",)),
            ("ring_flops_b", Bf, "auto", ["K13", "K4"], ())):
        route(run, lambda Bs=Bs, rdma=rdma: ring.ring_spgemm(
            As, Bs, mesh, plan, use_rdma=rdma), ell_csr, want, never)
    del As, Bf

    # ---- 23. dist: B all-gathered, B replicated (plain torch ESC)
    e_cap, out_cap = pdist.plan_dist_spgemm(A, A, D, balance="flops")
    Ad = pdist.partition_rows(A, D, balance="flops", B=A, mesh=mesh)
    Bd = pdist.partition_rows(A, D, mesh=mesh)
    for run, Bx in (("dist_allgather", Bd), ("dist_replicated", A)):
        route(run, lambda Bx=Bx: pdist.dist_spgemm(
            Ad, Bx, mesh, e_cap=e_cap, out_cap=out_cap),
            pdist.gather_result, [])
    del Ad, Bd
    print(json.dumps({"distributed": dist_info}), flush=True)

    # ---- 24. the CLI's distributed modes
    os.environ[SHARDS_PER_DEVICE_ENV] = str(D)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "smoke.mtx")
            mmio.write_mtx(path, CSR.from_scipy(headline.build_matrix(
                m=4096), device="cpu"))
            for mode in ("ring", "dist"):
                out = os.path.join(tmp, f"{mode}.json")
                rc = cli.main([path, "--mode", mode, "--shards", str(D),
                               "--device", dev.type, "--no-matnet",
                               "--iters", "3", "--json", out])
                with open(out) as f:
                    rep = json.load(f)
                if rc != 0 or not rep["checksum_rel_err"] < ORACLE_TOL:
                    raise AssertionError(f"CLI --mode {mode}: rc {rc}, "
                                         f"{rep}")
                print(f"[24] CLI --mode {mode} --shards {D}: rc 0 {rep}",
                      flush=True)

        # ---- 25. the ring across processes sharing the card, on the
        # headline: 2 processes x 2 shards, then 4 x 1, over gloo; then
        # 2 processes x every card where the machine has several
        multiproc = {}
        for run, nproc, per_proc in MULTIPROC_RUNS:
            multiproc[run] = _multiproc_run(run, nproc, per_proc, dev,
                                            by_run, list(counts()), launched)
        run, nproc = MULTIPROC_EVERY_CARD
        if torch.cuda.device_count() > 1:
            multiproc[run] = _multiproc_run(run, nproc, None, dev, by_run,
                                            list(counts()), launched)
        else:
            print(f"[25] {run}: not run: this machine has one card (the "
                  f"layout puts a shard of each of {nproc} processes on "
                  "every card)", flush=True)
        print(json.dumps({"multiproc": multiproc}), flush=True)

        # ---- 26. the ring's scaling over 1, 2, 4 shards of the card
        pts = scaling.measure_ring_scaling(A, (1, 2, D), iters=5)
        rep = scaling.report(pts, dev.type)
        if not (rep["simulated"] and [p.devices for p in pts] == [1, 2, D]
                and all(p.nnz_out == HEADLINE_NNZ for p in pts)):
            raise AssertionError(f"scaling: {rep}")
        rep["model_h100_nvlink"] = scaling.model_ring_efficiency(
            A, (1, 2, D, 8), t1_ms=pts[0].time_ms)
        print(json.dumps({"scaling": rep}), flush=True)
    finally:
        del os.environ[SHARDS_PER_DEVICE_ENV]
    torch.cuda.synchronize()
    return multiproc


def _workers(nproc, per_proc, dev, *args):
    """nproc worker processes (python -m
    ia_spgemm_tpu_torch.parallel.multihost PID NPROC PORT cuda gloo
    *args), each with per_proc shards of dev's card (per_proc None: a
    shard on every card of the machine), over gloo; their outputs once
    every one exited 0 with MULTIPROC_OK, and the wall seconds."""
    import socket

    import torch

    from ia_spgemm_tpu_torch.parallel.mesh import SHARDS_PER_DEVICE_ENV
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    if per_proc is None:
        env[SHARDS_PER_DEVICE_ENV] = "1"
    else:
        env[SHARDS_PER_DEVICE_ENV] = str(per_proc)
        if torch.cuda.device_count() > 1:     # the workers see dev's card
            seen = os.environ.get("CUDA_VISIBLE_DEVICES")
            env["CUDA_VISIBLE_DEVICES"] = (seen.split(",")[dev.index]
                                           if seen else str(dev.index))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-m",
         "ia_spgemm_tpu_torch.parallel.multihost", str(pid), str(nproc),
         str(port), dev.type, "gloo", *args], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "MULTIPROC_OK" not in out:
            raise AssertionError(f"{args} worker {pid} rc {p.returncode}:"
                                 f"\n{out}")
    return outs, time.perf_counter() - t0


def _json_lines(outs, key):
    """Each worker's first JSON line of `key`, in process order."""
    infos = []
    for pid, out in enumerate(outs):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith('{"%s"' % key)]
        if not lines:
            raise AssertionError(f"worker {pid} printed no {key} line:\n"
                                 f"{out}")
        infos.append(json.loads(lines[0])[key])
    return infos


def _check_xproc_hop(dev):
    """K13 across processes against its plain version (phase 3): two
    worker processes x 2 shards of dev's card, the headline's B blocks
    through multihost.HOPS hops of K13 chained into the shared receiver
    sets, each bit for bit against the plain hop of torch.distributed
    (``multihost --hops-only``); returns the summary (ms per hop of
    both, the kernel's us, launches)."""
    outs, wall_s = _workers(2, 2, dev, "--hops-only")
    infos = _json_lines(outs, "xproc_hop")
    if any(i["launches"] != i["hops"] for i in infos):
        raise AssertionError(f"K13 across processes launches: {infos}")
    rep = {"processes": 2, "shards_per_process": 2, "wall_s": wall_s,
           "hops": infos[0]["hops"], "launches": sum(
               i["launches"] for i in infos),
           "max_abs_err": max(i["max_abs_err"] for i in infos),
           "hop_ms": [i["hop_ms"] for i in infos],
           "plain_hop_ms": [i["plain_hop_ms"] for i in infos],
           "issue_us_median": [i["issue_us_median"] for i in infos],
           "kernel_us": infos[0]["kernel_us"]}
    print(f"  K13 across processes (2 x 2 shards of the card): "
          f"{json.dumps(rep)}", flush=True)
    return rep


def _multiproc_run(run, nproc, per_proc, dev, by_run, names, launched):
    """Phase 25's run: nproc workers (``_workers`` with --matrix
    headline), each with per_proc shards of dev's card (per_proc None: a
    shard on every card of the machine), over gloo. Each worker checks
    its 96 x 96 dist and ring runs (MULTIPROC_OK), then on the headline:
    K13 on each of its cards in every one of the D - 1 steps, its rows
    against scipy, one hop through K13 bit for bit against the plain
    hop, and prints a multiproc JSON line (launches, ring ms per call
    through K13 and through the plain hop, ms per hop of K13 and of the
    plain hop, the kernel's profiler time in worker 0 (per card and the
    longest card's a hop), the hop's bound, the steps of one ring call).
    The workers'
    launches, summed, are main-path run `run`. Returns the run's
    summary."""
    import torch

    from ia_spgemm_tpu_torch.bench.kernels import PEAK_BYTES_PER_S
    from ia_spgemm_tpu_torch.bench.scaling import H100_NVLINK_BYTES_PER_S
    cards = torch.cuda.device_count()
    D = nproc * (cards if per_proc is None else per_proc)
    outs, wall_s = _workers(nproc, per_proc, dev, "--matrix", "headline",
                            "--rdma", "auto")
    infos = _json_lines(outs, "multiproc")
    for i in infos:
        if not (i["k13"] and i["hop_bitwise_equal"] and i["shards"] == D
                and i["launches"]["K13"]
                == (D - 1) * len(set(i["devices"]))):
            raise AssertionError(f"{run}: {i}")
    nnz = sum(i["nnz"] for i in infos)
    if nnz != HEADLINE_NNZ:
        raise AssertionError(f"{run}: {nnz} output nnz")
    by_run[run] = {n: sum(i["launches"].get(n, 0) for i in infos)
                   for n in names}
    launched(run, ["K13", "K4"])
    # the hop's bound (every process's copies at once: multihost.
    # hop_bound_ms) and that of one process's crossing: its block read
    # and written once in one card's memory, or once over NVLink
    head = infos[0]
    block = head["block_bytes"]      # int32 + float32 (rows, 29) blocks
    rep = {"processes": nproc, "shards_per_process": D // nproc,
           "cards": head["cards"],
           "wall_s": wall_s, "nnz": nnz,
           "max_abs_err": max(i["max_abs_err"] for i in infos),
           "checksum_rel_err": max(i["checksum_rel_err"] for i in infos),
           "launches": by_run[run],
           "ring_ms_median": [i["ring_ms_median"] for i in infos],
           "ring_ms_plain_hop_median": [i["ring_ms_plain_hop_median"]
                                        for i in infos],
           "hop_ms": [i["hop_ms"] for i in infos],
           "plain_hop_ms": [i["plain_hop_ms"] for i in infos],
           "kernel_us": head["kernel_us"],
           "steps": head.get("steps"),
           "bound_ms_hop": head["bound_ms_hop"],
           "bound_ms_crossing": 1e3 * (
               block / H100_NVLINK_BYTES_PER_S if head["cards"] > 1
               else 2 * block / PEAK_BYTES_PER_S)}
    print(f"[25] {run}: {nproc} processes x {D // nproc} shards on "
          f"{head['cards']} card(s) over gloo, MULTIPROC_OK from all in "
          f"{wall_s} s; "
          + " | ".join(ln for out in outs for ln in out.splitlines()
                       if " ok" in ln), flush=True)
    return rep


def _tree_leaves(tree):
    """The arrays of a nested parameter dict."""
    for v in tree.values():
        yield from _tree_leaves(v) if isinstance(v, dict) else (v,)


def _tree_rel_diff(x, y) -> float:
    """The largest max |x - y| / max |y| over the tensors of two
    parameter trees of one layout."""
    import numpy as np
    return max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                 1e-30)
               for a, b in zip(_tree_leaves(x), _tree_leaves(y)))


def _rows_against_scipy(name, a, A, rep):
    """Each row of a harvest report that came out ok, run once more on
    A @ A: its C against scipy's float64 product, the pattern of nonzero
    entries exact and the values within ORACLE_TOL * max(1, max|C|).
    {row: max |dval|}."""
    import numpy as np

    from ia_spgemm_tpu_torch import config as cfg
    from ia_spgemm_tpu_torch.bench import harness
    a64 = a.astype(np.float64)
    want = (a64 @ a64).tocsr()
    want.sum_duplicates()
    want.eliminate_zeros()
    scale = max(1.0, float(abs(want).max()))
    errs = {}
    for r in rep.results:
        if not r.ok or r.name == "baseline":
            continue
        convert_fn, compute = harness._ROWS[r.name](A, A, cfg.DEFAULT_CONFIG)
        got = compute(None if convert_fn is None else convert_fn())
        got = got.to_scipy().tocsr()
        got.sum_duplicates()
        got.eliminate_zeros()
        if not (np.array_equal(got.indptr, want.indptr)
                and np.array_equal(got.indices, want.indices)):
            raise AssertionError(f"harvest {name} {r.name}: pattern differs "
                                 f"from scipy's (nnz {got.nnz} vs "
                                 f"{want.nnz})")
        err = float(np.abs(got.data - want.data).max(initial=0.0))
        if not err <= ORACLE_TOL * scale:
            raise AssertionError(f"harvest {name} {r.name}: max |dval| "
                                 f"{err} > {ORACLE_TOL} * {scale}")
        errs[r.name] = err
        del got
    return errs


def _training_phase(by_run, reset_counts, counts, dev):
    """Phase 27: the selector's training path on the card. Harvest the
    named replicas (device-timed rows, the v3 menu), retrain MatNet on
    them, learn the synthetic task, hold a step on the card to the CPU
    and 4 shards to 1, round-trip the weights, score the picks, then
    graft_entry's dry run over 4 shards of the card."""
    import numpy as np
    import torch

    from ia_spgemm_tpu_torch import graft_entry
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.io import suitesparse
    from ia_spgemm_tpu_torch.models import matnet, train, upcycle, weights
    from ia_spgemm_tpu_torch.parallel.mesh import make_mesh

    info = {"harvest": {}}
    menu = upcycle.V3_MENU
    v3, v3_menu = weights.load_params_npz(os.path.join(
        weights.LOCAL_WEIGHTS_DIR, "TPU_upcycled_v3.npz"), with_menu=True)
    if tuple(v3_menu) != menu:
        raise AssertionError(f"v3 menu {v3_menu} != {menu}")

    # ---- 27a. harvest: every row ok or skipped, a device-time winner;
    # each ok row's C once more against scipy (launches not counted)
    samples = []
    launches = dict.fromkeys(counts(), 0)
    for name in HARVEST_NAMES:
        t0 = time.perf_counter()
        a = suitesparse.gen_named(name).astype(np.float32)
        gen_s = time.perf_counter() - t0
        A = CSR.from_scipy(a, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        rep = upcycle.harvest_report(A, A, menu, name=name, iters=2)
        s = upcycle.sample_from_report(A, A, rep, menu, name)
        torch.cuda.synchronize()
        harvest_s = time.perf_counter() - t0
        for k, n in counts().items():
            launches[k] += n
        bad = [(r.name, r.error, r.timed_out) for r in rep.results
               if r.error or not (r.ok or r.skipped)]
        if bad or s is None:
            raise AssertionError(f"harvest {name}: rows failed {bad}, "
                                 f"sample {s}")
        errs = _rows_against_scipy(name, a, A, rep)
        pick = menu[matnet.predict_class(v3, s.img1, s.img2, s.feats,
                                         device=dev)]
        info["harvest"][name] = {
            "m": a.shape[0], "nnz": int(a.nnz), "flops": rep.flops,
            "gen_s": gen_s, "harvest_s": harvest_s,
            "rows": {r.name: ("ok" if r.ok else "skipped")
                     for r in rep.results},
            "max_err_vs_scipy": errs,
            "device_ms": {n: t[0] for n, t in s.times.items()},
            "wall_ms": {n: t[1] for n, t in s.times.items()},
            "winner": s.winner, "v3_pick": pick}
        print(f"[27] harvest {name}: m={a.shape[0]} nnz={a.nnz} "
              f"{harvest_s} s; rows {info['harvest'][name]['rows']}; "
              f"max err vs scipy {errs}; "
              + ", ".join(f"{n} device {t[0]} ms wall {t[1]} ms"
                          for n, t in s.times.items())
              + f"; winner {s.winner}, v3 picks {pick}", flush=True)
        samples.append(s)
        del A, a
    by_run["harvest"] = launches
    if not any(launches.values()):
        raise AssertionError("the harvest launched no kernel")
    print(f"[27] harvest launches={launches}", flush=True)

    # ---- 27b. retrain on the harvest; learn the synthetic task
    params, history, _ = upcycle.upcycle(samples, menu=menu, init_from=None,
                                         steps=50, batch_size=16,
                                         device=dev)
    finite = all(np.isfinite(x).all() for x in _tree_leaves(params))
    if not (finite and all(np.isfinite(h[1]) for h in history)
            and params["head"]["kernel"].shape == (90, len(menu))):
        raise AssertionError(f"upcycle: history {history}, finite {finite}")
    cfg = train.TrainConfig(steps=60, batch_size=16, learning_rate=3e-3)
    _, hist = train.train(train.synthetic_dataset(cfg, seed=1), cfg,
                          device=dev, log_every=20, log=lambda *_: None)
    if not hist[-1][1] < 0.8 * hist[0][1]:
        raise AssertionError(f"synthetic task not learned: {hist}")
    info["upcycle_history"] = history
    info["synthetic_history"] = hist
    step_ms = {}
    for bs in (16, 32):
        c = train.TrainConfig(batch_size=bs)
        model, opt = train.make_model(c, device=dev)
        step = train.make_train_step(model, opt)
        batch = tuple(torch.as_tensor(x).to(dev)
                      for x in next(train.synthetic_dataset(c, 2)))
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            step(batch)
        end.record()
        end.synchronize()
        step_ms[bs] = start.elapsed_time(end) / 20
    info["train_step_ms"] = step_ms
    print(f"[27] upcycle losses {history}; synthetic {hist}; ms per "
          f"training step (batch on the card, TF32 off): {step_ms}",
          flush=True)

    # ---- 27c-d. one step on the card against the CPU, 4 shards against 1
    # (loss and gradients)
    c = train.TrainConfig(batch_size=16)
    batch = next(train.synthetic_dataset(c, 4))
    p0 = matnet.init_params(0)

    def one_step(device, mesh=None):
        model, opt = train.make_model(c, p0, device=device)
        loss, _ = train.make_train_step(model, opt, mesh)(batch)
        return float(loss), matnet.params_from_state_dict(
            {n: p.grad for n, p in model.named_parameters()})

    (l_cpu, g_cpu), (l_dev, g_dev) = one_step("cpu"), one_step(dev)
    (l_dp, g_dp) = one_step(dev, make_mesh(devices=[dev] * RING_SHARDS))
    parity = {"loss_cpu": l_cpu, "loss_card": l_dev, "loss_4_shards": l_dp,
              "grad_card_vs_cpu": _tree_rel_diff(g_dev, g_cpu),
              "grad_4_vs_1": _tree_rel_diff(g_dp, g_dev)}
    info["parity"] = parity
    if not (abs(l_dev - l_cpu) <= TRAIN_TOL * abs(l_cpu)
            and abs(l_dp - l_dev) <= TRAIN_TOL * abs(l_dev)
            and parity["grad_card_vs_cpu"] <= GRAD_TOL
            and parity["grad_4_vs_1"] <= TRAIN_TOL):
        raise AssertionError(f"training parity: {parity}")
    print(f"[27] parity: {parity}", flush=True)

    # ---- 27e. weights round trip; pick accuracy on the harvest
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "w.npz")
        weights.save_params_npz(path, params, menu=menu)
        back, back_menu = weights.load_params_npz(path, with_menu=True)
    s = samples[0]
    want = matnet.predict_logits(params, s.img1, s.img2, s.feats, device=dev)
    got = matnet.predict_logits(back, s.img1, s.img2, s.feats, device=dev)
    if tuple(back_menu) != menu or not torch.equal(got, want):
        raise AssertionError(f"weights round trip: {got} != {want}")
    info["pick_accuracy"] = {
        "trained": upcycle.evaluate_pick_accuracy(params, samples, menu,
                                                  device=dev),
        "TPU_upcycled_v3": upcycle.evaluate_pick_accuracy(v3, samples, menu,
                                                          device=dev)}
    print(f"[27] pick accuracy on the harvest: {info['pick_accuracy']}",
          flush=True)

    # ---- 27f. the dry run over 4 shards of the card
    info["dryrun"] = graft_entry.dryrun_multichip(RING_SHARDS, device=dev)
    print(json.dumps({"training": info}), flush=True)
    torch.cuda.synchronize()
    return info, samples


def _harvest_driver(*args):
    """python -m ia_spgemm_tpu_torch.models.harvest ARGS from the repo
    root, raising on a non-zero exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-m",
                        "ia_spgemm_tpu_torch.models.harvest", *args],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"harvest {args} rc {r.returncode}:\n"
                             f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")


def _corpus_phase(by_run, kernel_names, info27, samples27, dev):
    """Phase 28: the corpus driver, process-isolated: the quick corpus
    harvested on the card into a temporary directory within
    HARVEST_QUICK_S (every entry it attempts gives a sample, at least
    two), a second run over those entries that resumes and harvests
    nothing, a retrain of few steps on the card; then the committed card
    weights' picks on phase 27's replicas beside the winners phase 27
    measured there (a finding, not a gate)."""
    from ia_spgemm_tpu_torch.models import harvest, matnet, upcycle, weights
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _harvest_driver("--quick", "--harvest-only", "--out-dir", tmp,
                        "--max-seconds", str(HARVEST_QUICK_S))
        first_s = time.perf_counter() - t0
        log = harvest.read_log(os.path.join(tmp, "harvest_log.json"))
        run = log["runs"][-1]
        names = [s.matrix_name for s in upcycle.load_samples(
            os.path.join(tmp, "samples.npz"))]
        bad = {n: e for n, e in log["entries"].items() if e["status"] != "ok"}
        if bad or run["attempted"] != len(names) or len(names) < 2:
            raise AssertionError(f"quick harvest: {len(names)} samples of "
                                 f"{run['attempted']} attempted; {bad}")
        by_run["harvest_quick"] = {n: run["launches"].get(n, 0)
                                   for n in kernel_names}
        if not any(by_run["harvest_quick"].values()):
            raise AssertionError("the quick harvest launched no kernel")
        t0 = time.perf_counter()
        _harvest_driver("--quick", "--harvest-only", "--out-dir", tmp,
                        "--names", ",".join(names))
        resume_s = time.perf_counter() - t0
        log = harvest.read_log(os.path.join(tmp, "harvest_log.json"))
        if log["runs"][-1]["attempted"] != 0:
            raise AssertionError(f"the resumed run harvested: {log['runs']}")
        t0 = time.perf_counter()
        _harvest_driver("--retrain", os.path.join(tmp, "samples.npz"),
                        "--out-dir", tmp, "--steps", "20", "--kfold", "2")
        retrain_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "upcycle_report.json")) as f:
            rep = json.load(f)
        if list(rep) != list(harvest.REPORT_KEYS) + ["failed"] or \
                rep["n_samples"] != len(names):
            raise AssertionError(f"retrain report {rep}")
    print(f"[28] quick corpus: {len(names)} entries harvested in {first_s} s "
          f"({[log['entries'][n]['seconds'] for n in names]} s a worker), "
          f"winners {[log['entries'][n]['winner'] for n in names]}, "
          f"launches {by_run['harvest_quick']}; resumed run harvested "
          f"nothing in {resume_s} s; retrain (20 steps, 2 folds) in "
          f"{retrain_s} s: {rep}", flush=True)
    params, menu = weights.load_params_npz(os.path.join(
        weights.LOCAL_WEIGHTS_DIR, "H100_upcycled.npz"), with_menu=True)
    if tuple(menu) != harvest.MENU:
        raise AssertionError(f"H100 weights' menu {menu}")
    picks = {s.matrix_name: menu[matnet.predict_class(
        params, s.img1, s.img2, s.feats, device=dev)] for s in samples27}
    got = info27["harvest"]
    agree = sum(picks[n] == got[n]["winner"] for n in picks)
    print(f"[28] weights/H100_upcycled.npz picks on phase 27's replicas: "
          + ", ".join(f"{n} {picks[n]} (winner {got[n]['winner']}, v3 "
                      f"{got[n]['v3_pick']})" for n in picks)
          + f"; agrees on {agree} of {len(picks)}", flush=True)


def _acceptance_phase(by_run, reset_counts, counts, launched, dev):
    """Phase 29: the acceptance run (bench.acceptance) in process. Its
    headline_rooflines at full width is the main-path run "acceptance"
    (every route's C held to scipy before it is timed; no share above
    SHARE_LIMIT of its least count); then fixture_sweeps over three
    .mtx files written here: every row ok or skipped, none failed."""
    import numpy as np
    import scipy.sparse as sp

    from ia_spgemm_tpu_torch.bench import acceptance, headline, roofline
    from ia_spgemm_tpu_torch.formats.types import CSR
    from ia_spgemm_tpu_torch.io import mmio
    t_phase = time.perf_counter()
    chip = roofline.detect_chip(dev)
    costs = {}
    reset_counts()
    roofs = acceptance.headline_rooflines(dev, chip=chip, costs=costs)
    by_run["acceptance"] = counts()
    launched("acceptance", ACCEPTANCE_KERNELS)
    roof_s = time.perf_counter() - t_phase
    for key, e in roofs.items():
        rd = e.get("roofline_device") or {}
        print(f"[29] {key}: ms {e.get('time_ms', e.get('wall_ms'))} "
              f"device_ms {e.get('device_ms')} pct_of_sol "
              f"{e.get('pct_of_sol')} (device {rd.get('pct_of_sol')})"
              + "".join(f" {f} {e[f]!r}" for f in ("engine", "route",
                                                   "assembly") if f in e),
              flush=True)
    manual = {k: roofs[k]["device_ms"] for k in
              ("multiclass_skew", "multiclass_skew_pg", "skew_esc_fallback")}
    auto = roofs["esc_auto_skew"]
    print(f"[29] esc_auto_skew picks {auto['route']}: device_ms "
          f"{auto['device_ms']} beside the manual routes' {manual}; "
          f"launches {by_run['acceptance']}", flush=True)
    above = acceptance.shares_above(roofs, costs, chip, SHARE_LIMIT)
    if above:
        raise AssertionError(f"acceptance shares above {SHARE_LIMIT}% of "
                             f"their least time: {above}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(64, 64))
        mats = {"square": headline.build_matrix(m=4096),
                "rect": sp.random(3000, 4096, density=8 / 4096,
                                  format="csr",
                                  random_state=np.random.default_rng(29)),
                "laplacian": sp.kron(sp.identity(64), T)
                + sp.kron(T, sp.identity(64))}
        for name, a in mats.items():
            mmio.write_mtx(os.path.join(tmp, f"{name}.mtx"),
                           CSR.from_scipy(a.tocsr(), device="cpu"))
        sweeps = acceptance.fixture_sweeps(tmp, dev)
    sweep_s = time.perf_counter() - t0
    unread = {n: d["error"] for n, d in sweeps.items() if "error" in d}
    if unread:
        raise AssertionError(f"fixture sweep: unread files {unread}")
    # a row whose checksum missed the baseline's keeps ok and has an error
    rows = {n: {r["name"]: r["error"] or ("ok" if r["ok"] else "skipped"
                                          if r["skipped"] else "timed out")
                for r in d["results"]} for n, d in sweeps.items()}
    bad = {n: {a: v for a, v in r.items() if v not in ("ok", "skipped")}
           for n, r in rows.items()}
    if any(bad.values()) or not all(d["winner"] for d in sweeps.values()):
        raise AssertionError(f"fixture sweep: failed rows {bad}")
    print(f"[29] fixture sweep in {sweep_s} s: " + "; ".join(
        f"{n} winner {d['winner']} rows {rows[n]}"
        for n, d in sweeps.items()), flush=True)
    print(json.dumps({"acceptance": {
        "rooflines": roofs, "costs": costs,
        "sweep_winners": {n: d["winner"] for n, d in sweeps.items()},
        "rooflines_s": roof_s, "sweep_s": sweep_s,
        "phase_s": time.perf_counter() - t_phase}}), flush=True)


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

    from ia_spgemm_tpu_torch.bench import kernels as KB
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
    from ia_spgemm_tpu_torch.parallel import rdma_ring as RR

    modules = {"bitonic": K, "slab": SK, "dense_row": DK, "hash": HK,
               "ring": RR}
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
    headline_ms = _check_network(stats, time_ms, dev)
    H = ell(a32)
    _check_kernels(bt.multiclass_planned(
        H, H, assemble="bcsr", pregather=True, run_override=8), stats,
        "headline", time_ms, dev)
    skew = headline.build_skew_matrix()
    S = ell(skew)
    _check_kernels(bt.multiclass_planned(S, S, assemble="bcsr"), stats,
                   "skew", time_ms, dev)
    del S
    _check_k10(A, stats, time_ms, dev)
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
        plan, key, val = KB.flat_rows(X, Y)
        kw = dict(width=plan.width, start_kk=2 * plan.run)
        _check_cols(stats, f"{label} run={plan.run}", time_ms, dev, key, val,
                    **kw)
        split[label] = _k5_beside_k6_k3(key, val, time_ms=time_ms, dev=dev,
                                        **kw)
        del key, val
    print(json.dumps({"k5_beside_k6_k3": split}), flush=True)
    _check_ring_kernels(H, stats, time_ms, dev)
    stats["K13"]["across_processes"] = _check_xproc_hop(dev)
    # cuSPARSE CSR @ CSR of the headline (torch.sparse.mm), the library
    # yardstick of the whole product: for K12 (the hash route computes
    # all of it) and for K1 beside the headline's K1 launches (its plan
    # also launches K2 + K3 for the 224 rows of its 1024 class)
    nnz_a = int(A.nnz)
    a_sp = torch.sparse_csr_tensor(A.row_ptr, A.col_ind[:nnz_a],
                                   A.values[:nnz_a], size=A.shape)
    c_sp = torch.sparse.mm(a_sp, a_sp)
    torch.cuda.synchronize()
    if not (c_sp.shape == A.shape and c_sp._nnz() >= HEADLINE_NNZ
            and bool(torch.isfinite(c_sp.values()).all())):
        raise AssertionError(f"cuSPARSE headline: nnz {c_sp._nnz()}")
    cus_ms = time_ms(lambda: torch.sparse.mm(a_sp, a_sp), dev, 2, 20)
    stats["K1"]["library_ms"] = stats["K12"]["library_ms"] = cus_ms
    print(json.dumps({"cusparse": {
        "headline_csr_at_csr_ms": cus_ms, "nnz": c_sp._nnz(),
        "headline_k1_ms": headline_ms.get("K1"),
        "headline_k2_k3_ms": (headline_ms.get("K2", 0.0)
                              + headline_ms.get("K3", 0.0)),
        "k12_ms": stats["K12"]["ms"]}}), flush=True)
    del a_sp, c_sp
    print(json.dumps({"kernel_split": {n: stats[n]["split"]
                                       for n in KB.PROFILE_NAMES}}),
          flush=True)
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
    launched("headline", ["K1", "K2", "K3"])
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
        # the port's spgemm-run binary (C++ main embedding CPython, built
        # here from csrc/spgemm_run.cpp) on the same input
        from ia_spgemm_tpu_torch.cli import binary
        t0 = time.perf_counter()
        exe = binary.build()
        build_s = time.perf_counter() - t0
        proc = subprocess.run([str(exe), path, "--mode", "all", "--iters",
                               "3"], capture_output=True, text=True,
                              timeout=300)
        said = {key: [ln for ln in proc.stdout.splitlines()
                      if ln.startswith(key)]
                for key in ("Fastest algorithm:", "MatNet pick:")}
        if proc.returncode != 0 or not all(said.values()):
            raise AssertionError(f"spgemm-run binary --mode all: rc "
                                 f"{proc.returncode}\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-3000:]}")
        print(f"[16] spgemm-run binary ({exe.name}, built in {build_s:.2f} "
              f"s) --mode all: rc 0; {said['Fastest algorithm:'][0]}; "
              f"{said['MatNet pick:'][0]}", flush=True)
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
    rep = harness.run_benchmark(A4, A4, ("baseline", "bitonic", "csr",
                                         "dense_row"))
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

    # ---- 22-26. the distributed paths over shards of the card
    multiproc = _distributed_phases(A, H, ref_sum, by_run, reset_counts,
                                    counts, launched, same_pattern, time_ms,
                                    dev)

    # ---- 27. the selector's training path (harvest launch counts from 0)
    info27, samples27 = _training_phase(by_run, reset_counts, counts, dev)

    # ---- 28. the corpus driver (its workers' launches summed)
    _corpus_phase(by_run, kernel_names, info27, samples27, dev)

    # ---- 29. the acceptance run (launch counts from 0)
    _acceptance_phase(by_run, reset_counts, counts, launched, dev)

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
            "library_ms": st["library_ms"],
            **({"kernel_alone_ms": st["kernel_alone_ms"]}
               if "kernel_alone_ms" in st else {}),
            **({"across_processes": {
                "phase3": st["across_processes"], **{
                    run: {k: r[k] for k in (
                        "hop_ms", "plain_hop_ms", "kernel_us",
                        "bound_ms_hop", "ring_ms_median",
                        "ring_ms_plain_hop_median")}
                    for run, r in multiproc.items()}}}
               if name == "K13" else {})})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
