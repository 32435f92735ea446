"""SuiteSparse-style matrix sourcing (PyTorch port of
``ia_spgemm_tpu.io.suitesparse``; numpy and scipy only, so the
generators are the JAX package's, draw for draw).

The reference's workloads are UF/SuiteSparse matrices shipped in Inputs/
(9 tiny fixtures; README.md:10 "all tests default calculate the square of
A"). This module provides:
- a local-collection loader (a directory of .mtx files, by default the
  reference's ``Inputs`` directory relative to the working directory;
  nothing is fetched from a network),
- deterministic synthetic generators spanning the structure classes the
  MatNet features discriminate (banded, random-uniform, power-law rows,
  block-diagonal), and the named SuiteSparse structure replicas
  (``NAMED_SPECS``, ``gen_named``) at their published sizes, for the
  benchmark and the selector's training when no collection is mounted.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import scipy.sparse as sp

from ia_spgemm_tpu_torch.formats.types import DEFAULT_DEVICE

# the reference's fixture directory, as its binaries read it
REFERENCE_INPUTS = "Inputs"


def local_collection(path: str = REFERENCE_INPUTS) -> Dict[str, str]:
    """name -> .mtx path for every matrix in a local directory (empty
    when the directory is absent)."""
    if not os.path.isdir(path):
        return {}
    return {os.path.splitext(f)[0]: os.path.join(path, f)
            for f in sorted(os.listdir(path)) if f.endswith(".mtx")}


def fetch(name: str, collection_dir: str = REFERENCE_INPUTS,
          device=DEFAULT_DEVICE):
    """Load a matrix by name from a local collection as a CSR on
    `device` (the card unless device="cpu")."""
    from ia_spgemm_tpu_torch.io.mmio import read_mtx_to_csr
    coll = local_collection(collection_dir)
    if name not in coll:
        raise FileNotFoundError(
            f"{name!r} not in local collection {collection_dir} "
            "(nothing is fetched over a network: mount or generate)")
    return read_mtx_to_csr(coll[name], device=device)


# ---------------------------------------------------------------------------
# synthetic generators (deterministic)
# ---------------------------------------------------------------------------

def gen_banded(m: int, bandwidth: int = 3, seed: int = 0) -> sp.csr_matrix:
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(m) for _ in range(2 * bandwidth + 1)]
    return sp.diags(diags, list(range(-bandwidth, bandwidth + 1)),
                    shape=(m, m)).tocsr()


def gen_uniform(m: int, n: int | None = None, nnz_per_row: int = 8,
                seed: int = 0) -> sp.csr_matrix:
    n = n or m
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), nnz_per_row)
    cols = rng.integers(0, n, m * nnz_per_row)
    vals = rng.standard_normal(m * nnz_per_row)
    out = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    out.sum_duplicates()
    return out


def gen_powerlaw(m: int, mean_nnz: int = 8, alpha: float = 1.5,
                 seed: int = 0) -> sp.csr_matrix:
    """Skewed row lengths — the workload class the reference's CV feature
    exists for (csr/common_csr.h:276)."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, m) + 1.0
    lens = np.minimum((raw * mean_nnz / raw.mean()).astype(np.int64), m)
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, int(lens.sum()))
    vals = rng.standard_normal(int(lens.sum()))
    out = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    out.sum_duplicates()
    return out


def gen_blockdiag(m: int, block: int = 32, seed: int = 0) -> sp.csr_matrix:
    # a remainder block keeps the result exactly (m, m) — m // block
    # blocks alone silently shrank non-multiples (gen_blockdiag(100)
    # returned 96x96)
    sizes = [block] * (m // block)
    if m % block:
        sizes.append(m % block)
    blocks = [sp.random(s, s, density=0.4,
                        random_state=np.random.RandomState(seed + i),
                        format="csr") for i, s in enumerate(sizes)]
    return sp.block_diag(blocks, format="csr").tocsr()


GENERATORS = {
    "banded": gen_banded,
    "uniform": gen_uniform,
    "powerlaw": gen_powerlaw,
    "blockdiag": gen_blockdiag,
}


# ---------------------------------------------------------------------------
# named SuiteSparse structure replicas
# ---------------------------------------------------------------------------
# The reference evaluates on UF/SuiteSparse matrices (README.md:10; 9 tiny
# fixtures in Inputs/). Nothing here downloads a matrix, so the
# mid-size SpGEMM-paper standards are replicated as deterministic
# generators targeting each matrix's published structure statistics:
# exact (m, n), nnz within ~10%, and the structural family that drives
# algorithm choice (FEM block-band, grid stencil, irregular, power-law).
# Targets below are the SuiteSparse collection's published dimensions/nnz;
# family/CV/diag-fill targets are approximate (derived from the
# collection's spy plots and per-matrix notes, recorded a priori).
#
# spec fields: m, n, nnz (targets), family + family params, and optional
# row_cv (coefficient of variation of row lengths) / diag_fill (fraction
# of the main diagonal present) targets used by the replica tests.

NAMED_SPECS: Dict[str, dict] = {
    # FEM block-band family (symmetric, dof-per-node dense blocks)
    "cant":        dict(m=62451, n=62451, nnz=4007383, family="fem",
                        block=3, band_frac=0.02, row_cv=0.25, diag_fill=1.0),
    "consph":      dict(m=83334, n=83334, nnz=6010480, family="fem",
                        block=3, band_frac=0.03, row_cv=0.25, diag_fill=1.0),
    "hood":        dict(m=220542, n=220542, nnz=9895422, family="fem",
                        block=3, band_frac=0.01, row_cv=0.3, diag_fill=1.0),
    "pdb1HYS":     dict(m=36417, n=36417, nnz=4344765, family="fem",
                        block=3, band_frac=0.05, row_cv=0.35, diag_fill=1.0),
    "pwtk":        dict(m=217918, n=217918, nnz=11524432, family="fem",
                        block=3, band_frac=0.005, row_cv=0.2, diag_fill=1.0),
    "rma10":       dict(m=46835, n=46835, nnz=2329092, family="fem",
                        block=5, band_frac=0.02, row_cv=0.35, diag_fill=1.0),
    "shipsec1":    dict(m=140874, n=140874, nnz=3568176, family="fem",
                        block=3, band_frac=0.01, row_cv=0.3, diag_fill=1.0),
    "offshore":    dict(m=259789, n=259789, nnz=4242673, family="fem",
                        block=1, band_frac=0.02, row_cv=0.3, diag_fill=1.0),
    # grid stencils (near-constant row length, few scattered diagonals)
    "mc2depi":     dict(m=525825, n=525825, nnz=2100225, family="stencil",
                        offsets=(0, 1, -1, 725), fill=1.0,
                        row_cv=0.05, diag_fill=1.0),
    "majorbasis":  dict(m=160000, n=160000, nnz=1750416, family="stencil",
                        offsets=(0, 1, 2, 3, -1, -2, 400, 401, -400, -401,
                                 800), fill=1.0, row_cv=0.1, diag_fill=1.0),
    "mario002":    dict(m=389874, n=389874, nnz=2101242, family="stencil",
                        offsets=(0, 1, -1, 624, -624, 1248), fill=0.9,
                        row_cv=0.2, diag_fill=0.9),
    "filter3D":    dict(m=106437, n=106437, nnz=2707179, family="stencil",
                        offsets=(0, 1, -1, 2, -2, 47, -47, 48, -48, 2209,
                                 -2209, 2210, -2210, 2256, -2256, 2257,
                                 -2257, 46, 49, -46, -49, 2208, 2211,
                                 -2208, -2211), fill=1.0,
                        row_cv=0.15, diag_fill=1.0),
    # exact-k rows (simplicial boundary map: every row exactly 4)
    "m133-b3":     dict(m=200200, n=200200, nnz=800800, family="exactk",
                        k=4, row_cv=0.0, diag_fill=None),
    # irregular (moderate CV, mixed local/global columns)
    "cop20k_A":    dict(m=121192, n=121192, nnz=2624331, family="irregular",
                        row_cv=1.3, loc_frac=0.5, diag_fill=0.7),
    "mac_econ_fwd500": dict(m=206500, n=206500, nnz=1273389,
                            family="irregular", row_cv=1.0, loc_frac=0.3,
                            diag_fill=0.5),
    "poisson3Da":  dict(m=13514, n=13514, nnz=352762, family="irregular",
                        row_cv=0.3, loc_frac=0.8, diag_fill=1.0),
    "cage12":      dict(m=130228, n=130228, nnz=2032536, family="irregular",
                        row_cv=0.25, loc_frac=0.6, diag_fill=1.0),
    "2cubes_sphere": dict(m=101492, n=101492, nnz=1647264,
                          family="irregular", row_cv=0.3, loc_frac=0.7,
                          diag_fill=1.0),
    # power-law row lengths (circuits / web graphs)
    "scircuit":    dict(m=170998, n=170998, nnz=958936, family="powerlaw",
                        alpha=1.8, max_row=353, row_cv=2.0, diag_fill=1.0),
    "patents_main": dict(m=240547, n=240547, nnz=560943, family="powerlaw",
                         alpha=2.2, max_row=206, row_cv=1.5, diag_fill=0.0),
    "web-Google":  dict(m=916428, n=916428, nnz=5105039, family="powerlaw",
                        alpha=1.6, max_row=456, row_cv=1.6, diag_fill=0.0),
    "webbase-1M":  dict(m=1000005, n=1000005, nnz=3105536,
                        family="powerlaw", alpha=1.2, max_row=4700,
                        row_cv=4.0, diag_fill=0.6),
}


def _fem_replica(m, n, nnz, block, band_frac, seed, scale=1.0):
    """Symmetric FEM block-band: nodes couple to nearby nodes (gaussian
    offset window), every coupling is a dense block x block dof block."""
    rng = np.random.default_rng(seed)
    nodes = m // block
    # directed draws; symmetrization roughly doubles, dedup shrinks
    k = max(1, int(round(scale * nnz / (block * block) / nodes / 2.0)))
    sigma = max(2.0, band_frac * nodes / 2.0)
    offs = np.rint(rng.normal(0.0, sigma, size=(nodes, k))).astype(np.int64)
    # wrap (periodic band) rather than clip: clipping funnels every
    # out-of-range draw onto the two boundary nodes, creating hub rows
    # real FEM meshes don't have
    cols = np.mod(np.arange(nodes)[:, None] + offs, nodes).ravel()
    rows = np.repeat(np.arange(nodes), k)
    adj = sp.coo_matrix((np.ones(rows.size), (rows, cols)),
                        shape=(nodes, nodes)).tocsr()
    adj = adj + adj.T + sp.eye(nodes, format="csr")
    adj.data[:] = 1.0
    blk = np.ones((block, block))
    A = sp.kron(adj, blk, format="csr")
    if A.shape[0] < m:  # remainder rows: diagonal only
        A = sp.block_diag(
            [A, sp.eye(m - A.shape[0], format="csr")], format="csr")
    A = A.tocsr()
    A.data = rng.standard_normal(A.nnz)
    return A


def _stencil_replica(m, n, nnz, offsets, fill, seed, scale=1.0):
    """Grid stencil: scattered diagonals, optionally randomly thinned."""
    rng = np.random.default_rng(seed)
    fill_eff = min(1.0, fill * scale)
    diags, offs = [], []
    for off in offsets:
        ln = m - abs(off)
        if ln <= 0:
            continue
        d = rng.standard_normal(ln)
        if fill_eff < 1.0:
            d = d * (rng.random(ln) < fill_eff)
        diags.append(d)
        offs.append(off)
    A = sp.diags(diags, offs, shape=(m, n)).tocsr()
    A.eliminate_zeros()
    return A


def _exactk_replica(m, n, nnz, k, seed, scale=1.0):
    """Every row exactly k entries at random columns (boundary maps)."""
    rng = np.random.default_rng(seed)
    cols = np.empty((m, k), np.int64)
    for j in range(k):  # distinct columns per row via offset trick
        cols[:, j] = rng.integers(0, n - k, m) + j
    rows = np.repeat(np.arange(m), k)
    A = sp.coo_matrix((rng.standard_normal(m * k),
                       (rows, cols.ravel())), shape=(m, n)).tocsr()
    return A


def _irregular_replica(m, n, nnz, row_cv, loc_frac, diag_fill, seed,
                       scale=1.0):
    """Gamma-distributed row lengths, mixed local/global columns."""
    rng = np.random.default_rng(seed)
    mean = scale * nnz / m
    if row_cv and row_cv > 0:
        shape = 1.0 / (row_cv * row_cv)
        lens = rng.gamma(shape, mean / shape, m)
    else:
        lens = np.full(m, mean)
    lens = np.clip(np.rint(lens), 0, n).astype(np.int64)
    tot = int(lens.sum())
    rows = np.repeat(np.arange(m), lens)
    window = max(8, n // 64)
    local = rows + rng.integers(-window, window + 1, tot)
    glob = rng.integers(0, n, tot)
    cols = np.where(rng.random(tot) < loc_frac,
                    np.clip(local, 0, n - 1), glob)
    A = sp.coo_matrix((rng.standard_normal(tot), (rows, cols)),
                      shape=(m, n)).tocsr()
    A.sum_duplicates()
    if diag_fill:
        d = (rng.random(min(m, n)) < diag_fill).astype(np.float64)
        A = (A + sp.diags([d], [0], shape=(m, n))).tocsr()
    return A


def _powerlaw_replica(m, n, nnz, alpha, max_row, diag_fill, seed,
                      scale=1.0):
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, m) + 1.0
    lens = np.minimum(np.rint(raw * scale * nnz / m / raw.mean()),
                      max_row).astype(np.int64)
    tot = int(lens.sum())
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, n, tot)
    A = sp.coo_matrix((rng.standard_normal(tot), (rows, cols)),
                      shape=(m, n)).tocsr()
    A.sum_duplicates()
    if diag_fill:
        d = (rng.random(min(m, n)) < diag_fill).astype(np.float64)
        A = (A + sp.diags([d], [0], shape=(m, n))).tocsr()
    return A


def gen_named(name: str, seed: int = 0) -> sp.csr_matrix:
    """Deterministic replica of a named SuiteSparse matrix's structure.

    Hits the spec's (m, n) exactly and nnz within ~10% via a one-step
    calibration rebuild (duplicate collapse / symmetrization make the
    first build's nnz drift; the second build scales the draw count by
    the measured ratio)."""
    spec = NAMED_SPECS[name]
    fam = spec["family"]

    def build(scale):
        if fam == "fem":
            return _fem_replica(spec["m"], spec["n"], spec["nnz"],
                                spec["block"], spec["band_frac"], seed,
                                scale)
        if fam == "stencil":
            return _stencil_replica(spec["m"], spec["n"], spec["nnz"],
                                    spec["offsets"], spec["fill"], seed,
                                    scale)
        if fam == "exactk":
            return _exactk_replica(spec["m"], spec["n"], spec["nnz"],
                                   spec["k"], seed, scale)
        if fam == "irregular":
            return _irregular_replica(spec["m"], spec["n"], spec["nnz"],
                                      spec["row_cv"], spec["loc_frac"],
                                      spec.get("diag_fill"), seed, scale)
        if fam == "powerlaw":
            return _powerlaw_replica(spec["m"], spec["n"], spec["nnz"],
                                     spec["alpha"], spec["max_row"],
                                     spec.get("diag_fill"), seed, scale)
        raise ValueError(f"unknown family {fam!r}")

    A = build(1.0)
    if A.nnz and abs(A.nnz - spec["nnz"]) / spec["nnz"] > 0.05:
        A = build(spec["nnz"] / A.nnz)
    return A


def named_suite(names=None, seed: int = 0
                ) -> Iterator[Tuple[str, sp.csr_matrix]]:
    """Stream of (name, replica) over the named-structure corpus."""
    for name in (names or sorted(NAMED_SPECS)):
        yield name, gen_named(name, seed=seed)


def replica_stats(A: sp.csr_matrix) -> dict:
    """Structure statistics compared against NAMED_SPECS targets."""
    lens = np.diff(A.indptr)
    mean = float(lens.mean()) if A.shape[0] else 0.0
    cv = float(lens.std() / mean) if mean > 0 else 0.0
    k = min(A.shape)
    diag = A.diagonal()
    return {"m": A.shape[0], "n": A.shape[1], "nnz": int(A.nnz),
            "row_mean": mean, "row_cv": round(cv, 3),
            "row_max": int(lens.max(initial=0)),
            "diag_fill": round(float(np.count_nonzero(diag) / k), 3)}


def synthetic_entries(m: int = 256, seeds: Tuple[int, ...] = (0, 1, 2)
                      ) -> Iterator[Tuple[str, Callable[[], sp.csr_matrix]]]:
    """synthetic_suite's names, each with the call that builds its
    matrix, so the names can be listed without building anything."""
    for seed in seeds:
        yield f"banded_{m}_{seed}", functools.partial(
            gen_banded, m, bandwidth=2 + seed, seed=seed)
        yield f"uniform_{m}_{seed}", functools.partial(
            gen_uniform, m, nnz_per_row=6 + seed, seed=seed)
        yield f"powerlaw_{m}_{seed}", functools.partial(gen_powerlaw, m,
                                                        seed=seed)
        yield f"blockdiag_{m}_{seed}", functools.partial(gen_blockdiag, m,
                                                         seed=seed)


def synthetic_suite(m: int = 256, seeds: Tuple[int, ...] = (0, 1, 2)
                    ) -> Iterator[Tuple[str, sp.csr_matrix]]:
    """A labeled stream of structurally diverse matrices."""
    for name, build in synthetic_entries(m, seeds):
        yield name, build()
