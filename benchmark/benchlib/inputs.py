"""A configuration's matrix for one seed, and the work it asks for.

The structure is the configuration's own: its family's generator at the
configuration's ``structure_seed``, so every run's seed gives the same
rows, the same width classes and the same work. The run's seed draws
the values (standard normal, one a stored entry). A seed that also drew
the structure changed the work: one seed in twelve of an earlier FEM
replica put six rows in a wider class and ran 6% faster.

The family's generator lands the published (m, n) exactly; duplicates
and the symmetric mirror move nnz, so the draw count is rescaled by the
measured ratio until nnz is within ``NNZ_TOLERANCE`` of the published.
"""

import numpy as np

NNZ_TOLERANCE = 0.002
BUILDS = 8


def structure(family, spec, seed):
    """The family's replica at `seed` (scipy CSR, float64), calibrated to
    the configuration's nnz."""
    scale = 1.0
    for _ in range(BUILDS):
        A = family.build(spec, seed, scale)
        if not A.nnz or abs(A.nnz - spec["nnz"]) <= NNZ_TOLERANCE * \
                spec["nnz"]:
            break
        scale *= spec["nnz"] / A.nnz
    return A


def generate(family, spec, seed):
    """The configuration's structure with values drawn from `seed`."""
    A = structure(family, spec, spec["structure_seed"])
    A.data = np.random.default_rng(seed).standard_normal(A.nnz)
    return A


def products(indptr, indices, b_indptr):
    """Intermediate products of A @ B from the inputs alone: the sum over
    A's entries of the length of the B row each one meets (the
    reference's GetFlop, main.cpp:989)."""
    b_len = np.diff(np.asarray(b_indptr, dtype=np.int64))
    return int(b_len[np.asarray(indices[:int(indptr[-1])],
                                dtype=np.int64)].sum())
