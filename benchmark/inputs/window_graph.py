"""The window-graph family: a structurally symmetric graph whose edges
join nodes at most ``window`` apart, with a full diagonal.

Each node sends a number of edges drawn from a gamma law (mean set by
nnz, coefficient of variation ``stub_cv``, clipped to [1, ``stub_max``])
to nodes drawn uniformly within ``window`` of it; the pattern is the
union of those edges, their mirrors and the diagonal. ``stub_cv`` sets
the spread of the row lengths, hence the intermediate products of A @ A;
``window`` sets how much two-hop paths overlap, hence how many products
merge into one entry of C. ``spec`` is a configuration file's dict: m,
n, nnz, stub_cv, stub_max, window.
"""

import numpy as np
import scipy.sparse as sp


def build(spec, seed, scale=1.0):
    m, nnz = spec["m"], spec["nnz"]
    if m != spec["n"]:
        raise ValueError("a window graph is square")
    cv, window = spec["stub_cv"], spec["window"]
    rng = np.random.default_rng(seed)
    mean = scale * (nnz - m) / m / 2.0     # the mirror doubles, the diagonal
    shape = 1.0 / (cv * cv)
    stubs = np.clip(np.rint(rng.gamma(shape, mean / shape, m)), 1,
                    spec["stub_max"]).astype(np.int64)
    rows = np.repeat(np.arange(m), stubs)
    step = rng.integers(1, window + 1, rows.size)
    cols = np.clip(rows + step * rng.choice([-1, 1], rows.size), 0, m - 1)
    half = sp.coo_matrix((np.ones(rows.size), (rows, cols)), shape=(m, m))
    A = (half + half.T + sp.eye(m)).tocsr()
    A.sum_duplicates()
    A.data[:] = 1.0
    return A
