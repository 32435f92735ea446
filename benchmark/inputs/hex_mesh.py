"""The hex-mesh family: the stiffness pattern of a structured mesh of
hexahedral elements with ``dof`` degrees of freedom a node.

Nodes lie on a ``grid`` (nx, ny, nz); each is coupled to the nodes of
the elements around it (its 27-point neighbourhood, fewer on the
boundary), and every coupling is a dense dof x dof block. A real
stiffness matrix stores no entry that is zero by the geometry, so the
off-diagonal entries are kept symmetrically at random, at the rate that
lands the published nnz; the diagonal is always kept. ``spec`` is a
configuration file's dict: m, n, nnz, grid, dof.
"""

import numpy as np
import scipy.sparse as sp


def _path(length):
    """A node line's own coupling: each node with itself and its two
    neighbours."""
    one = np.ones(length)
    return sp.diags([one[1:], one, one[1:]], [-1, 0, 1], format="csr")


def build(spec, seed, scale=1.0):
    nx, ny, nz = spec["grid"]
    dof = spec["dof"]
    m = nx * ny * nz * dof
    if (m, m) != (spec["m"], spec["n"]):
        raise ValueError(f"grid {spec['grid']} x {dof} dof gives {m} rows, "
                         f"not {spec['m']} x {spec['n']}")
    nodes = sp.kron(sp.kron(_path(nz), _path(ny)), _path(nx), format="csr")
    upper = sp.triu(sp.kron(nodes, np.ones((dof, dof)), format="csr"), k=1,
                    format="coo")
    rng = np.random.default_rng(seed)
    keep = rng.random(upper.nnz) < scale * (spec["nnz"] - m) / (2 * upper.nnz)
    r, c = upper.row[keep], upper.col[keep]
    half = sp.coo_matrix((np.ones(r.size), (r, c)), shape=(m, m))
    A = (half + half.T + sp.eye(m)).tocsr()
    A.sort_indices()
    return A
