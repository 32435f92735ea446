"""CSR (the global route): row i's entries are [row_ptr[i],
row_ptr[i+1]) of the first nnz slots; a compensated result's value is
its hi + lo."""

import numpy as np

from benchlib.readout import Raw


def read(r):
    n = r.shape[1]
    nnz = int(r.nnz)
    indptr = r.row_ptr.cpu().numpy().astype(np.int64)
    cols = r.col_ind[:nnz].cpu().numpy().astype(np.int64)
    vals = r.values[:nnz].cpu().numpy().astype(np.float64)
    if getattr(r, "values_lo", None) is not None:
        vals += r.values_lo[:nnz].cpu().numpy().astype(np.float64)
    gap = int(indptr[-1] != nnz) + int(np.count_nonzero(np.diff(indptr) < 0))
    gap += int(np.count_nonzero((cols < 0) | (cols >= n)))
    return Raw(r.shape, indptr, cols, vals, gap)
