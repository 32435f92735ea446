"""HybridCSR (the slab + global hybrid route): the light rows in a SlabCSR,
the heavy rows in a CSR, the two over disjoint rows.

The light part: slab s holds its entries in its first nnz_slab[s] slots,
key (row - slab_first_row[s]) * n + col, so row = slab_first_row[s] +
key // n and col = key % n; every later slot is padding (key -1). Its
entries are read slab by slab, slot by slot, on the result's device;
only the valid ones cross to the host. The heavy part is read as
``readers/CSR.py`` reads a CSR. The two are merged by row in storage
order, a row's light entries and then its heavy ones: nothing sorted,
nothing summed.

Format faults: a slab claiming more slots than it has, a padding key
other than -1, a valid key below 0, a row out of range, a row that goes
backwards in the light entries' storage order, a row holding entries in
both parts, and the heavy CSR's own.
"""

from pathlib import Path

import numpy as np
import torch

from benchlib import spec
from benchlib.readout import Raw

_csr = spec.load_module(Path(__file__).with_name("CSR.py"), "bench_reader")


def _light(s, m, n):
    """(rows, cols, values) of a SlabCSR's valid slots in storage order,
    and the count of its format faults."""
    dev = s.keys.device
    S, W = s.keys.shape
    claimed = s.nnz_slab.to(torch.int64)
    over = int(torch.clamp(claimed - W, min=0).sum())
    valid = torch.arange(W, device=dev)[None, :] < claimed[:, None]
    bad_pad = int(((~valid) & (s.keys != -1)).sum())
    keys = s.keys[valid].to(torch.int64)
    first = s.slab_first_row.to(torch.int64)
    slab = torch.arange(S, device=dev)[:, None].expand(S, W)[valid]
    rows = first[slab] + torch.div(keys, n, rounding_mode="floor")
    cols = keys - torch.div(keys, n, rounding_mode="floor") * n
    vals = s.values[valid].to(torch.float64)
    if getattr(s, "values_lo", None) is not None:
        vals += s.values_lo[valid].to(torch.float64)
    bad_key = int((keys < 0).sum())
    bad_row = int(((rows < 0) | (rows >= m)).sum())
    backwards = int((rows[1:] < rows[:-1]).sum())
    return (rows.cpu().numpy(), cols.cpu().numpy(), vals.cpu().numpy(),
            over + bad_pad + bad_key + bad_row + backwards)


def read(r):
    m, n = r.shape
    rows, cols, vals, gap = _light(r.light, m, n)
    heavy = _csr.read(r.heavy)
    gap += heavy.format_gap
    n_heavy = np.diff(heavy.indptr)
    if (heavy.indptr.size != m + 1 or heavy.indptr[0] != 0
            or heavy.indptr[-1] != heavy.indices.size
            or np.any(n_heavy < 0)):
        return Raw(r.shape, np.zeros(m + 1), [], [], gap + 1)
    keep = (rows >= 0) & (rows < m)
    order = np.argsort(rows[keep], kind="stable")  # the identity unless
    rows, cols, vals = rows[keep][order], cols[keep][order], \
        vals[keep][order]                          # a row went backwards
    n_light = np.bincount(rows, minlength=m)
    gap += int(np.count_nonzero((n_light > 0) & (n_heavy > 0)))
    indptr = np.concatenate([[0], np.cumsum(n_light + n_heavy)])
    light_ptr = np.concatenate([[0], np.cumsum(n_light)])
    total = int(indptr[-1])
    indices = np.empty(total, np.int64)
    data = np.empty(total, np.float64)
    # a row's light entries first, then its heavy ones
    at = indptr[rows] + np.arange(rows.size) - light_ptr[rows]
    indices[at], data[at] = cols, vals
    h_rows = np.repeat(np.arange(m), n_heavy)
    at = indptr[h_rows] + n_light[h_rows] + np.arange(h_rows.size) \
        - heavy.indptr[h_rows]
    indices[at], data[at] = heavy.indices, heavy.data
    return Raw(r.shape, indptr, indices, data, gap)
