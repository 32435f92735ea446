"""The plain reference for C = A @ A and the comparison that decides a
run's ``correct``.

The reference works from the inputs' CSR arrays alone (what the
benchmark made from the seed), never from anything the program made. It
is a straightforward expand-sort-sum in plain torch: every intermediate
product (i, k, j) is formed, the products are grouped by (i, j), and
each group is summed; in float64, on the card once the program's state
is freed (or on the CPU), in blocks of rows. Beside each entry's value it
sums its products' magnitudes (its scale). Its pattern is structural:
every (i, j) that has a product is an entry, whatever its sum.

A result is judged by three numbers:

- ``nnz_gap``: |the nnz the program reports - the structural nnz|;
- ``pattern_gap``: entries out of order or repeated in the result as
  it stored them (``benchlib/readout.py``), plus entries in one pattern
  and not the other, or the count of the result's format faults;
- ``max_rel_err``: the largest |C - reference| / scale over the entries,
  where the patterns agree (none otherwise). Rounding in the value type
  with every product rounded once and every sum in that type keeps it
  near (products per entry) x the unit round-off; it is free of the
  matrix's magnitudes.

The control is the same computation in a lower precision (``dtype``),
put in the program's place.
"""

import numpy as np


class Reference:
    """C = A @ A of one input: its structural pattern as a sorted CSR
    (indptr, indices), each entry's value and, from the float64
    reference, its scale."""

    def __init__(self, shape, indptr, indices, value, scale):
        self.shape, self.indptr, self.indices = shape, indptr, indices
        self.value, self.scale = value, scale

    @property
    def nnz(self):
        return int(self.indices.size)

    def raw(self):
        """This result in the form a program's is judged in."""
        from benchlib.readout import Raw
        return Raw(self.shape, self.indptr, self.indices, self.value)


def _blocks(row_products, target):
    """Row bounds [0, ..., m] of blocks of about `target` products."""
    csum = np.cumsum(row_products)
    bounds = [0]
    while bounds[-1] < len(row_products):
        base = csum[bounds[-1] - 1] if bounds[-1] else 0
        r = int(np.searchsorted(csum, base + target, side="right"))
        bounds.append(max(r, bounds[-1] + 1))
    return bounds


def square(indptr, indices, data, shape, dtype=None, device="cpu",
           block_products=1 << 26):
    """C = A @ A from A's CSR arrays, every product and every sum in
    `dtype` (a torch dtype; float64 by default: the reference), on
    `device`. The values are A's, used exactly (cast to `dtype`)."""
    import torch
    dtype = torch.float64 if dtype is None else dtype
    m, n = shape
    nnz = int(indptr[-1])
    indptr = np.asarray(indptr, dtype=np.int64)
    ip = torch.as_tensor(indptr, device=device)
    ix = torch.as_tensor(np.asarray(indices[:nnz], dtype=np.int64),
                         device=device)
    vals = torch.as_tensor(np.asarray(data[:nnz])).to(device)
    v = vals.to(dtype)
    mag = vals.to(torch.float64).abs()
    b_len = (ip[1:] - ip[:-1])[ix]                   # per entry of A
    ent_csum = np.concatenate([[0], np.cumsum(b_len.cpu().numpy())])
    keys_out, val_out, scale_out = [], [], []
    bounds = _blocks(np.diff(ent_csum[indptr]), block_products)
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        lens = b_len[e0:e1]
        e = torch.repeat_interleave(torch.arange(e0, e1, device=device),
                                    lens)
        if e.numel() == 0:
            continue
        first = torch.cumsum(lens, 0) - lens
        bpos = ip[ix[e]] + torch.arange(e.numel(), device=device) \
            - torch.repeat_interleave(first, lens)
        rows = torch.repeat_interleave(torch.arange(r0, r1, device=device),
                                       ip[r0 + 1:r1 + 1] - ip[r0:r1])
        key = rows[e - e0] * n + ix[bpos]
        uk, inv = torch.unique(key, sorted=True, return_inverse=True)
        del key
        sums = torch.zeros(uk.numel(), dtype=dtype, device=device)
        sums.index_add_(0, inv, v[e] * v[bpos])
        scale = torch.zeros(uk.numel(), dtype=torch.float64, device=device)
        scale.index_add_(0, inv, mag[e] * mag[bpos])
        keys_out.append(uk.cpu().numpy())
        val_out.append(sums.to(torch.float64).cpu().numpy())
        scale_out.append(scale.cpu().numpy())
        del e, bpos, rows, uk, inv, sums, scale
    keys = np.concatenate(keys_out) if keys_out else np.zeros(0, np.int64)
    rows = keys // n
    return Reference(
        shape, np.searchsorted(rows, np.arange(m + 1)).astype(np.int64),
        (keys - rows * n).astype(np.int32),
        np.concatenate(val_out) if val_out else np.zeros(0),
        np.concatenate(scale_out) if scale_out else np.zeros(0))


def _keys(indptr, indices, n):
    """row * n + col of a CSR's entries in storage order."""
    indptr = np.asarray(indptr, dtype=np.int64)
    rows = np.repeat(np.arange(indptr.size - 1, dtype=np.int64),
                     np.diff(indptr))
    return rows * n + np.asarray(indices[:int(indptr[-1])], dtype=np.int64)


def compare(raw, reported_nnz, ref):
    """The three numbers of one result, read in storage order
    (``benchlib/readout.Raw``), against the reference."""
    out = {"nnz_gap": abs(int(reported_nnz) - ref.nnz)}
    consistent = (raw.indptr.size == ref.shape[0] + 1 and raw.indptr[0] == 0
                  and raw.indptr[-1] == raw.indices.size
                  and np.all(np.diff(raw.indptr) >= 0))
    if (tuple(raw.shape) != tuple(ref.shape) or not consistent
            or raw.format_gap):
        out.update(pattern_gap=max(1, raw.format_gap), max_rel_err=None)
        return out
    if not (np.array_equal(raw.indptr, ref.indptr)
            and np.array_equal(raw.indices, ref.indices)):
        n = ref.shape[1]
        k = _keys(raw.indptr, raw.indices, n)
        disorder = int(np.count_nonzero(k[1:] <= k[:-1]))
        out.update(pattern_gap=disorder + int(np.setxor1d(
            np.unique(k), _keys(ref.indptr, ref.indices, n),
            assume_unique=True).size), max_rel_err=None)
        if out["pattern_gap"]:
            return out
    out["pattern_gap"] = 0
    scale = np.where(ref.scale > 0, ref.scale, 1.0)
    err = np.abs(raw.data - ref.value) / scale
    out["max_rel_err"] = float(err.max()) if err.size else 0.0
    return out


def judge(numbers, limits):
    """True when every number is present, finite and within its limit."""
    return all(numbers.get(k) is not None and np.isfinite(numbers[k])
               and numbers[k] <= lim for k, lim in limits.items())
