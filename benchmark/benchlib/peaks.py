"""Declared peaks of the card and the least time of a product.

The peaks are NVIDIA's H100 SXM data sheet figures at the full power
limit (dense rates outside the tensor cores): 3.35 TB/s of HBM3, 67
TFLOP/s float32, 34 TFLOP/s float64. A card set below its power limit
runs slower under load; the run prints the limit beside its numbers.

The least time counts only what the inputs need: A's and B's CSR arrays
read once each, C's CSR written once, 2 flops per intermediate product.
No plan enters it (padding, width classes, slabs), so a change to the
program cannot move it.
"""

PEAKS = {
    "h100_sxm": {"bytes_per_s": 3.35e12, "float32": 67e12, "float64": 34e12},
}


def chip(name):
    """The peaks' key for a card's name (``torch.cuda.get_device_name``);
    None for a card with no declared peaks here."""
    if "H100" in name and ("SXM" in name or "HBM3" in name):
        return "h100_sxm"
    return None


def csr_bytes(rows, nnz, value_bytes, index_bytes=4):
    """Bytes of a CSR matrix: the row pointer, the columns, the values."""
    return (rows + 1) * index_bytes + nnz * (index_bytes + value_bytes)


def least_work(rows_a, nnz_a, rows_b, nnz_b, rows_c, nnz_c, products,
               value_bytes):
    """(bytes, flops) that C = A @ B needs at the least."""
    nbytes = (csr_bytes(rows_a, nnz_a, value_bytes)
              + csr_bytes(rows_b, nnz_b, value_bytes)
              + csr_bytes(rows_c, nnz_c, value_bytes))
    return nbytes, 2 * products


def least_seconds(nbytes, flops, peaks, dtype):
    """(seconds, what bounds it) at the declared peaks."""
    t_mem = nbytes / peaks["bytes_per_s"]
    t_flop = flops / peaks[dtype]
    return (t_mem, "bytes") if t_mem >= t_flop else (t_flop, "flops")
