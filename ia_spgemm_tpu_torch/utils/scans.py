"""Segmented-broadcast primitives (PyTorch port of
``ia_spgemm_tpu.utils.scans``): "which segment covers position e" as one
scatter-max plus one cumulative max, on the operands' device."""

from __future__ import annotations

import torch


def segment_broadcast(values: torch.Tensor, starts: torch.Tensor, active,
                      out_size: int, fill) -> torch.Tensor:
    """out[e] = values[t] for the active segment t covering position e.

    starts[t] = first covered position of segment t, strictly increasing
    over active segments; `active` masks zero-length segments. `values`
    must be non-decreasing over active segments (cummax propagation).
    Positions before the first active segment get `fill`."""
    # positions past the end land in a dropped slot, as JAX's scatter
    # drops them
    pos = torch.where(active, starts.long(), out_size).clamp(max=out_size)
    mark = torch.full((out_size + 1,), fill, dtype=values.dtype,
                      device=values.device)
    mark.scatter_reduce_(0, pos, values, "amax")
    return torch.cummax(mark[:out_size], 0).values


def entry_rows(row_ptr: torch.Tensor, capacity: int) -> torch.Tensor:
    """Row index (int32) of each stored CSR entry; positions past nnz get
    the last nonempty row (callers mask)."""
    m = row_ptr.shape[0] - 1
    rows = torch.arange(m, dtype=torch.int32, device=row_ptr.device)
    return segment_broadcast(rows, row_ptr[:-1], row_ptr[1:] > row_ptr[:-1],
                             capacity, 0)
