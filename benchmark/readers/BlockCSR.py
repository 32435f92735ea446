"""BlockCSR (the tiled route): row i owns the 128-slot blocks
[blk_ptr[i], blk_ptr[i+1]); its first nnz_row[i] slots are its entries,
the rest of its span is padding (column -1). Worked on the result's
device; only the valid entries cross to the host."""

import numpy as np
import torch

from benchlib.readout import Raw


def read(r):
    dev = r.col_blocks.device
    m, n = r.shape
    bp = r.blk_ptr.to(torch.int64)
    blocks = bp[1:] - bp[:-1]
    claimed = r.nnz_row.to(torch.int64)
    span = blocks * 128
    over = int(torch.clamp(claimed - span, min=0).sum())
    valid_n = torch.minimum(claimed, span)
    total = int(bp[-1])
    col = r.col_blocks[:total]
    row_of_block = torch.repeat_interleave(torch.arange(m, device=dev),
                                           blocks)
    # each slot's place within its row's span
    place = ((torch.arange(total, device=dev) - bp[:-1][row_of_block])
             * 128)[:, None] + torch.arange(128, device=dev)[None, :]
    valid = place < valid_n[row_of_block][:, None]
    del place, row_of_block
    bad_pad = int(((~valid) & (col != -1)).sum())
    cols = col[valid].to(torch.int64)
    del col
    bad_col = int(((cols < 0) | (cols >= n)).sum())
    vals = r.val_blocks[:total][valid].to(torch.float64)
    indptr = np.concatenate([[0], np.cumsum(valid_n.cpu().numpy())])
    return Raw(r.shape, indptr, cols.cpu().numpy(), vals.cpu().numpy(),
               over + bad_pad + bad_col)
