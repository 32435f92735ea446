"""128x128 density-representation images for MatNet (PyTorch port of
``ia_spgemm_tpu.ops.density``).

The reference's histogram (main.cpp:512-643): each stored entry (i, j)
of an m x n matrix adds one to the cell block

  rows [i*128//m, i*128//m + (128//m if m < 128 else 0)]   (inclusive)
  cols [j*128//n, j*128//n + (128//n if n < 128 else 0)]   (inclusive)

clipped at 128: one cell when the dimension is at least 128, a splat of
128//dim + 1 cells when it is smaller. Counts are int64 ('long long' in
the reference), computed with one ``bincount`` on the matrix's device;
the result equals the JAX package's with x64 on, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ia_spgemm_tpu_torch import config as cfg
from ia_spgemm_tpu_torch.formats.types import CSR


def _splat(dim: int, size: int) -> int:
    """Cells covered per entry along one axis (inclusive block length)."""
    return 1 if dim >= size else (size // dim) + 1


def density_image(A: CSR, size: int = cfg.DENSITY_IMAGE_SIZE) -> torch.Tensor:
    """(size, size) int64 histogram on A's device (main.cpp:512-643)."""
    from ia_spgemm_tpu_torch.formats.convert import _entry_rows
    m, n = A.shape
    dev = A.device
    nnz = int(A.nnz)
    row = _entry_rows(A.row_ptr, nnz).clamp(0, m - 1)
    col = A.col_ind[:nnz].long().clamp(0, n - 1)
    # integer cell mapping (main.cpp:527-558): floor(index * size / dim)
    i_s = row * size // m
    j_s = col * size // n
    di = torch.arange(_splat(m, size), device=dev)
    dj = torch.arange(_splat(n, size), device=dev)
    ii = i_s[:, None, None] + di[None, :, None]
    jj = j_s[:, None, None] + dj[None, None, :]
    ok = (ii < size) & (jj < size)
    flat = (ii * size + jj)[ok]
    return torch.bincount(flat, minlength=size * size).reshape(size, size)


def density_image_normalized(A: CSR, size: int = cfg.DENSITY_IMAGE_SIZE
                             ) -> torch.Tensor:
    """Scaled x255/max in float64, as MatNet.py does before inference
    (MatNet.py:31-37)."""
    img = density_image(A, size).to(torch.float64)
    mx = img.max()
    return img * 255.0 / torch.where(mx > 0, mx, torch.ones_like(mx))


def write_density_image(path: str, img) -> None:
    """One value per line, row-major: the imgs/img{1,2}.txt layout the
    reference's MatNet.py reads back (main.cpp:567-575)."""
    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    np.savetxt(path, np.asarray(img).reshape(-1), fmt="%d")


def read_density_image(path: str, size: int = cfg.DENSITY_IMAGE_SIZE):
    return np.loadtxt(path).reshape(size, size)
