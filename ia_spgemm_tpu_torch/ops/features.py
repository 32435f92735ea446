"""Feature extraction for MatNet, GetInfo1/2/3 (PyTorch port of
``ia_spgemm_tpu.ops.features``).

Layouts and formulas are the reference's, computed in float64 on the
operands' device:

- get_info1: 9 CSR statistics (csr/common_csr.h:257-287): rows, cols,
  nnz, density nnz/(m*n), max / min / mean nnz per row, the sample
  variance (over m - 1) and the coefficient of variation sd/mean (0 for
  an empty matrix).
- get_info2: 3 DIA statistics (dia/common_dia.h:222-233): num_diagonals,
  ndiag/(m+n-1), (ndiag*m)/(m*n).
- get_info3: 1 ELL statistic (ell/common_ell.h:222-229): nnz/(m*K).
- feature_vector: the CPU program's 26 features (main.cpp:651-679),
  info1(A), info1(B), info2(A), info2(B), info3(A), info3(B); the GPU
  weights read its first 18.
"""

from __future__ import annotations

import torch

from ia_spgemm_tpu_torch.formats.types import CSR, DIA, ELL

_F64 = torch.float64


def get_info1(A: CSR) -> torch.Tensor:
    """(9,) CSR features (reference csr/common_csr.h:257-287)."""
    m = A.row_ptr.shape[0] - 1
    nnz_row = (A.row_ptr[1:] - A.row_ptr[:-1]).to(_F64)
    nnzf = A.nnz.to(_F64)
    mean = nnzf / m
    # the reference divides by (rows - 1): the sample variance
    var = ((nnz_row - mean) ** 2).sum() / max(m - 1, 1)
    # an empty matrix has mean 0: cv is 0, not NaN
    cv = torch.where(mean > 0, var.sqrt() / mean, torch.zeros((), dtype=_F64,
                                                             device=A.device))
    # the density's denominator in float: an int32 m * n wraps at 2^32
    ncolsf = torch.tensor(float(A.ncols), dtype=_F64, device=A.device)
    return torch.stack([
        torch.tensor(float(m), dtype=_F64, device=A.device), ncolsf, nnzf,
        nnzf / (m * ncolsf), nnz_row.max(), nnz_row.min(), mean, var, cv])


def _info2_from_scalars(m: int, n: int, nd: int, device) -> torch.Tensor:
    return torch.tensor(
        [float(nd), nd / (m + n - 1), (nd * float(m)) / (float(m) * n)],
        dtype=_F64, device=device)


def _info3_from_scalars(m: int, K: int, nnz, device) -> torch.Tensor:
    return (torch.as_tensor(nnz, device=device).to(_F64)
            / (float(max(m, 1)) * max(int(K), 1))).reshape(1)


def get_info2(A: DIA) -> torch.Tensor:
    """(3,) DIA features (reference dia/common_dia.h:222-233)."""
    m, n = A.shape
    nd = float(A.num_diagonals)
    return torch.tensor([nd, nd / (m + n - 1), (nd * m) / (m * n)],
                        dtype=_F64, device=A.device)


def get_info3(A: ELL) -> torch.Tensor:
    """(1,) ELL fill feature (reference ell/common_ell.h:222-229)."""
    m, _ = A.shape
    return (A.nnz.to(_F64)
            / (float(m) * max(int(A.max_nnz_per_row), 1))).reshape(1)


def feature_vector(A: CSR, B: CSR,
                   A_dia: DIA | None = None, B_dia: DIA | None = None,
                   A_ell: ELL | None = None, B_ell: ELL | None = None
                   ) -> torch.Tensor:
    """The CPU program's 26-feature MatNet input (main.cpp:651-679),
    float64 on A's device.

    A format rejected by its viability guard leaves its slots 0. Without
    a converted DIA/ELL the features come from the planner scalars
    (number of diagonals, K) alone; a matrix with no occupied diagonal
    counts as one empty diagonal, as csr_to_dia coerces it after its
    guard."""
    from ia_spgemm_tpu_torch.formats import convert

    dev = A.device

    def info2(M, M_dia):
        if M_dia is not None:
            return get_info2(M_dia)
        nd = len(convert.plan_dia_offsets(M))
        if not convert.dia_viable(M.nrows, M.ncols, int(M.nnz), nd):
            return torch.zeros(3, dtype=_F64, device=dev)
        return _info2_from_scalars(M.nrows, M.ncols, max(nd, 1), dev)

    def info3(M, M_ell):
        if M_ell is not None:
            return get_info3(M_ell)
        K = convert.plan_ell_width(M)
        if not convert.ell_viable(M.nrows, int(M.nnz), K):
            return torch.zeros(1, dtype=_F64, device=dev)
        return _info3_from_scalars(M.nrows, K, M.nnz, dev)

    parts = [get_info1(A), get_info1(B), info2(A, A_dia), info2(B, B_dia),
             info3(A, A_ell), info3(B, B_ell)]
    return torch.cat([p.to(device=dev, dtype=_F64) for p in parts])
