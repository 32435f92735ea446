"""Shared helpers of the PyTorch port's tests: the same scipy matrix into
both packages, kernel inputs, and the comparisons with their tolerances.

Importing this module imports no jax (``jell`` and ``jax_call_state``
reach the JAX package only when called), so the card-only tests can use
it on a machine without jax.

Tolerances: output structure (block pointers, row counts, columns) must
be identical; values agree within 1e-5 * max(1, max|C|), because
duplicate products are summed in another order (the port's plain
versions sum in slot order after a stable sort, its kernels and the JAX
kernels after an unstable network); float64 values within 1e-12 *
max(1, max|C|) (F64_RTOL); against the scipy oracle the JAX package's
own 1e-4 (tests/test_bitonic.py)."""

import numpy as np
import scipy.sparse as sp
import torch

from ia_spgemm_tpu_torch.formats import convert as tconvert
from ia_spgemm_tpu_torch.formats.types import CSR as TCSR
from ia_spgemm_tpu_torch.ops import bitonic as tbt

VALUE_RTOL = 1e-5
F64_RTOL = 1e-12
ORACLE_TOL = 1e-4
RUN = 8   # sub-run length of the kernel inputs below


def jell(a, dtype=np.float32):
    """JAX-package ELL of a scipy matrix, float32 by default as the
    ragged paths need (tests/conftest.py turns x64 on, so float64 stays
    float64)."""
    from ia_spgemm_tpu.formats import convert as jconvert
    from ia_spgemm_tpu.formats.types import CSR as JCSR
    return jconvert.csr_to_ell(JCSR.from_scipy(a.astype(dtype)),
                               check_guard=False)


def tell(a, device="cpu", dtype=np.float32):
    return tconvert.csr_to_ell(TCSR.from_scipy(a.astype(dtype),
                                               device=device),
                               check_guard=False)


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want, msg=""):
    np.testing.assert_array_equal(host(got), host(want), err_msg=msg)


def value_rtol(x):
    """The values' tolerance for x's type: F64_RTOL for float64,
    VALUE_RTOL otherwise."""
    return F64_RTOL if host(x).dtype == np.float64 else VALUE_RTOL


def assert_values_close(got, want, msg="", rtol=VALUE_RTOL):
    got, want = host(got), host(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if not want.size:
        return
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rtol * scale, (msg, err, scale)


def assert_kernel_outputs_match(got, want, rtol=VALUE_RTOL):
    """(col, val, nnz) triples: structure exact, values within rtol."""
    (c1, v1, n1), (c2, v2, n2) = got, want
    assert_same(n1, n2, "nnz")
    assert_same(c1, c2, "col")
    assert_values_close(v1, v2, "val", rtol)


def check_oracle(a, b, C):
    want = (a.astype(np.float64) @ b.astype(np.float64)).tocsr()
    d = abs(C.to_scipy() - want)
    err = d.max() if d.nnz else 0.0
    assert err < ORACLE_TOL * max(1.0, abs(want).max()), err
    assert int(C.nnz) == want.nnz


def jax_call_state(call):
    """The arrays a JAX multiclass_planned callable closes over (idxs,
    extra = per-class fragments + AVT [+ src_full, blk_ptr] + table)."""
    return dict(zip(call.__code__.co_freevars,
                    (c.cell_contents for c in call.__closure__)))


def kernel_operands(ka, m, seed):
    """Port ELLs of A (m x 300; up to `ka` entries per row, every 9th row
    empty) and B (300 x 300; 0..RUN entries per row, sorted columns)."""
    rng = np.random.default_rng(seed)
    lens_a = rng.integers(ka // 2, ka + 1, m)
    lens_a[::9] = 0
    lens_a[1] = ka
    lens_b = rng.integers(0, RUN + 1, 300)

    def mat(lens, n):
        rows = np.repeat(np.arange(len(lens)), lens)
        cols = np.concatenate([rng.choice(n, size=k, replace=False)
                               for k in lens])
        return sp.csr_matrix((rng.standard_normal(len(rows)),
                              (rows, cols)), shape=(len(lens), n))

    return tell(mat(lens_a, 300)), tell(mat(lens_b, 300))


def gather_inputs(ka, m=200, seed=0):
    """The flat route's fragment gather: g (ka, m, 128), avT (ka, m) and
    the width, with NaN A values on the empty rows (the kernels must mask
    them by column, never by multiply)."""
    A, B = kernel_operands(ka, m, seed)
    plan = tbt.plan_bitonic(A, B)
    assert plan.run == RUN and plan.chunks == 1
    g, avT = tbt._expand_gather_emajor(A.col_ind, A.values, B.col_ind,
                                       B.values, run=RUN)
    avT[:, ::9] = float("nan")
    return g, avT, plan.width


def cols_inputs(ka, dtype, m=200, seed=0):
    """The cols layout's pre-expanded rows (torch _expand_ell) of
    kernel_operands in `dtype`, with four padded class rows appended
    (column INT32_MIN, NaN A value; they must come out empty): (key, val,
    width)."""
    A, B = kernel_operands(ka, m, seed)
    width = tbt.plan_bitonic(A, B).width
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    idx = torch.cat([torch.arange(m), torch.full((4,), m)])
    key, val = tbt._expand_ell(
        tbt._take_rows(A.col_ind, idx),
        tbt._take_rows(A.values.to(tdt), idx), B.col_ind,
        B.values.to(tdt), width=width, run=RUN)
    return key, val, width


def pack_fragments(g, pack):
    """Lane-pack `pack` fragments per 128-lane row, as the plan-time
    pregather does (ia_spgemm_tpu/ops/bitonic.py:2230-2238)."""
    if pack == 1:
        return g
    F, m, _ = g.shape
    used = 4 * RUN
    Fp = -(-F // pack) * pack
    gp = torch.full((Fp, m, used), -1, dtype=torch.int32, device=g.device)
    gp[:F] = g[:, :, :used]
    return (gp.reshape(Fp // pack, pack, m, used).permute(0, 2, 1, 3)
            .reshape(Fp // pack, m, pack * used).contiguous())


# (fragments per row -> width, pack, out_width): K1's classes with lane
# packing and output caps; 512 and 1024 are the split-pipeline widths
GATHER_CASES = [(16, 1, None), (16, 4, None), (32, 4, None), (32, 4, 128),
                (64, 1, None), (128, 1, None), (128, 1, 256)]

DD_RTOL = 1e-12   # compensated values against float64, relative to max|C|


def ill_conditioned(m=96, k=6, seed=11):
    """Rows of +/-big pairs with tiny residuals, float32 (a jax-free copy
    of tests/test_slab_dd.py's _ill_conditioned): float32 accumulation
    loses ~6 digits, a float64 oracle on these float32 inputs is exact."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(m):
        ks = rng.choice(m, size=k, replace=False)
        big = rng.standard_normal() * 1e4
        for t, c in enumerate(ks):
            rows.append(r)
            cols.append(int(c))
            vals.append(big if t % 2 == 0
                        else -big + rng.standard_normal())
    a = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr()
    return a.astype(np.float32)


def slab_operands(a, b=None, *, width=None, run=None):
    """The port's slab plan of C = a @ b (b = a by default, float32) and
    the kernels' inputs at the plan's shapes: (plan, g, avT, lrT, kw)."""
    from ia_spgemm_tpu_torch.ops import slab
    A = TCSR.from_scipy(a.astype(np.float32))
    B = A if b is None else TCSR.from_scipy(b.astype(np.float32))
    p = slab._plan_slab_csr_uncached(A, B, width=width, run=run).plan
    F_c = p.width // p.run
    g = p.table[p.mt.reshape(-1).long()].reshape(F_c, p.n_slabs,
                                                 p.table.shape[1])
    kw = dict(ka=F_c, run=p.run, width=p.width, n=p.n, start_kk=2 * p.run)
    return p, g, p.avt, p.lrt, kw


def assert_dd_outputs_match(got, want):
    """(col, hi, lo, nnz) quadruples: structure exact, hi + lo within
    DD_RTOL * max(1, max|C|) in float64."""
    (c1, h1, l1, n1), (c2, h2, l2, n2) = got, want
    assert_same(n1, n2, "nnz")
    assert_same(c1, c2, "col")
    v1 = host(h1).astype(np.float64) + host(l1)
    v2 = host(h2).astype(np.float64) + host(l2)
    if v2.size:
        scale = max(1.0, float(np.abs(v2).max()))
        err = float(np.abs(v1 - v2).max())
        assert err <= DD_RTOL * scale, (err, scale)


def ell_pair(m, k, n, density, seed, device="cpu"):
    """Port ELLs of random float32 A (m x k) and B (k x n), and the scipy
    matrices."""
    rng = np.random.default_rng(seed)

    def mat(r, c):
        nnz = max(1, int(r * c * density))
        a = sp.coo_matrix((rng.standard_normal(nnz),
                           (rng.integers(0, r, nnz), rng.integers(0, c, nnz))),
                          shape=(r, c)).tocsr()
        a.sum_duplicates()
        return a.astype(np.float32)

    a, b = mat(m, k), mat(k, n)
    return tell(a, device), tell(b, device), a, b


def table_csr(col, val, nnz, shape):
    """A hash route's (col, val, nnz) tables as scipy CSR (sorted
    columns, explicit zeros kept), through compact_ell."""
    from ia_spgemm_tpu_torch.formats.types import ELL
    E = tconvert.compact_ell(ELL(col_ind=col, values=val,
                                 nnz_row=nnz.reshape(-1),
                                 nnz=nnz.sum(dtype=torch.int32),
                                 shape=shape))
    c = E.to_scipy()
    c.sort_indices()
    return c


def assert_tables_match(got, want, shape):
    """Hash tables: nnz per row exact, each row's set of columns exact,
    values within tolerance; slot order not compared."""
    assert_same(got[2].reshape(-1), want[2].reshape(-1), "nnz")
    g, w = table_csr(*got, shape), table_csr(*want, shape)
    assert_same(g.indptr, w.indptr, "indptr")
    assert_same(g.indices, w.indices, "indices")
    assert_values_close(g.data, w.data, "values")
