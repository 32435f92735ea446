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
from ia_spgemm_tpu_torch.ops import bitonic_kernels as TK

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


def table_inputs(ka, m=200, seed=0):
    """The flat route's table source: the wide B table (kt + 1, 128),
    the fragment index rT (ka, m) int32, avT (ka, m) and the width, with
    NaN A values on the empty rows (the kernels must mask them by column,
    never by multiply)."""
    A, B = kernel_operands(ka, m, seed)
    plan = tbt.plan_bitonic(A, B)
    assert plan.run == RUN and plan.chunks == 1
    table, rT, avT = tbt._flat_table(A.col_ind, A.values, B.col_ind,
                                     B.values, run=RUN)
    avT[:, ::9] = float("nan")
    return table, rT, avT, plan.width


def gather_inputs(ka, m=200, seed=0):
    """The flat route's fragment gather g = table[rT] (ka, m, 128) of
    table_inputs, avT (ka, m) and the width."""
    table, rT, avT, width = table_inputs(ka, m, seed)
    return TK.table_gather(table, rT), avT, width


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

# K1's fragment runs: every power of two the planner may choose
# (ops/bitonic.py plan_bitonic_dims), at every width the wrapper takes
GATHER_RUNS = [1, 2, 4, 8, 16, 32]


def fragment_gather(m, ka, run, pack=1, *, kind="random", seed=0,
                    lanes=None):
    """A fragment gather in K1's input layout, built with numpy: g
    (ceil(ka / pack), m, lanes) int32 (lanes at least 128 and pack * 4 *
    run) and avT (ka, m) float32. Fragment e of a row holds up to `run`
    sorted columns (forward run: columns then -1; the reversed half the
    same run backwards) in packed row e // pack at lane offset (e % pack)
    * 4 * run, as ops/bitonic.py's pregather lays them out. kind: "random"
    (fragments of 0..run columns drawn from few, so rows hold duplicate
    runs), "one_key" (every slot column 5: one run over the whole row),
    "sentinel" (no column at all), "mixed" (a row each of the three). A
    fragment without columns gets a NaN A value, as a padded class row
    does: a kernel must select it away, never multiply it by a mask."""
    rng = np.random.default_rng(seed)
    lanes = max(128, pack * 4 * run) if lanes is None else lanes
    ncols = max(4, ka * run // 3)
    cols = np.sort(rng.integers(0, ncols, (ka, m, run)), axis=2)
    n = rng.integers(0, run + 1, (ka, m))
    if kind in ("one_key", "mixed"):
        one = slice(None) if kind == "one_key" else slice(1, None, 3)
        cols[:, one] = 5
        n[:, one] = run
    if kind in ("sentinel", "mixed"):
        n[:, slice(None) if kind == "sentinel" else slice(2, None, 3)] = 0
    cols = np.where(np.arange(run) < n[:, :, None], cols, -1)
    vals = rng.standard_normal((ka, m, run)).astype(np.float32)
    avT = rng.standard_normal((ka, m)).astype(np.float32)
    avT[n == 0] = np.nan
    g = np.full((-(-ka // pack), m, lanes), -1, np.int32)
    for e in range(ka):
        off = (e % pack) * 4 * run
        blk = g[e // pack, :, off:off + 4 * run]
        blk[:, :run] = cols[e]
        blk[:, run:2 * run] = vals[e].view(np.int32)
        blk[:, 2 * run:3 * run] = cols[e][:, ::-1]
        blk[:, 3 * run:] = vals[e][:, ::-1].view(np.int32)
    return torch.from_numpy(g), torch.from_numpy(avT)


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
    the kernels' inputs at the plan's shapes: (plan, (table, mt, avT,
    lrT), kw)."""
    from ia_spgemm_tpu_torch.bench import kernels as KB
    from ia_spgemm_tpu_torch.ops import slab
    A = TCSR.from_scipy(a.astype(np.float32), device="cpu")
    B = A if b is None else TCSR.from_scipy(b.astype(np.float32), device="cpu")
    p = slab._plan_slab_csr_uncached(A, B, width=width, run=run).plan
    return (p, *KB.slab_operands(p))


INT32_MAX = 2**31 - 1


def slab_fragments(S, ka, run, *, rspan=64, kind="random", pad_slabs=2,
                   seed=0):
    """K8's and K9's operands built with numpy, in the slab engine's
    layout: (table (F_B + 1, lanes) int32, mt, avT, lrT (ka, S), n).
    Table row f holds up to `run` sorted distinct columns of one B
    sub-run (forward: columns then -1; the reversed half the same run
    backwards) and their value bits; row F_B is all -1, the fill row.
    Each slab uses its first few fragment slots (the rest read the fill
    row, as a slab's tail does), a few more slots read the fill row in
    between, and the last ``pad_slabs`` slabs read only the fill row (the
    padding up to S). Fill-row slots carry NaN A values and junk local
    rows (up to 2^31 - 1), which a kernel must select away. Local rows
    lie below rspan, n = (2^31 - 1) // rspan, and each slab's last used
    slot reads row 0 (which holds column n - 1) at local row rspan - 1,
    so the largest key, rspan * n - 1, lies within rspan of 2^31 - 1;
    columns are drawn from few values (duplicate keys). kind "one_key":
    every table row holds column n - 1 alone and every live slot sits at
    local row rspan - 1 (one duplicate run over the slab)."""
    rng = np.random.default_rng(seed)
    n = INT32_MAX // rspan
    lanes = max(128, 4 * run)
    F_B = max(8, ka)
    pool = np.unique(np.concatenate(
        [[0], n - 1 - rng.integers(1, 4 * run, 2 * run),
         rng.integers(0, n - 1, 2 * run)]))
    table = np.full((F_B + 1, lanes), -1, np.int32)
    for f in range(F_B):
        if kind == "one_key":
            cols = np.array([n - 1])
        else:
            cnt = rng.integers(0, run + 1) if f % 5 else run
            cols = np.sort(rng.choice(pool, size=cnt, replace=False))
            if f == 0:
                cols[-1] = n - 1
        row = table[f]
        row[:len(cols)] = cols
        row[run:run + len(cols)] = rng.standard_normal(len(cols)).astype(
            np.float32).view(np.int32)
        row[2 * run:3 * run] = row[:run][::-1]
        row[3 * run:4 * run] = row[run:2 * run][::-1]
    used = rng.integers(1, ka + 1, S)
    used[S - pad_slabs:] = 0
    slot = np.arange(ka)[:, None]
    last = slot == used[None, :] - 1
    live = (slot < used[None, :]) & ((rng.random((ka, S)) > 0.1) | last)
    mt = np.where(live, rng.integers(0, F_B, (ka, S)), F_B)
    mt[last] = 0
    lrT = np.sort(rng.integers(0, rspan, (ka, S)), axis=0)
    lrT[last] = rspan - 1
    if kind == "one_key":
        lrT[:] = rspan - 1
    lrT = np.where(live, lrT, rng.integers(0, INT32_MAX, (ka, S)))
    avT = rng.standard_normal((ka, S)).astype(np.float32)
    avT[~live] = np.nan
    return (torch.from_numpy(table), torch.from_numpy(mt.astype(np.int32)),
            torch.from_numpy(avT), torch.from_numpy(lrT.astype(np.int32)),
            n)


def slab_gather_np(table, mt):
    """The fragment gather g = table[mt] (ka, S, lanes), built with numpy:
    the operand the JAX package's slab kernels take."""
    return host(table)[host(mt)]


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


# bf16 bits of float32 products that K7a's pack caps at 0xFFFE (bits
# 0xFFFF0000 .. 0xFFFF7FFF round to 0xFFFF) or whose rounding add wraps
# past 2^32 (0xFFFF8000 and up): negative NaNs, which only a NaN B value
# gives (a CPU multiply keeps its bits; the card's returns the canonical
# NaN, so the card tests leave them out)
CAP_BITS = (0xFFFF0000, 0xFFFF1234, 0xFFFF7FFF, 0xFFFF8000, 0xFFFFFFFF)
MAX_COL = 32767   # the serve lane packs columns into 15 bits


def table_fragments(m, ka, run, *, kind="random", pad_rows=2, seed=0,
                    lanes=None):
    """K2's and K7a's table-source operands built with numpy, in the
    flat route's layout: (table (F + 1, lanes) int32, rT (ka, m) int32,
    avT (ka, m) float32). Table row f holds up to `run` sorted distinct
    columns of one B sub-run (forward: columns then -1; the reversed half
    the same run backwards) and their value bits; row F is all -1, the
    sentinel row. Columns come from few values, 0 and MAX_COL among them
    (duplicate keys; the largest column the serve lane packs); every
    fifth row is full and row 0 holds MAX_COL. Each row uses its first
    few fragments (the rest read the sentinel row, as an A row's empty
    slots do), a few more read it in between, and the last ``pad_rows``
    rows read only it. Sentinel-row fragments carry NaN A values, which a
    kernel must select away. kind "one_key": every table row holds
    MAX_COL alone; "cap": B values of CAP_BITS in every table row."""
    rng = np.random.default_rng(seed)
    lanes = max(128, 4 * run) if lanes is None else lanes
    F = max(8, ka)
    pool = np.unique(np.concatenate(
        [[0, MAX_COL], rng.integers(0, MAX_COL, 2 * run)]))
    table = np.full((F + 1, lanes), -1, np.int32)
    for f in range(F):
        if kind == "one_key":
            cols = np.array([MAX_COL])
        else:
            cnt = rng.integers(0, run + 1) if f % 5 else run
            cols = np.sort(rng.choice(pool, size=cnt, replace=False))
            if f == 0:
                cols[-1] = MAX_COL
        vals = rng.standard_normal(len(cols)).astype(np.float32).view(
            np.int32)
        if kind == "cap":
            vals[:len(CAP_BITS)] = np.array(
                CAP_BITS, np.uint32)[:len(vals)].view(np.int32)
        row = table[f]
        row[:len(cols)] = cols
        row[run:run + len(cols)] = vals
        row[2 * run:3 * run] = row[:run][::-1]
        row[3 * run:4 * run] = row[run:2 * run][::-1]
    used = rng.integers(1, ka + 1, m)
    used[m - pad_rows:] = 0
    slot = np.arange(ka)[:, None]
    live = (slot < used[None, :]) & (rng.random((ka, m)) > 0.1)
    rT = np.where(live, rng.integers(0, F, (ka, m)), F).astype(np.int32)
    avT = rng.standard_normal((ka, m)).astype(np.float32)
    avT[~live] = np.nan
    return (torch.from_numpy(table), torch.from_numpy(rT),
            torch.from_numpy(avT))


def packed_rows(width, m=3, kind="random", seed=0):
    """K7a's output, built with numpy and the plain pack
    (``_pack_colval``): rows of sorted (col << 16 | bf16) keys, SENTINEL
    last. "random": columns below width / 3 (duplicate runs), MAX_COL
    and a tenth SENTINEL; "cancel": width / 2 distinct columns, MAX_COL
    among them, each twice, once with a bf16-exact value and once with
    its negative (each sum exactly 0, the column still a survivor);
    "sentinel": SENTINEL only. Returns (m, width) int32."""
    rng = np.random.default_rng(seed + width)
    if kind == "cancel":
        cols = np.stack([rng.permutation(MAX_COL)[:width // 2]
                         for _ in range(m)])
        cols[:, 0] = MAX_COL
        x = (rng.standard_normal((m, width // 2)).astype(np.float32)
             .view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
        key = np.concatenate([cols, cols], axis=1)
        val = np.concatenate([x, -x], axis=1)
    else:
        key = rng.integers(0, max(4, width // 3), (m, width))
        key[rng.random((m, width)) < 0.05] = MAX_COL
        key[rng.random((m, width)) < 0.1] = TK.SENTINEL
        if kind == "sentinel":
            key[:] = TK.SENTINEL
        val = rng.standard_normal((m, width)).astype(np.float32)
    key = torch.from_numpy(key.astype(np.int32))
    p = torch.where(key != TK.SENTINEL,
                    TK._pack_colval(key.clamp(min=0), torch.from_numpy(val)),
                    TK.SENTINEL)
    return torch.sort(p, dim=1).values


# K14 (ops/esc_kernels.esc_expand): the global engine's expansion. Each
# case is A's and B's CSR arrays (numpy) and the sizes; ESC_EXPAND_TYPES
# the (A values, B values, products) types.
ESC_EXPAND_TYPES = {"f32": (np.float32, np.float32, torch.float32),
                    "f64": (np.float64, np.float64, torch.float64),
                    "f32_to_f64": (np.float32, np.float32, torch.float64),
                    "f32_x_f64": (np.float32, np.float64, torch.float64)}


def _sparse(m, n, density, seed, *, empty_rows=(), long_rows=(),
            row_len=None):
    """A scipy CSR (float64 normal values) with the given rows emptied;
    `long_rows` {row: length} of distinct columns; `row_len` one entry
    in each of that many rows (the rest empty)."""
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=density, format="lil", random_state=rng,
                  data_rvs=rng.standard_normal)
    if row_len is not None:
        a = sp.lil_matrix((m, n))
        for r in range(row_len):
            a[r, rng.integers(n)] = rng.standard_normal()
    for r, length in dict(long_rows).items():
        a[r, rng.choice(n, length, replace=False)] = rng.standard_normal(
            length)
    for r in empty_rows:
        a[r, :] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    return a


def _csr_arrays(a, dtype, pad=0, pad_val=np.nan):
    """(row_ptr, col, val) int32 / int32 / dtype, `pad` entries past nnz
    (column n, value pad_val), at least one entry, as the port's CSR."""
    pad = max(pad, 1 - a.nnz)
    col = np.concatenate([a.indices, np.full(pad, a.shape[1])])
    val = np.concatenate([a.data, np.full(pad, pad_val)])
    return (a.indptr.astype(np.int32), col.astype(np.int32),
            val.astype(dtype))


def _b_lengths(a, b):
    c = np.clip(a.indices, 0, b.shape[0] - 1)
    return int(np.diff(b.indptr)[c].sum())


def esc_expand_case(name, types):
    """((a_row_ptr, a_col, a_val, a_nnz, b_row_ptr, b_col, b_val) numpy,
    dict(e_cap, m, k, n, val_dtype)) of one K14 case:

    - "empty_rows": empty rows in A and B, 5 entries past nnz with NaN
      values, e_cap 37 past the products;
    - "e_cap_exact": the same, e_cap the products;
    - "past_nnz_tensor": 100 entries past nnz, nnz given as a tensor;
    - "no_products": A's entries meet only empty B rows;
    - "long_b_rows": B rows of 5,000 and 4,097 entries, longer than a
      kernel tile (4,096 slots);
    - "short_b_rows": B rows of one entry or none, 6,000 A entries, so a
      tile meets more entries than a chunk (1,024);
    - "int64_keys": m = n = 50,000, (m+1)(n+1) >= 2^31;
    - "slab": the last row slab of a sliced plan (rows past m padded),
      its rebased row pointer and m = the plan's row capacity."""
    ta, tb, vd = types
    kw = dict(val_dtype=vd, pad=0)
    if name in ("empty_rows", "e_cap_exact", "past_nnz_tensor"):
        a = _sparse(40, 30, 0.15, 1, empty_rows=(0, 3, 7, 20, 39))
        b = _sparse(30, 50, 0.2, 2, empty_rows=(0, 5, 11))
        kw["pad"] = 100 if name == "past_nnz_tensor" else 5
    elif name == "no_products":
        a = _sparse(20, 30, 0.1, 3)
        b = _sparse(30, 40, 0.0, 4)
    elif name == "long_b_rows":
        a = _sparse(24, 10, 0.3, 5, long_rows={3: 8})
        b = _sparse(10, 6000, 0.001, 6, long_rows={2: 5000, 7: 4097})
    elif name == "short_b_rows":
        a = _sparse(200, 300, 0.1, 7)
        b = _sparse(300, 300, 0.0, 8, row_len=250)
    elif name == "int64_keys":
        a = _sparse(50000, 50000, 4e-6, 9, long_rows={49999: 30})
        b = _sparse(50000, 50000, 4e-6, 10, long_rows={0: 40})
        hits = np.arange(0, 50000, 100)    # rows meeting B's long row 0
        a = (a + sp.csr_matrix((np.ones(hits.size), (hits, 0 * hits)),
                               shape=a.shape)).tocsr()
    elif name == "slab":
        from ia_spgemm_tpu_torch.ops import esc
        a = _sparse(60, 60, 0.15, 11, empty_rows=(58,))
        A = TCSR.from_scipy(a.astype(ta), device="cpu")
        plan = esc.plan_spgemm(A, TCSR.from_scipy(a.astype(tb),
                                                  device="cpu"),
                               workspace_elems=150)
        r0, r1 = plan.slabs[-2], plan.slabs[-1]
        s0, s1 = int(a.indptr[r0]), int(a.indptr[r1])
        rp, col, val = esc._slab_inputs(
            A.row_ptr, A.col_ind, A.values, r0=r0, s0=s0, s1=s1,
            rows_cap=plan.rows_capacity, nnza_cap=plan.nnza_capacity)
        b_rp, b_col, b_val = _csr_arrays(a, tb)
        return ((rp.numpy(), col.numpy(), val.numpy(), s1 - s0, b_rp, b_col,
                 b_val),
                dict(e_cap=plan.expansion_capacity,
                     m=plan.rows_capacity, k=60, n=60, val_dtype=vd))
    else:
        raise KeyError(name)
    a_rp, a_col, a_val = _csr_arrays(a, ta, kw["pad"])
    E = _b_lengths(a, b)
    e_cap = E if name == "e_cap_exact" else E + 37
    nnz = np.array(a.nnz, np.int32) if name == "past_nnz_tensor" else a.nnz
    return ((a_rp, a_col, a_val, nnz) + _csr_arrays(b, tb),
            dict(e_cap=e_cap, m=a.shape[0], k=a.shape[1], n=b.shape[1],
                 val_dtype=vd))


ESC_EXPAND_CASES = ("empty_rows", "e_cap_exact", "past_nnz_tensor",
                    "no_products", "long_b_rows", "short_b_rows",
                    "int64_keys", "slab")


def esc_expand_tensors(args, device):
    """esc_expand_case's arrays as tensors on `device` (nnz a 0-d int32
    tensor where the case gives an array)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 if isinstance(x, np.ndarray) else x for x in args)


def esc_expand_reference(args, *, e_cap, m, k, n, val_dtype):
    """K14's (key, value) from the definition, in numpy: A's first nnz
    entries in order, each its B row in order, key row * n + col (int32
    where (m+1)(n+1) < 2^31, else int64), value a * b rounded once in
    the product type; then key m * n and value 0 up to e_cap."""
    a_rp, a_col, a_val, nnz, b_rp, b_col, b_val = args
    nnz = int(nnz)
    kd = np.int32 if (m + 1) * (n + 1) < 2**31 else np.int64
    vd = np.float32 if val_dtype == torch.float32 else np.float64
    rows = np.searchsorted(a_rp, np.arange(nnz), side="right") - 1
    c = np.clip(a_col[:nnz], 0, k - 1)
    starts = b_rp[c].astype(np.int64)
    lens = b_rp[c + 1].astype(np.int64) - starts
    E = int(lens.sum())
    t = np.repeat(np.arange(nnz), lens)
    first = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    pos = np.repeat(starts - first, lens) + np.arange(E)
    key = np.full(e_cap, m * n, kd)
    val = np.zeros(e_cap, vd)
    key[:E] = rows[t].astype(np.int64) * n + b_col[pos]
    val[:E] = a_val[t].astype(vd) * b_val[pos].astype(vd)
    return key, val


def assert_same_bits(got, want, msg=""):
    """Equal dtype and bits (values compared as their bit patterns, so
    NaN payloads and signed zeros count)."""
    got, want = host(got), np.asarray(want)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    bits = {4: np.int32, 8: np.int64}[want.dtype.itemsize]
    assert np.array_equal(got.view(bits), want.view(bits)), msg
