"""PyTorch port, the all-gather distributed route (parallel/mesh.py,
parallel/distributed.py) against the JAX package on its 8 virtual CPU
devices, and the CLI's --mode dist / ring on an 8-shard CPU mesh.

The port's mesh here is 8 shards of the host (a device may repeat in a
mesh). Tolerances: row boundaries, every partition field, the plans and
the gathered result's row pointers and columns identical; float64 values
within 1e-12 * max(1, max|C|) (the fixtures are float64 and
tests/conftest.py turns x64 on, so the JAX side stays float64)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ia_spgemm_tpu.formats.types import CSR as JCSR
from ia_spgemm_tpu.parallel import distributed as jdist
from ia_spgemm_tpu.parallel.mesh import make_mesh as jmake_mesh
from ia_spgemm_tpu_torch.cli import main as tcli
from ia_spgemm_tpu_torch.formats.types import CSR as TCSR
from ia_spgemm_tpu_torch.io import mmio as tmmio
from ia_spgemm_tpu_torch.parallel import distributed as tdist
from ia_spgemm_tpu_torch.parallel import mesh as tmesh
from tests import fixtures
from tests.torch_parity import F64_RTOL, assert_same, assert_values_close

REPO = Path(__file__).resolve().parents[1]
D = 8


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < D:
        pytest.skip("needs 8 virtual devices")
    return jmake_mesh(D)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_mesh(D, devices=["cpu"] * D)


def _both(a):
    return JCSR.from_scipy(a), TCSR.from_scipy(a, device="cpu")


def _skewed():
    """A super-dense row block over sparse rows (test_dist.py's): flops
    balancing moves the boundaries."""
    m = 80
    return sp.vstack([fixtures.random_csr(10, m, density=0.9, seed=55),
                      fixtures.random_csr(70, m, density=0.01, seed=56)]
                     ).tocsr()


MATS = {"square64": lambda: fixtures.random_csr(64, 64, density=0.08,
                                                seed=50),
        "uneven61": lambda: fixtures.random_csr(61, 61, density=0.1,
                                                seed=54),
        "skewed80": _skewed,
        "tiny5": lambda: fixtures.random_csr(5, 5, density=0.4, seed=3)}


@pytest.mark.parametrize("name", sorted(MATS))
@pytest.mark.parametrize("balance", ["rows", "flops"])
@pytest.mark.parametrize("shards", [1, 4, 8])
def test_row_boundaries_and_partition_match_jax(name, balance, shards):
    a = MATS[name]()
    JA, TA = _both(a)
    assert_same(tdist._row_boundaries(TA, shards, balance, None),
                jdist._row_boundaries(JA, shards, balance, None))
    J = jdist.partition_rows(JA, shards, balance=balance, B=JA)
    T = tdist.partition_rows(TA, shards, balance=balance, B=TA)
    for f in ("row_ptr", "col_ind", "values", "nnz", "row_start"):
        assert_same(tdist.stacked(getattr(T, f)), np.asarray(getattr(J, f)),
                    f)
    assert (T.num_shards, T.rows_per_shard) == (J.num_shards,
                                                J.rows_per_shard)


def test_skewed_flops_boundaries_move():
    TA = TCSR.from_scipy(_skewed(), device="cpu")
    assert list(tdist._row_boundaries(TA, 4, "rows", None)) == [0, 20, 40,
                                                                 60, 80]
    fb = tdist._row_boundaries(TA, 4, "flops", None)
    assert fb[1] < 20 and fb[0] == 0 and fb[-1] == 80


@pytest.mark.parametrize("name", sorted(MATS))
@pytest.mark.parametrize("balance", ["rows", "flops"])
def test_plan_dist_matches_jax(name, balance):
    a = MATS[name]()
    b = fixtures.random_csr(a.shape[1], 40, density=0.2, seed=9)
    JA, TA = _both(a)
    JB, TB = _both(b)
    for shards in (1, 3, 8):
        assert tdist.plan_dist_spgemm(TA, TB, shards, balance=balance) == \
            jdist.plan_dist_spgemm(JA, JB, shards, balance=balance)


def test_plan_dist_int32_guard_matches_jax():
    """The same matrix trips both guards with the same message, and
    plans with enough shards."""
    m, k = 2000, 1000
    cols = ((np.arange(k)[None, :] + np.arange(m)[:, None]) % m).ravel()
    a = sp.csr_matrix((np.ones(m * k, np.float32), cols,
                       np.arange(0, m * k + 1, k)), shape=(m, m))
    JA, TA = _both(a)
    with pytest.raises(ValueError) as je:
        jdist.plan_dist_spgemm(JA, JA, 1)
    with pytest.raises(ValueError) as te:
        tdist.plan_dist_spgemm(TA, TA, 1)
    assert str(te.value) == str(je.value)
    assert "more shards" in str(te.value)
    assert tdist.plan_dist_spgemm(TA, TA, 8) == \
        jdist.plan_dist_spgemm(JA, JA, 8)


def _pair(case):
    if case in ("replicated_rows", "replicated_flops", "allgathered"):
        seeds = {"replicated_rows": (50, 51), "replicated_flops": (50, 51),
                 "allgathered": (52, 53)}[case]
        return (fixtures.random_csr(64, 64, density=0.08, seed=seeds[0]),
                fixtures.random_csr(64, 64, density=0.1, seed=seeds[1]))
    if case == "uneven_rows":
        a = fixtures.random_csr(61, 61, density=0.1, seed=54)
        return a, a
    if case == "sharded_b_uneven":
        return (fixtures.random_csr(61, 61, density=0.1, seed=55),
                fixtures.random_csr(61, 61, density=0.12, seed=56))
    a = fixtures.random_csr(64, 64, density=0.1, seed=57)   # flops
    return a, a


# (A's balance, B sharded with balance, or None for replicated B): every
# case of tests/test_dist.py:29-141
DIST_CASES = {"replicated_rows": ("rows", None),
              "replicated_flops": ("flops", None),
              "allgathered": ("rows", "rows"),
              "uneven_rows": ("rows", None),
              "sharded_b_uneven": ("rows", "rows"),
              "sharded_b_flops": ("flops", "flops")}


@pytest.mark.parametrize("case", sorted(DIST_CASES))
def test_dist_spgemm_matches_jax(jmesh, mesh, case):
    a, b = _pair(case)
    a_bal, b_bal = DIST_CASES[case]
    (JA, TA), (JB, TB) = _both(a), _both(b)
    e_cap, out_cap = jdist.plan_dist_spgemm(JA, JB, D, balance=a_bal)
    assert tdist.plan_dist_spgemm(TA, TB, D, balance=a_bal) == (e_cap,
                                                                 out_cap)
    JAs = jdist.partition_rows(JA, D, balance=a_bal, B=JB, mesh=jmesh)
    TAs = tdist.partition_rows(TA, D, balance=a_bal, B=TB, mesh=mesh)
    if b_bal is None:
        JBs, TBs = JB, TB
    else:
        JBs = jdist.partition_rows(JB, D, balance=b_bal, B=JB, mesh=jmesh)
        TBs = tdist.partition_rows(TB, D, balance=b_bal, B=TB, mesh=mesh)
    Jc = jdist.dist_spgemm(JAs, JBs, jmesh, e_cap=e_cap, out_cap=out_cap)
    Tc = tdist.dist_spgemm(TAs, TBs, mesh, e_cap=e_cap, out_cap=out_cap)
    assert_same(tdist.stacked(Tc.nnz), np.asarray(Jc.nnz), "shard nnz")
    assert_same(tdist.stacked(Tc.row_ptr), np.asarray(Jc.row_ptr),
                "shard row_ptr")
    J, T = jdist.gather_result(Jc), tdist.gather_result(Tc)
    nnz = int(J.nnz)
    assert int(T.nnz) == nnz
    assert_same(T.row_ptr, np.asarray(J.row_ptr), "row_ptr")
    assert_same(T.col_ind[:nnz], np.asarray(J.col_ind)[:nnz], "col_ind")
    assert T.values.dtype == torch.float64
    assert_values_close(T.values[:nnz], np.asarray(J.values)[:nnz],
                        "values", F64_RTOL)
    want = (a @ b).tocsr()
    assert abs(T.to_scipy() - want).max() < 1e-12


def test_assemble_global_csr_matches_jax():
    """The all-gathered B's reassembly, uneven and even splits."""
    b = fixtures.random_csr(61, 50, density=0.12, seed=56)
    JB, TB = _both(b)
    for balance in ("rows", "flops"):
        J = jdist.partition_rows(JB, D, balance=balance, B=JB)
        T = tdist.partition_rows(TB, D, balance=balance, B=TB)
        stk = [torch.stack(getattr(T, f)) for f in ("row_ptr", "col_ind",
                                                    "values", "nnz")]
        kw_j = dict(n_cols=50, row_start=J.row_start, n_rows=61)
        kw_t = dict(n_cols=50, row_start=torch.from_numpy(T.row_start),
                    n_rows=61)
        jo = jdist._assemble_global_csr(J.row_ptr, J.col_ind, J.values,
                                        J.nnz, **kw_j)
        to = tdist._assemble_global_csr(*stk, **kw_t)
        for f, x, y in zip(("row_ptr", "col", "val", "nnz"), to, jo):
            assert_same(x, np.asarray(y), f)
    # an even split needs no row starts
    a = fixtures.random_csr(64, 64, density=0.1, seed=5)
    JA, TA = _both(a)
    J, T = jdist.partition_rows(JA, D), tdist.partition_rows(TA, D)
    jo = jdist._assemble_global_csr(J.row_ptr, J.col_ind, J.values, J.nnz,
                                    n_cols=64)
    to = tdist._assemble_global_csr(
        *[torch.stack(getattr(T, f)) for f in ("row_ptr", "col_ind",
                                              "values", "nnz")], n_cols=64)
    for x, y in zip(to, jo):
        assert_same(x, np.asarray(y))


def test_shards_lie_on_their_mesh_devices(mesh):
    """Each shard is its own tensor on its shard's device; a mesh that
    is asked for more shards than there are raises, as JAX's does."""
    a = fixtures.random_csr(64, 64, density=0.1, seed=57)
    T = tdist.partition_rows(TCSR.from_scipy(a, device="cpu"), D, mesh=mesh)
    assert len(T.values) == D and T.shards == tuple(range(D))
    assert all(t.device == d for t, d in zip(T.values, mesh.devices))
    assert mesh.num_shards == D and not mesh.spans_processes
    with pytest.raises(ValueError, match="asked for 9"):
        tmesh.make_mesh(9, devices=["cpu"] * D)
    with pytest.raises(ValueError, match="shards on a mesh"):
        tdist.partition_rows(TCSR.from_scipy(a, device="cpu"), 4, mesh=mesh)


def test_shards_per_device_setting(monkeypatch):
    """IA_SPGEMM_SHARDS_PER_DEVICE counts every visible device that many
    times, the port's counterpart of XLA's host device count."""
    monkeypatch.setenv(tmesh.SHARDS_PER_DEVICE_ENV, "3")
    assert tmesh.visible_devices("cpu") == [torch.device("cpu")] * 3
    assert tmesh.make_mesh(device_type="cpu").num_shards == 3
    monkeypatch.setenv(tmesh.SHARDS_PER_DEVICE_ENV, "0")
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.visible_devices("cpu")


@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "a.mtx")
    a = fixtures.random_csr(96, 96, density=0.06, seed=21)
    tmmio.write_mtx(path, TCSR.from_scipy(a, device="cpu"))
    return path


@pytest.mark.parametrize("mode", ["dist", "ring"])
def test_cli_distributed_modes_on_cpu_shards(mtx, tmp_path, capsys,
                                             monkeypatch, mode):
    monkeypatch.setenv(tmesh.SHARDS_PER_DEVICE_ENV, str(D))
    out = str(tmp_path / "rep.json")
    assert tcli.main([mtx, "--mode", mode, "--shards", str(D), "--device",
                      "cpu", "--iters", "1", "--json", out]) == 0
    text = capsys.readouterr().out
    assert f"mesh: {D} shard(s)" in text and "[ok]" in text
    assert f"({D}-shard {mode})" in text
    with open(out) as f:
        rep = json.load(f)
    assert set(rep) == {"mode", "shards", "run_time_ms", "nnz_out",
                        "checksum_rel_err"}
    a = tmmio.read_mtx_to_csr(mtx, device="cpu").to_scipy()
    assert rep["mode"] == mode and rep["shards"] == D
    assert rep["nnz_out"] == (a @ a).nnz and rep["checksum_rel_err"] < 1e-4


@pytest.mark.parametrize("mode", ["dist", "ring"])
def test_cli_too_many_shards_exits_2(mtx, capsys, monkeypatch, mode):
    monkeypatch.setenv(tmesh.SHARDS_PER_DEVICE_ENV, str(D))
    assert tcli.main([mtx, "--mode", mode, "--shards", str(D + 1),
                      "--device", "cpu", "--no-matnet"]) == 2
    assert f"--shards {D + 1} > {D} visible" in capsys.readouterr().err


def test_parallel_modules_import_with_jax_blocked():
    code = r"""
import os, sys
sys.modules["jax"] = None
os.environ["IA_SPGEMM_SHARDS_PER_DEVICE"] = "4"
import numpy as np, scipy.sparse as sp
import ia_spgemm_tpu_torch as port
from ia_spgemm_tpu_torch import parallel
from ia_spgemm_tpu_torch.bench import scaling
from ia_spgemm_tpu_torch.formats import convert
from ia_spgemm_tpu_torch.parallel import (distributed, mesh, multihost,
                                          rdma_ring, ring)
a = sp.random(64, 64, density=0.08, format="csr", dtype=np.float32,
              random_state=np.random.RandomState(0))
A = port.CSR.from_scipy(a, device="cpu")
m = mesh.make_mesh(device_type="cpu")
e, o = distributed.plan_dist_spgemm(A, A, 4)
C = distributed.gather_result(distributed.dist_spgemm(
    distributed.partition_rows(A, 4, mesh=m), A, m, e_cap=e, out_cap=o))
assert abs(C.to_scipy() - a @ a).max() < 1e-5
E = convert.csr_to_ell(A, check_guard=False)
S = ring.partition_rows_ell(E, 4, mesh=m)
Ce = ring.gather_result_ell(ring.ring_spgemm(S, S, m,
                                             ring.plan_ring(E, E, 4)))
assert abs(Ce.to_scipy() - a @ a).max() < 1e-5
assert scaling.measure_ring_scaling(A, (1, 2), iters=1)[0].efficiency == 1.0
assert not [k for k in sys.modules if k.split(".")[0] == "ia_spgemm_tpu"]
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")
