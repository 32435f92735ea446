"""PyTorch port, multi-PROCESS distributed SpGEMM
(parallel/multihost.py): both routes across 2 processes x 2 CPU shards
each (4 shards in all) over gloo, the counterpart of
tests/test_multihost.py. Each child runs
``python -m ia_spgemm_tpu_torch.parallel.multihost`` and imports no jax;
every local block is held to a scipy oracle inside the child. The ring
across those processes (the plain hop) is also held to the JAX
package's ring on a 4-device CPU mesh, row by row: the pattern exactly,
float32 values within RING_RTOL of max(1, max|C|) (duplicates summed in
another order: the JAX K4 network against the plain stable sort, as
tests/test_torch_ring.py). And the self-test's worker asks for the card
unless told cpu."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING_RTOL = 1e-6


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["IA_SPGEMM_SHARDS_PER_DEVICE"] = "2"
    env.pop("IA_SPGEMM_COORDINATOR", None)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(code, *args):
    """Runs ``python -c code PID *args`` for PID 0 and 1 (no jax in the
    children); returns their outputs after checking both exited 0."""
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-c", "import sys; sys.modules['jax'] = None\n"
         + code, str(pid), *map(str, args)], cwd=REPO, env=_child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} rc={p.returncode}:\n{out}"
    return outs


def test_two_process_dist_and_ring():
    code = ("from ia_spgemm_tpu_torch.parallel import multihost; "
            "multihost._selftest(sys.argv[1:]); "
            "assert not [m for m in sys.modules "
            "if m.split('.')[0] == 'ia_spgemm_tpu']")
    outs = _run_pair(code, 2, _free_port(), "cpu", "gloo")
    for pid, out in enumerate(outs):
        assert "MULTIPROC_OK" in out, f"proc {pid}:\n{out}"
        assert "dist ok: 2 of 4 blocks" in out and "ring ok" in out
        # host shards: no K13 across processes, and use_rdma=True raised
        assert "K13 across processes: False" in out


# one child of the parity test: one hop of the cross-process wrapper on
# host blocks (the plain hop into its shared receivers), then the ring
# over 2 processes x 2 CPU shards (the plain hop across processes) on the
# matrix in TMP/a.npz, with A and B both row- and both flops-balanced;
# its rows into TMP/BALANCE_PID.npz
RING_CHILD = """
import numpy as np, scipy.sparse as sp, torch.distributed as dist
from ia_spgemm_tpu_torch.formats import convert
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.parallel import multihost, rdma_ring, ring
from ia_spgemm_tpu_torch.parallel.mesh import make_mesh
pid, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(f"127.0.0.1:{port}", 2, pid, backend="gloo")
a = sp.load_npz(f"{tmp}/a.npz")
A = convert.csr_to_ell(CSR.from_scipy(a, device="cpu"), check_guard=False)
mesh = make_mesh(device_type="cpu")
D = mesh.num_shards
assert D == 4 and mesh.spans_processes
assert not rdma_ring.rdma_available(mesh)
plan = ring.plan_ring(A, A, D)
# on host blocks the cross-process wrapper runs the plain hop into the
# shared receivers (no IPC on the host)
S = ring.partition_rows_ell(A, D, mesh=mesh)
sets = rdma_ring.shared_receivers(mesh, S.col_ind, S.values)
assert rdma_ring.shared_receivers(mesh, S.col_ind, S.values) is sets
assert sets[0].peers is None and sets[0].left == ()
got = rdma_ring.ring_hop_xproc(mesh, S.col_ind, S.values, out=sets[0])
want = rdma_ring.ring_hop_processes_plain(mesh, S.col_ind, S.values)
assert [[t.data_ptr() for t in g] for g in got] == [
    [t.data_ptr() for t in o] for o in sets[0]]
assert all(bool((p == q).all()) for ga, wa in zip(got, want)
           for p, q in zip(ga, wa))
assert rdma_ring.launch_counts()["K13"] == 0
for bal in ("rows", "flops"):
    S = ring.partition_rows_ell(A, D, mesh=mesh, balance=bal, B=A)
    rows = list(multihost.local_ell_rows(ring.ring_spgemm(S, S, mesh, plan)))
    np.savez(f"{tmp}/{bal}_{pid}.npz",
             **{f: np.concatenate([getattr(r, f) for r in rows])
                for f in ("row_ids", "col_ind", "values", "nnz_row")})
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ring_rows(tmp_path_factory):
    """(matrix, directory of the children's rows), one pair of children
    for both balances."""
    tmp = tmp_path_factory.mktemp("ring_xproc")
    a = sp.random(90, 90, density=0.08, format="csr", dtype=np.float32,
                  random_state=np.random.RandomState(13))
    sp.save_npz(tmp / "a.npz", a)
    _run_pair(RING_CHILD, _free_port(), tmp)
    return a, tmp


@pytest.mark.parametrize("balance", ["rows", "flops"])
def test_ring_across_processes_matches_jax(ring_rows, balance):
    """Each process's rows of the process-spanning ring against the JAX
    package's ring on 4 CPU devices, the same float32 matrix (numpy
    seed): every row's pattern exactly, values within RING_RTOL."""
    import jax

    from ia_spgemm_tpu.parallel import ring as jring
    from ia_spgemm_tpu.parallel.mesh import make_mesh as jmake_mesh
    from tests.torch_parity import assert_values_close, jell

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    a, tmp_path = ring_rows
    jm = jmake_mesh(4)
    JA = jell(a)
    S = jring.partition_rows_ell(JA, 4, mesh=jm, balance=balance, B=JA)
    J = jring.gather_result_ell(jring.ring_spgemm(
        S, S, jm, jring.plan_ring(JA, JA, 4)))
    j_col, j_val = np.asarray(J.col_ind), np.asarray(J.values)
    j_nnz = np.asarray(J.nnz_row)
    seen = []
    for pid in (0, 1):
        got = np.load(tmp_path / f"{balance}_{pid}.npz")
        for g, col, val, n in zip(got["row_ids"], got["col_ind"],
                                  got["values"], got["nnz_row"]):
            if g < 0:
                continue
            seen.append(int(g))
            assert n == j_nnz[g], (g, n, j_nnz[g])
            assert np.array_equal(col[:n], j_col[g, :n]), g
            assert_values_close(val[:n], j_val[g, :n], f"row {g}",
                                RING_RTOL)
    assert sorted(seen) == list(range(a.shape[0]))


def test_selftest_defaults_to_the_card(monkeypatch):
    """PID NPROC PORT alone asks for the card over gloo; without one the
    worker raises, naming cpu, before it joins a group."""
    import torch
    import torch.distributed as dist

    from ia_spgemm_tpu_torch.parallel import multihost
    args = multihost._args(["0", "2", "1234"])
    assert (args.device, args.backend, args.matrix, args.rdma) == (
        "cuda", "gloo", "small", "auto")
    args = multihost._args(["1", "4", "1234", "cpu", "nccl", "--matrix",
                            "headline", "--rdma", "off"])
    assert (args.pid, args.nproc, args.device, args.backend, args.matrix,
            args.rdma) == (1, 4, "cpu", "nccl", "headline", "off")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass cpu"):
        multihost._selftest(["0", "1", str(_free_port())])
    assert not dist.is_initialized()


def test_initialize_needs_the_group_layout(monkeypatch):
    import pytest

    from ia_spgemm_tpu_torch.parallel import multihost
    for var in ("IA_SPGEMM_COORDINATOR", "IA_SPGEMM_NUM_PROCS",
                "IA_SPGEMM_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(num_processes=2, process_id=0)


def test_hop_bound_ms_counts_each_cards_bytes():
    """One ring step's least time on the cards of each global shard:
    every block read and written once in its card's memory, and once
    over the link where it changes cards; the busiest card bounds it."""
    from ia_spgemm_tpu_torch.parallel.multihost import hop_bound_ms
    n, hbm, link = 1000, 1e6, 1e5           # ms = bytes / rate * 1e3
    # 4 shards of one card: 4 blocks read and 4 written there
    assert hop_bound_ms(["A"] * 4, n, hbm, link) == 8 * n / hbm * 1e3
    # 2 processes x every card of 4: each card sends and receives 2
    every = list("ABCD") * 2
    assert hop_bound_ms(every, n, hbm, link) == 2 * n / link * 1e3
    # 2 x 2 cards: A <- B, B <- C, C <- D, D <- A, one block each
    assert hop_bound_ms(list("ABCD"), n, hbm, link) == n / link * 1e3
    # two shards on A: A's memory reads 2 blocks and writes 2
    assert hop_bound_ms(list("AABC"), n, hbm, 1e9) == 4 * n / hbm * 1e3


def test_release_shared_closes_the_mappings_before_it_frees_its_own(
        monkeypatch):
    """The teardown order of the shared receivers (on fake cards): the
    cards synchronised, the mappings of the left neighbour's receivers
    closed, a barrier of the group, then this process's receivers freed
    and ``torch.cuda.ipc_collect``. A block freed by its maker while a
    neighbour still maps it waits in torch's IPC limbo, and what the
    limbo holds at exit is freed after CUDA's state has gone (process 0
    aborted there over NCCL). The sets refer to each other, so nothing
    may wait for the garbage collector: it is off here."""
    import gc
    import weakref

    import torch
    import torch.distributed as dist

    from ia_spgemm_tpu_torch.parallel import rdma_ring as RR
    card = torch.device("cuda", 0)
    group = object()
    events = []

    def alive(refs):
        return [r() is not None for r in refs]

    sets = [RR.XReceivers([[torch.zeros(4)], [torch.zeros(4)]])
            for _ in range(2)]
    mine = [weakref.ref(t) for s in sets for o in s for t in o]
    maps = [torch.ones(4), torch.ones(4)]
    mapped = [weakref.ref(t) for t in maps]
    sig = RR._Signals(None, None, None, 0, 0, 0, RR.HopCounters(), [],
                      group=group)
    for s, t in zip(sets, maps):
        s.left, s.peers, s.cards, s.pair = (t,), sig, (card,), tuple(sets)
    held = [weakref.ref(s) for s in sets]
    del maps, t, s
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: events.append(("sync", d)))
    monkeypatch.setattr(
        dist, "barrier", lambda group=None: events.append(
            ("barrier", group is sig.group, alive(mapped), alive(mine))))
    monkeypatch.setattr(torch.cuda, "ipc_collect", lambda: events.append(
        ("collect", alive(mine), alive(held))))
    monkeypatch.setattr(RR, "_SHARED", {"key": sets})
    monkeypatch.setattr(RR, "_SIGNALS", {id(group): sig})
    del sets
    gc.disable()
    try:
        RR.release_shared()
    finally:
        gc.enable()
    assert events == [("sync", card),
                      ("barrier", True, [False] * 2, [True] * 4),
                      ("collect", [False] * 4, [False] * 2)]
    assert not RR._SHARED and not RR._SIGNALS
    assert sig.failed and "released" in sig.failed


def test_close_synchronises_then_releases_before_it_leaves(monkeypatch,
                                                           capsys):
    """multihost's exit: this process's cards, then the collective
    release of the shared receivers, a barrier, and only then the group
    destroyed (the release needs the group)."""
    import torch.distributed as dist

    from ia_spgemm_tpu_torch.parallel import multihost
    from ia_spgemm_tpu_torch.parallel import rdma_ring as RR
    calls = []
    monkeypatch.setattr(multihost, "_synchronize",
                        lambda mesh: calls.append("synchronize"))
    monkeypatch.setattr(RR, "release_shared",
                        lambda: calls.append("release_shared"))
    monkeypatch.setattr(dist, "barrier", lambda: calls.append("barrier"))
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: calls.append("destroy"))
    multihost._close(None, 3)
    assert calls == ["synchronize", "release_shared", "barrier", "destroy"]
    assert capsys.readouterr().out == "[p3] MULTIPROC_OK\n"


def test_kernels_link_the_processes_shared_cuda_runtime(tmp_path,
                                                        monkeypatch):
    """Every kernel library links the shared CUDA runtime (``-cudart
    shared``, the libcudart.so torch loads), with the toolkit's lib64 as
    a fallback path. With a static runtime in each library, that
    runtime's exit handler released the card's primary context during
    exit(), after a torch.profiler trace had torn down the state CUPTI
    calls back into: process 0 of the NCCL ring aborted at exit."""
    import subprocess

    from ia_spgemm_tpu_torch import _build
    cmds = []

    class Nvcc:
        def __init__(self, cmd, **kw):
            cmds.append(cmd)
            self.returncode = 0
            open(cmd[cmd.index("-o") + 1], "w").close()

        def communicate(self):
            return ("", None)

    monkeypatch.setattr(_build, "_nvcc", lambda: "/opt/cuda/bin/nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(subprocess, "Popen", Nvcc)
    paths = _build.build()
    assert sorted(paths) == sorted(_build.SOURCES)
    assert len(cmds) == len(_build.SOURCES)
    for cmd in cmds:
        i = cmd.index("-cudart")
        assert cmd[i + 1] == "shared"
        j = cmd.index("-Xlinker", cmd.index("-o"))
        assert cmd[j + 1] == "-rpath,/opt/cuda/lib64"
    assert all(p.parent == tmp_path and p.exists() for p in paths.values())
