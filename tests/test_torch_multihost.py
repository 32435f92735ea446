"""PyTorch port, multi-PROCESS distributed SpGEMM
(parallel/multihost.py): both routes across 2 processes x 2 CPU shards
each (4 shards in all) over gloo, the counterpart of
tests/test_multihost.py. Each child runs
``python -m ia_spgemm_tpu_torch.parallel.multihost`` and imports no jax;
every local block is held to a scipy oracle inside the child."""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_two_process_dist_and_ring():
    port = _free_port()
    code = ("import sys; sys.modules['jax'] = None; "
            "from ia_spgemm_tpu_torch.parallel import multihost; "
            "multihost._selftest(sys.argv[1:]); "
            "assert not [m for m in sys.modules "
            "if m.split('.')[0] == 'ia_spgemm_tpu']")
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-c", code, str(pid), "2", str(port), "cpu",
         "gloo"], cwd=REPO, env=_child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
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
        assert "MULTIPROC_OK" in out, f"proc {pid}:\n{out}"
        assert "dist ok: 2 of 4 blocks" in out and "ring ok" in out


def test_initialize_needs_the_group_layout(monkeypatch):
    import pytest

    from ia_spgemm_tpu_torch.parallel import multihost
    for var in ("IA_SPGEMM_COORDINATOR", "IA_SPGEMM_NUM_PROCS",
                "IA_SPGEMM_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(num_processes=2, process_id=0)
