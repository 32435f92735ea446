"""PyTorch port, bench/scaling.py: the analytic link model (ported from
tests/test_ring.py's, with the H100 data-sheet NVLink rate), and the
measured ring, dist and weak scaling on CPU shards (simulated: shards
on one device run one after another), with the JAX package's model
held beside the port's at the same link rate."""

import numpy as np
import pytest

from ia_spgemm_tpu.bench import scaling as jscaling
from ia_spgemm_tpu.formats.types import CSR as JCSR
from ia_spgemm_tpu_torch.bench import scaling
from ia_spgemm_tpu_torch.formats.types import CSR
from ia_spgemm_tpu_torch.parallel.mesh import SHARDS_PER_DEVICE_ENV
from tests import fixtures


@pytest.fixture
def banded():
    a = fixtures.banded_csr(4096, bandwidth=3, seed=2).astype(np.float32)
    return a, CSR.from_scipy(a, device="cpu")


def test_model_shapes_and_limits(banded):
    """Compute-bound problems scale ~linearly, wire-bound ones decay;
    the link carries sizeof_ell(B)/D per step."""
    _, A = banded
    pts = scaling.model_ring_efficiency(A, (1, 2, 4, 8), t1_ms=1e4)
    assert [p["devices"] for p in pts] == [1, 2, 4, 8]
    assert pts[0]["efficiency"] == 1.0 and pts[0]["comm_ms"] == 0.0
    assert all(p["efficiency"] > 0.99 for p in pts)
    ptsw = scaling.model_ring_efficiency(A, (1, 2, 4, 8), t1_ms=1e-4)
    effs = [p["efficiency"] for p in ptsw[1:]]
    assert all(e2 < e1 for e1, e2 in zip(effs, effs[1:]))
    kb = int(np.diff(A.row_ptr.numpy()).max())
    assert ptsw[2]["comm_bytes_per_link"] == int(A.nrows * kb * 8 / 4)
    no = scaling.model_ring_efficiency(A, (8,), t1_ms=5.0, overlap=False)
    ov = scaling.model_ring_efficiency(A, (8,), t1_ms=5.0)
    assert no[0]["time_ms"] >= ov[0]["time_ms"]
    assert scaling.H100_NVLINK_BYTES_PER_S == 450e9


@pytest.mark.parametrize("overlap", [True, False])
def test_model_matches_jax_at_the_same_link_rate(banded, overlap):
    a, A = banded
    J = JCSR.from_scipy(a)
    rate = scaling.H100_NVLINK_BYTES_PER_S
    for t1 in (1e-3, 0.5, 40.0):
        jp = jscaling.model_ring_efficiency(J, (1, 2, 4, 8, 16), t1_ms=t1,
                                            ici_bytes_per_s=rate,
                                            overlap=overlap)
        tp = scaling.model_ring_efficiency(A, (1, 2, 4, 8, 16), t1_ms=t1,
                                           link_bytes_per_s=rate,
                                           overlap=overlap)
        for j, t in zip(jp, tp):
            assert t["comm_bytes_per_link"] == j["comm_bytes_per_link"]
            # the JAX package rounds to 4 decimals, the port does not
            for k in ("compute_ms", "comm_ms", "time_ms", "efficiency"):
                assert t[k] == pytest.approx(j[k], abs=6e-5, rel=1e-6)


def test_ring_scaling_on_cpu_shards(monkeypatch):
    monkeypatch.setenv(SHARDS_PER_DEVICE_ENV, "4")
    a = fixtures.random_csr(256, 256, density=0.03, seed=4)
    A = CSR.from_scipy(a.astype(np.float32), device="cpu")
    pts = scaling.measure_ring_scaling(A, (1, 2, 4, 8), iters=1)
    assert [p.devices for p in pts] == [1, 2, 4]     # 8 > 4 shards: stop
    assert pts[0].efficiency == 1.0
    assert all(0.0 < p.efficiency <= 1.0 for p in pts[1:])
    want = (a @ a).tocsr().nnz
    assert all(p.nnz_out == want and p.time_ms > 0 for p in pts)
    rep = scaling.report(pts, "cpu")
    assert rep["simulated"] is True and rep["backend"] == "cpu"
    assert rep["points"][0]["devices"] == 1


def test_dist_scaling_on_cpu_shards(monkeypatch):
    monkeypatch.setenv(SHARDS_PER_DEVICE_ENV, "2")
    a = fixtures.random_csr(200, 200, density=0.04, seed=6)
    A = CSR.from_scipy(a.astype(np.float32), device="cpu")
    rep = scaling.measure_dist_scaling(A, (1, 2), iters=1)
    assert rep["simulated"] is True
    p1, p2 = rep["points"]
    assert p1["efficiency_measured_compute"] == 1.0
    assert 0.0 < p2["efficiency_measured_compute"] <= 1.0
    assert 0.0 < p2["efficiency_with_modeled_wire"] <= 1.0
    assert p1["nnz_out"] == p2["nnz_out"] == (a @ a).tocsr().nnz
    assert len(p2["per_shard_ms"]) == 2 and p2["comm_bytes_per_link"] > 0


def test_weak_scaling_on_cpu_shards(monkeypatch):
    monkeypatch.setenv(SHARDS_PER_DEVICE_ENV, "2")
    rep = scaling.measure_weak_scaling(base_m=256, device_counts=(1, 2),
                                       iters=1, device_type="cpu")
    p1, p2 = rep["points"]
    assert (p1["global_rows"], p2["global_rows"]) == (256, 512)
    assert p1["efficiency_weak"] == 1.0
    assert 0.0 < p2["efficiency_weak"] <= 1.0
    assert p2["allgather_measured_ms"] > 0 and rep["simulated"] is True


def test_scaling_main_on_cpu(tmp_path, capsys, monkeypatch):
    import json
    # --cpu's default of 8 shards, set here so that the test restores it
    monkeypatch.setenv(SHARDS_PER_DEVICE_ENV, "8")
    out = str(tmp_path / "s.json")
    assert scaling.main(["--cpu", "--m", "512", "--iters", "1",
                         "--write", out]) == 0
    rep = json.loads(capsys.readouterr().out)
    with open(out) as f:
        assert json.load(f) == rep
    assert [p["devices"] for p in rep["points"]] == [1, 2, 4, 8]
    assert rep["simulated"] and rep["backend"] == "cpu"
    assert [p["devices"] for p in rep["model_h100_nvlink"]] == [1, 2, 4, 8,
                                                                16, 32]
