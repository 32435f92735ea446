"""PyTorch port, the selector's upcycle path against the JAX package:
the harvest (device timers, the label among the menu, the baseline
always run), the v3 corpus (weights/tpu_samples_v3.npz) loaded,
relabeled and scored with weights/TPU_upcycled_v3.npz, the stratified
k-fold assignment, sample and weight files across the two packages, and
MatNet's default device.

Tolerances: images bit-identical, features 1e-6 relative (float32 on
both sides), logits 2e-4 (tests/test_matnet.py's bound); labels, folds
and pick accuracies exactly equal."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ia_spgemm_tpu.formats.types import CSR as JCSR
from ia_spgemm_tpu.models import matnet as jmatnet
from ia_spgemm_tpu.models import upcycle as jupcycle
from ia_spgemm_tpu.models import weights as jweights
from ia_spgemm_tpu_torch.formats.types import CSR as TCSR
from ia_spgemm_tpu_torch.models import matnet as tmatnet
from ia_spgemm_tpu_torch.models import upcycle as tupcycle
from ia_spgemm_tpu_torch.models import weights as tweights
from tests import fixtures

WEIGHTS = tweights.LOCAL_WEIGHTS_DIR
V3_SAMPLES = os.path.join(WEIGHTS, "tpu_samples_v3.npz")
V3_WEIGHTS = os.path.join(WEIGHTS, "TPU_upcycled_v3.npz")


@pytest.fixture(scope="module")
def v3():
    return tupcycle.load_samples(V3_SAMPLES), \
        jupcycle.load_samples(V3_SAMPLES)


def _same_sample(t, j):
    for f in ("img1", "img2", "feats"):
        np.testing.assert_array_equal(np.asarray(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert (t.label, t.winner, t.matrix_name, t.times) == \
        (j.label, j.winner, j.matrix_name, j.times)


def test_v3_corpus_loads_as_in_jax(v3):
    t, j = v3
    assert len(t) == len(j) == 95
    for a, b in zip(t, j):
        _same_sample(a, b)
    assert tupcycle.load_samples_menu(V3_SAMPLES) == \
        jupcycle.load_samples_menu(V3_SAMPLES) == list(tupcycle.V3_MENU)


@pytest.mark.parametrize("menu", [tupcycle.V3_MENU, ("bitonic", "esc"),
                                  ("dense", "dia", "bitonic", "hash")])
def test_relabel_matches_jax(v3, menu):
    t, j = v3
    rt, rj = tupcycle.relabel(t, menu), jupcycle.relabel(j, menu)
    assert len(rt) == len(rj) > 0
    for a, b in zip(rt, rj):
        _same_sample(a, b)


def test_v3_pick_accuracy_matches_jax(v3):
    t, j = v3
    tp, menu = tweights.load_params_npz(V3_WEIGHTS, with_menu=True)
    jp = jweights.load_params_npz(V3_WEIGHTS)
    got = tupcycle.evaluate_pick_accuracy(tp, t, menu, device="cpu")
    want = jupcycle.evaluate_pick_accuracy(jp, j, menu)
    assert got == want
    assert 0.0 < got < 1.0


def test_predict_defaults_to_the_card(monkeypatch, v3):
    """numpy images and no device: MatNet runs on the card, and raises
    on a host without one instead of running on the CPU."""
    s = v3[0][0]
    tp = tweights.load_params_npz(V3_WEIGHTS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tmatnet.predict_logits, tmatnet.predict_class):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            fn(tp, s.img1, s.img2, s.feats)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tupcycle.evaluate_pick_accuracy(tp, [s], tupcycle.V3_MENU)
    # tensors carry their device; the host when asked
    x = torch.from_numpy(s.img1)
    assert tmatnet.predict_logits(tp, x, x, s.feats).device.type == "cpu"
    assert tmatnet.predict_logits(tp, s.img1, s.img2, s.feats,
                                  device="cpu").shape == (5,)


def _record_folds(monkeypatch, mod):
    seen = []

    def fake_upcycle(train_set, **kw):
        seen.append(sorted(s.matrix_name for s in train_set))
        return None, [], ()

    def fake_eval(params, test, menu=None, **kw):
        seen.append(sorted(s.matrix_name for s in test))
        return 0.5

    monkeypatch.setattr(mod, "upcycle", fake_upcycle)
    monkeypatch.setattr(mod, "evaluate_pick_accuracy", fake_eval)
    return seen


@pytest.mark.parametrize("k,seed", [(5, 0), (3, 7)])
def test_stratified_kfold_assignment_matches_jax(monkeypatch, v3, k, seed):
    t, j = v3
    # names are not unique in the corpus: index them
    t = [dataclasses.replace(s, matrix_name=f"{i}") for i, s in enumerate(t)]
    j = [dataclasses.replace(s, matrix_name=f"{i}") for i, s in enumerate(j)]
    seen_t = _record_folds(monkeypatch, tupcycle)
    seen_j = _record_folds(monkeypatch, jupcycle)
    rt = tupcycle.stratified_kfold_accuracy(t, tupcycle.V3_MENU, k=k,
                                            seed=seed, device="cpu")
    rj = jupcycle.stratified_kfold_accuracy(j, tupcycle.V3_MENU, k=k,
                                            seed=seed)
    assert rt == rj and len(seen_t) == 2 * k
    assert seen_t == seen_j


def _sample(label, winner, name, feats=None, times=None):
    return dict(img1=np.full((128, 128), 0.25, np.float32),
                img2=np.zeros((128, 128), np.float32),
                feats=np.zeros(26, np.float64) if feats is None else feats,
                label=label, winner=winner, matrix_name=name,
                times=times or {})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sample_files_cross_packages(tmp_path, writer):
    menu = ("bitonic", "esc", "dense")
    rows = [_sample(0, "bitonic", "a", times={"bitonic": [1.0, 2.0],
                                              "esc": [3.0, 4.0]}),
            _sample(2, "dense", "b", times={"dense": [0.0, 5.0]})]
    path = str(tmp_path / "s.npz")
    save, load = ((tupcycle.save_samples, jupcycle.load_samples)
                  if writer == "port" else
                  (jupcycle.save_samples, tupcycle.load_samples))
    mod = tupcycle if writer == "port" else jupcycle
    save(path, [mod.Sample(**r) for r in rows], menu=menu)
    back = load(path)
    for b, r in zip(back, rows):
        _same_sample(b, tupcycle.Sample(**r))
    assert tupcycle.load_samples_menu(path) == \
        jupcycle.load_samples_menu(path) == list(menu)


def test_load_samples_rejects_nonfinite_features_as_jax(tmp_path):
    bad = np.zeros(26, np.float64)
    bad[3] = np.inf
    path = str(tmp_path / "s.npz")
    tupcycle.save_samples(path, [tupcycle.Sample(**_sample(0, "csr", "ok")),
                                 tupcycle.Sample(**_sample(
                                     1, "coo", "poisoned", feats=bad))])
    for load in (tupcycle.load_samples, jupcycle.load_samples):
        with pytest.raises(ValueError, match="poisoned"):
            load(path)


def test_harvest_sample_matches_jax():
    """Same inputs, same rows: the images and features the JAX harvest
    stores, every row device-timed, the label the device-time winner
    among the menu (the baseline runs but is no candidate)."""
    a = fixtures.banded_csr(48, bandwidth=2, seed=3).astype(np.float32)
    J, T = JCSR.from_scipy(a), TCSR.from_scipy(a, device="cpu")
    menu = ("csr", "bitonic")
    names = []
    ts = tupcycle.harvest_sample(T, T, menu=menu, name="band", iters=1,
                                 progress=names.append)
    js = jupcycle.harvest_sample(J, J, menu=menu, name="band", iters=1)
    assert names == ["baseline", "csr", "bitonic"]
    assert ts.matrix_name == js.matrix_name == "band"
    for f in ("img1", "img2"):
        np.testing.assert_array_equal(getattr(ts, f),
                                      np.asarray(getattr(js, f)))
    np.testing.assert_allclose(ts.feats, np.asarray(js.feats), rtol=1e-6)
    assert set(ts.times) == set(js.times) == {"baseline", "csr", "bitonic"}
    assert ts.times["baseline"][0] == 0.0
    assert all(ts.times[n][0] > 0 for n in menu)
    dev = {n: ts.times[n][0] for n in menu}
    assert ts.winner == min(dev, key=dev.get) and \
        ts.label == menu.index(ts.winner)


def test_harvest_keeps_wrong_results_out_of_the_times(monkeypatch):
    """A row whose checksum misses the baseline's is neither the label
    nor a stored time (relabel could otherwise pick it)."""
    from ia_spgemm_tpu_torch.bench import harness
    a = fixtures.banded_csr(40, bandwidth=1, seed=4).astype(np.float32)
    T = TCSR.from_scipy(a, device="cpu")
    real = harness.run_benchmark

    def corrupt(*args, **kw):
        rep = real(*args, **kw)
        rep.by_name("csr").error = "checksum mismatch vs baseline"
        return rep

    monkeypatch.setattr(harness, "run_benchmark", corrupt)
    s = tupcycle.harvest_sample(T, T, menu=("csr", "dense"), iters=1)
    assert s.winner == "dense" and "csr" not in s.times
    assert tupcycle.harvest_sample(T, T, menu=("csr",), iters=1) is None


def test_upcycle_weights_serve_in_jax(tmp_path, v3):
    """Retrain on a few v3 samples (random init), save, and read the
    weights back in both packages: the same logits."""
    t, _ = v3
    params, history, menu = tupcycle.upcycle(
        t[:12], menu=tupcycle.V3_MENU, init_from=None, steps=3,
        batch_size=4, device="cpu")
    assert menu == tupcycle.V3_MENU and len(history) == 1
    assert params["head"]["kernel"].shape == (90, 5)
    path = str(tmp_path / "w.npz")
    tweights.save_params_npz(path, params, menu=menu)
    jp, jmenu = jweights.load_params_npz(path, with_menu=True)
    assert jmenu == menu
    s = t[0]
    want = np.asarray(jmatnet.predict_logits(jp, s.img1, s.img2, s.feats))
    got = tmatnet.predict_logits(tweights.load_params_npz(path), s.img1,
                                 s.img2, s.feats, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    acc = tupcycle.evaluate_pick_accuracy(params, t[:12], menu,
                                          device="cpu")
    assert 0.0 <= acc <= 1.0
