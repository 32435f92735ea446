"""PyTorch port, the input-aware selection path against the JAX package:
density images (bit-identical int64), feature vectors (26 and 18
values), MatNet logits for every weight file in weights/, the weight
carry-over, select_algorithm, the headline's picks, and spgemm_auto on
every branch (a flat CSR each time).

Tolerances: features 1e-12 relative (float64 on both sides); MatNet
logits 2e-4, the JAX package's own bound against its numpy oracle
(tests/test_matnet.py); results 1e-5 * max(1, max|C|) of the JAX
package's."""

import glob
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ia_spgemm_tpu import autotune as jauto
from ia_spgemm_tpu.formats.types import CSR as JCSR
from ia_spgemm_tpu.models import matnet as jmatnet
from ia_spgemm_tpu.models import weights as jweights
from ia_spgemm_tpu.ops import density as jdensity
from ia_spgemm_tpu.ops import features as jfeatures
from ia_spgemm_tpu_torch import autotune as tauto
from ia_spgemm_tpu_torch.bench import headline
from ia_spgemm_tpu_torch.formats.types import CSR as TCSR
from ia_spgemm_tpu_torch.models import matnet as tmatnet
from ia_spgemm_tpu_torch.models import weights as tweights
from ia_spgemm_tpu_torch.ops import density as tdensity
from ia_spgemm_tpu_torch.ops import features as tfeatures
from tests import fixtures
from tests.torch_parity import assert_same, assert_values_close

MATS = {
    "square": fixtures.random_csr(300, 300, density=0.02, seed=1),
    "small_m": fixtures.random_csr(40, 300, density=0.05, seed=2),
    "small_n": fixtures.random_csr(300, 50, density=0.05, seed=3),
    "tiny_nonsquare": fixtures.random_csr(7, 9, density=0.4, seed=4),
    "banded": fixtures.banded_csr(200, bandwidth=3, seed=5),
    "empty": sp.csr_matrix((10, 12)),
}
WEIGHT_FILES = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(tweights.LOCAL_WEIGHTS_DIR, "*_matnet.npz")) + glob.glob(
    os.path.join(tweights.LOCAL_WEIGHTS_DIR, "TPU_upcycled*.npz")))


def _both(a):
    a = a.astype(np.float32)
    return JCSR.from_scipy(a), TCSR.from_scipy(a, device="cpu")


@pytest.mark.parametrize("name", sorted(MATS))
def test_density_image_bit_identical(name):
    J, T = _both(MATS[name])
    want = np.asarray(jdensity.density_image(J))
    got = tdensity.density_image(T)
    assert got.dtype == torch.int64 and want.dtype == np.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tdensity.density_image_normalized(T).numpy(),
        np.asarray(jdensity.density_image_normalized(J)))


def test_density_image_files_match_jax(tmp_path):
    J, T = _both(MATS["small_m"])
    jp, tp = tmp_path / "j.txt", tmp_path / "t.txt"
    jdensity.write_density_image(str(jp), jdensity.density_image(J))
    tdensity.write_density_image(str(tp), tdensity.density_image(T))
    assert jp.read_bytes() == tp.read_bytes()
    np.testing.assert_array_equal(tdensity.read_density_image(str(tp)),
                                  jdensity.read_density_image(str(jp)))


@pytest.mark.parametrize("pair", [("square", "square"), ("small_m", "small_n"),
                                  ("banded", "banded"), ("empty", "empty"),
                                  ("tiny_nonsquare", "tiny_nonsquare")])
def test_feature_vector_matches_jax(pair):
    (JA, TA), (JB, TB) = _both(MATS[pair[0]]), _both(MATS[pair[1]])
    want = np.asarray(jfeatures.feature_vector(JA, JB))
    got = tfeatures.feature_vector(TA, TB)
    assert got.dtype == torch.float64 and got.shape == (26,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    # the GPU weights read the first 18
    np.testing.assert_allclose(got.numpy()[:18], want[:18], rtol=1e-12,
                               atol=0)


def test_features_from_converted_formats_match_jax():
    from ia_spgemm_tpu.formats import convert as jconvert
    from ia_spgemm_tpu_torch.formats import convert as tconvert
    J, T = _both(MATS["banded"])
    want = jfeatures.feature_vector(
        J, J, A_dia=jconvert.csr_to_dia(J), A_ell=jconvert.csr_to_ell(J))
    got = tfeatures.feature_vector(
        T, T, A_dia=tconvert.csr_to_dia(T), A_ell=tconvert.csr_to_ell(T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def _load(fname):
    path = os.path.join(tweights.LOCAL_WEIGHTS_DIR, fname)
    tp, menu = tweights.load_params_npz(path, with_menu=True)
    jp, jmenu = jweights.load_params_npz(path, with_menu=True)
    assert menu == jmenu
    return tp, jp, tweights.infer_arch(tp)


@pytest.mark.parametrize("fname", WEIGHT_FILES)
def test_matnet_logits_match_jax(fname):
    """Every weight file whose arch loads, carried across by
    matnet_state_dict, on a real matrix's images and features."""
    tp, jp, arch = _load(fname)
    J, T = _both(MATS["square"])
    fv = np.asarray(jfeatures.feature_vector(J, J))[:arch["num_features"]]
    img1 = np.asarray(jdensity.density_image_normalized(J))
    img2 = np.asarray(jdensity.density_image_normalized(
        _both(MATS["banded"])[0]))
    want = np.asarray(jmatnet.predict_logits(jp, img1, img2, fv, **arch))
    got = tmatnet.predict_logits(tp, img1, img2, fv, device="cpu", **arch)
    assert got.dtype == torch.float32 and got.shape == (
        arch["num_classes"],)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert int(torch.argmax(got)) == int(np.argmax(want)) == \
        tmatnet.predict_class(tp, img1, img2, fv, device="cpu", **arch)


def test_weight_carry_over_layout():
    """HWIO conv kernels -> OIHW, (in, out) dense kernels -> (out, in),
    and the shipped sets' archs and menus."""
    params, arch = tweights.import_reference_weights("P100")
    assert arch == {"num_features": 18, "num_classes": 3}
    sd = tweights.matnet_state_dict(params)
    k = params["branch1"]["conv2"]["kernel"]             # (5, 5, 16, 16)
    np.testing.assert_array_equal(sd["branch1.conv2.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                  params["head"]["kernel"].T)
    net = tmatnet.MatNet(**arch)
    assert set(sd) == set(net.state_dict())
    assert tweights.matnet_state_dict(sd).keys() == sd.keys()
    _, menu = tweights.load_params_npz(os.path.join(
        tweights.LOCAL_WEIGHTS_DIR, "TPU_upcycled.npz"), with_menu=True)
    assert menu == ("csr", "dia", "ell", "coo", "bitonic")
    with pytest.raises(FileNotFoundError):
        tweights.find_weights("NoSuchCard")


@pytest.mark.parametrize("weight", ["Intel", "Amd", "P100", "TPU"])
@pytest.mark.parametrize("name", ["square", "banded"])
def test_select_algorithm_matches_jax(weight, name):
    J, T = _both(MATS[name])
    js = jauto.select_algorithm(J, J, weight_name=weight)
    ts = tauto.select_algorithm(T, T, weight_name=weight)
    assert (ts.algorithm, ts.class_index) == (js.algorithm, js.class_index)
    np.testing.assert_allclose(ts.logits, np.asarray(js.logits), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(ts.feature_vector,
                               np.asarray(js.feature_vector), rtol=1e-12)


@pytest.fixture(scope="module")
def headline_pair():
    return _both(headline.build_matrix())


# the JAX package's picks on the headline (chip_smoke.py pins the same)
HEADLINE_PICKS = {"Intel": ("baseline", 0), "P100": ("bitonic", 2),
                  "TPU": ("bitonic", 4)}


@pytest.mark.parametrize("weight", sorted(HEADLINE_PICKS))
def test_headline_picks_match_jax(headline_pair, weight):
    J, T = headline_pair
    js = jauto.select_algorithm(J, J, weight_name=weight)
    ts = tauto.select_algorithm(T, T, weight_name=weight)
    assert (ts.algorithm, ts.class_index) == HEADLINE_PICKS[weight] == (
        js.algorithm, js.class_index)
    np.testing.assert_allclose(ts.logits, np.asarray(js.logits), rtol=2e-4,
                               atol=2e-4)


BRANCHES = ("dia", "ell", "coo", "bitonic", "esc", "dense_row", "hash",
            "serve", "compensated", "baseline")


@pytest.mark.parametrize("algo", BRANCHES)
def test_spgemm_auto_every_branch_matches_jax(algo):
    """Each branch forced by a class menu whose entries all name it; the
    port returns a flat CSR on every branch (the JAX package's
    compensated branch returns its SlabCSR: compared through scipy)."""
    a = fixtures.banded_csr(48, bandwidth=2, seed=8).astype(np.float32)
    J, T = _both(a)
    menu = (algo,) * 5
    JC, js = jauto.spgemm_auto(J, J, class_menu=menu)
    TC, ts = tauto.spgemm_auto(T, T, class_menu=menu)
    assert ts.algorithm == js.algorithm == algo
    assert type(TC) is TCSR
    assert int(TC.row_ptr[-1]) == int(TC.nnz)
    want = JC.to_scipy().tocsr()
    got = TC.to_scipy()
    for m in (want, got):
        m.sort_indices()
    assert_same(got.indptr, want.indptr, "indptr")
    assert_same(got.indices, want.indices, "indices")
    assert_values_close(got.data, want.data, "values")
    if algo == "compensated":
        assert TC.values_lo is not None
    tol = 2e-2 if algo == "serve" else 1e-4
    ref = (a.astype(np.float64) @ a.astype(np.float64)).toarray()
    np.testing.assert_allclose(got.toarray(), ref, rtol=tol, atol=tol)


def test_spgemm_auto_guard_falls_back_to_csr(monkeypatch):
    """A dense_row pick past the densify budget runs the csr route."""
    import dataclasses

    from ia_spgemm_tpu_torch import config as tcfg
    a = fixtures.banded_csr(48, bandwidth=2, seed=9).astype(np.float32)
    T = TCSR.from_scipy(a, device="cpu")
    monkeypatch.setattr(tcfg, "DEFAULT_CONFIG", dataclasses.replace(
        tcfg.DEFAULT_CONFIG, dense_bytes_budget=64.0))
    C, sel = tauto.spgemm_auto(T, T, class_menu=("dense_row",) * 5)
    assert sel.algorithm == "dense_row" and type(C) is TCSR
    np.testing.assert_allclose(C.to_scipy().toarray(), (a @ a).toarray(),
                               rtol=1e-5, atol=1e-5)


def test_matnet_same_padding():
    """TensorFlow SAME padding of the stride-2 convolutions: (2, 2) for
    63 -> 32, (1, 2) for 16 -> 8."""
    assert tmatnet._same_pad(63, 5, 2) == (2, 2)
    assert tmatnet._same_pad(16, 5, 2) == (1, 2)
    x = torch.zeros((1, 128, 128, 1))
    net = tmatnet.MatNet()
    assert net(x, x, torch.zeros((1, 26))).shape == (1, 5)


def test_h5_only_weight_set_matches_jax(tmp_path, monkeypatch):
    """A weight set that exists only as the reference's Keras h5 (no npz
    snapshot in weights/): both packages' find_weights fall back to
    REFERENCE_WEIGHTS_DIR, import_reference_weights parses it to the same
    arch and the same arrays, exactly, and select_algorithm makes the
    same pick with it; a name in neither directory raises
    FileNotFoundError in both. The h5 is written here (the P100 set's
    shapes, numpy values); skips where h5py is not installed."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(16)
    shapes, _ = tweights.import_reference_weights("P100")
    want = {}
    with h5py.File(tmp_path / "H5Only_weights.h5", "w") as f:
        def put(tree, layers, out):
            for key, layer in layers.items():
                if isinstance(layer, dict):
                    put(tree[key], layer, out.setdefault(key, {}))
                    continue
                g = f.create_group(layer).create_group(layer)
                out[key] = {}
                for part in ("kernel", "bias"):
                    x = rng.normal(0, 0.1, tree[key][part].shape)
                    g[f"{part}:0"] = out[key][part] = x.astype(np.float32)
        put(shapes, tweights._KERAS_LAYERS, want)
    for mod in (tweights, jweights):
        monkeypatch.setattr(mod, "REFERENCE_WEIGHTS_DIR", str(tmp_path))
        mod.import_reference_weights.cache_clear()
    try:
        path = str(tmp_path / "H5Only_weights.h5")
        assert tweights.find_weights("H5Only") == jweights.find_weights(
            "H5Only") == path
        # a snapshot in weights/ still comes first
        assert tweights.find_weights("P100") == jweights.find_weights(
            "P100")
        tp, tarch = tweights.import_reference_weights("H5Only")
        jp, jarch = jweights.import_reference_weights("H5Only")
        assert tarch == jarch == tweights.infer_arch(shapes)
        leaves = lambda t, p=(): ([(p, t)] if not isinstance(t, dict)  # noqa: E731
                                  else [x for k in sorted(t)
                                        for x in leaves(t[k], p + (k,))])
        assert [k for k, _ in leaves(tp)] == [k for k, _ in leaves(jp)] \
            == [k for k, _ in leaves(want)]
        for (k, t), (_, j), (_, w) in zip(leaves(tp), leaves(jp),
                                          leaves(want)):
            assert t.dtype == np.float32, k
            np.testing.assert_array_equal(t, np.asarray(j), err_msg=str(k))
            np.testing.assert_array_equal(t, w, err_msg=str(k))
        J, T = _both(MATS["square"])
        js = jauto.select_algorithm(J, J, weight_name="H5Only")
        ts = tauto.select_algorithm(T, T, weight_name="H5Only")
        assert (ts.algorithm, ts.class_index) == (js.algorithm,
                                                  js.class_index)
        np.testing.assert_allclose(ts.logits, np.asarray(js.logits),
                                   rtol=2e-4, atol=2e-4)
        for find in (tweights.find_weights, jweights.find_weights):
            with pytest.raises(FileNotFoundError):
                find("NoSuchCard")
    finally:
        for mod in (tweights, jweights):
            mod.import_reference_weights.cache_clear()
