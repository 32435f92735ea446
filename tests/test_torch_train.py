"""PyTorch port, MatNet's training path against the JAX package:
init_params (Flax's tree, names and shapes; lecun_normal kernels, zero
biases), the parameter carry-over both ways, one training step and three
against Flax + optax from JAX's PRNGKey(0) parameters on one
synthetic_dataset batch, the JAX test's learnability criterion, data
parallelism over CPU shards (in one process and over two gloo
processes), the weight files (npz both ways, a Keras h5 the test writes)
and graft_entry's forward pass and dry run.

JAX runs in float32 here (its parameters and batches are float32 under
tests/conftest.py's x64). Tolerances: loss within 1e-5 relative; each
gradient within 1e-4 of its tensor's max |g|; parameters after three
Adam steps within 1e-5; 4 shards against 1 within 1e-5 (the sums are
split differently); init_params's kernel std within 10% of
1/sqrt(fan_in)."""

import math
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ia_spgemm_tpu.models import matnet as jmatnet
from ia_spgemm_tpu.models import train as jtrain
from ia_spgemm_tpu.models import weights as jweights
from ia_spgemm_tpu_torch import graft_entry
from ia_spgemm_tpu_torch.models import matnet as tmatnet
from ia_spgemm_tpu_torch.models import train as ttrain
from ia_spgemm_tpu_torch.models import weights as tweights
from ia_spgemm_tpu_torch.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.fixture(scope="module")
def jax_params():
    return _np_tree(jmatnet.init_params(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", [(5, 26), (3, 18)])
def test_init_params_tree_matches_flax(arch):
    nc, nf = arch
    want = jmatnet.init_params(jax.random.PRNGKey(1), nc, nf)
    got = tmatnet.init_params(1, nc, nf)
    assert jax.tree_util.tree_structure(_np_tree(want)) == \
        jax.tree_util.tree_structure(got)
    for path, w in _leaves(want).items():
        g = _leaves(got)[path]
        assert g.shape == w.shape and g.dtype == np.float32, path
        if path[-1].key == "bias":
            assert not g.any(), path
        else:
            std = 1.0 / math.sqrt(math.prod(g.shape[:-1]))
            assert abs(g.std() / std - 1.0) < 0.10, (path, g.std(), std)
            assert np.abs(g).max() <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert tweights.infer_arch(got) == {"num_features": nf,
                                        "num_classes": nc}


def test_init_params_seeds_and_generators():
    a = tmatnet.init_params(3)
    b = tmatnet.init_params(torch.Generator().manual_seed(3))
    c = tmatnet.init_params(4)
    k = ("branch1", "conv2", "kernel")
    np.testing.assert_array_equal(a[k[0]][k[1]][k[2]], b[k[0]][k[1]][k[2]])
    assert not np.array_equal(a[k[0]][k[1]][k[2]], c[k[0]][k[1]][k[2]])


def test_params_from_state_dict_inverts_the_carry_over(jax_params):
    sd = tweights.matnet_state_dict(jax_params)
    back = tmatnet.params_from_state_dict(sd)
    for path, w in _leaves(jax_params).items():
        np.testing.assert_array_equal(_leaves(back)[path], w)


def _batch(size, seed=0):
    cfg = ttrain.TrainConfig(batch_size=size)
    return next(ttrain.synthetic_dataset(cfg, seed))


def test_synthetic_dataset_is_the_jax_packages():
    cfg = ttrain.TrainConfig(batch_size=4, num_classes=5)
    jcfg = jtrain.TrainConfig(batch_size=4, num_classes=5)
    for t, j in zip(ttrain.synthetic_dataset(cfg, 7),
                    jtrain.synthetic_dataset(jcfg, 7)):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
        break
    assert ttrain.TrainConfig() == ttrain.TrainConfig(
        **vars(jtrain.TrainConfig()))


def _jax_steps(params, batches, lr):
    model = jmatnet.MatNet(num_classes=5, num_features=26)
    tx = optax.adam(lr)
    step = jtrain.make_train_step(model, tx)

    def loss_fn(p, b):
        logits = model.apply({"params": p}, *b[:3])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, b[3]).mean()

    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(p)
    out = []
    for b in batches:
        b = tuple(jnp.asarray(x) for x in b)
        grads = jax.grad(loss_fn)(p, b)
        p, opt, loss, acc = step(p, opt, b)
        out.append((float(loss), float(acc), _np_tree(grads)))
    return _np_tree(p), out


def _port_steps(params, batches, lr, mesh=None):
    cfg = ttrain.TrainConfig(learning_rate=lr)
    model, opt = ttrain.make_model(cfg, params, device="cpu")
    step = ttrain.make_train_step(model, opt, mesh)
    out = []
    for b in batches:
        loss, acc = step(b)
        grads = tmatnet.params_from_state_dict(
            {n: p.grad for n, p in model.named_parameters()})
        out.append((float(loss), float(acc), grads))
    return tmatnet.params_from_state_dict(model.state_dict()), out


def _close_params(got, want, atol):
    for path, w in _leaves(want).items():
        np.testing.assert_allclose(_leaves(got)[path], w, rtol=0,
                                   atol=atol, err_msg=str(path))


def test_one_step_matches_flax_optax(jax_params):
    batch = _batch(8)
    _, [(jl, ja, jg)] = _jax_steps(jax_params, [batch], 1e-3)
    _, [(tl, ta, tg)] = _port_steps(jax_params, [batch], 1e-3)
    assert tl == pytest.approx(jl, rel=1e-5)
    assert ta == ja
    for path, w in _leaves(jg).items():
        g = _leaves(tg)[path]
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, path


def test_three_steps_match_flax_optax(jax_params):
    batches = [_batch(8, seed) for seed in (0, 1, 2)]
    jp, jout = _jax_steps(jax_params, batches, 1e-3)
    tp, tout = _port_steps(jax_params, batches, 1e-3)
    for (jl, _, _), (tl, _, _) in zip(jout, tout):
        assert tl == pytest.approx(jl, rel=1e-5)
    _close_params(tp, jp, 1e-5)


def test_training_learns_synthetic_task():
    """The JAX package's criterion (tests/test_train.py), on the CPU."""
    cfg = ttrain.TrainConfig(steps=60, batch_size=16, learning_rate=3e-3)
    ds = ttrain.synthetic_dataset(cfg, seed=1)
    params, history = ttrain.train(ds, cfg, device="cpu", log_every=20,
                                   log=lambda *_: None)
    assert len(history) >= 2
    assert history[-1][1] < history[0][1] * 0.8
    assert params["head"]["kernel"].shape == (32 + 32 + 26, 5)


def test_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttrain.TrainConfig(steps=1, batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ttrain.train(ttrain.synthetic_dataset(cfg), cfg)


def test_four_cpu_shards_match_one(jax_params):
    batches = [_batch(8, seed) for seed in (3, 4)]
    mesh = make_mesh(devices=["cpu"] * 4)
    p1, out1 = _port_steps(jax_params, batches, 1e-3)
    p4, out4 = _port_steps(jax_params, batches, 1e-3, mesh=mesh)
    for (l1, a1, g1), (l4, a4, g4) in zip(out1, out4):
        assert l4 == pytest.approx(l1, rel=1e-5) and a4 == a1
        for path, w in _leaves(g1).items():
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(_leaves(g4)[path] - w).max()) <= \
                1e-5 * scale, path
    _close_params(p4, p1, 1e-5)
    with pytest.raises(ValueError, match="does not split"):
        _port_steps(jax_params, [_batch(6)], 1e-3, mesh=mesh)


_TWO_PROC = r"""
import sys
sys.modules["jax"] = None
import numpy as np
from ia_spgemm_tpu_torch.models import matnet, train, weights
from ia_spgemm_tpu_torch.parallel import multihost
from ia_spgemm_tpu_torch.parallel.mesh import make_mesh
pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(f"127.0.0.1:{port}", 2, pid, backend="gloo")
mesh = make_mesh(devices=["cpu", "cpu"])
assert mesh.num_shards == 4 and mesh.spans_processes
cfg = train.TrainConfig(batch_size=8)
model, opt = train.make_model(cfg, weights.load_params_npz(out + ".in.npz"),
                              device="cpu")
step = train.make_train_step(model, opt, mesh)
loss, acc = step(next(train.synthetic_dataset(cfg, 5)))
weights.save_params_npz(f"{out}.{pid}.npz", model.state_dict())
print("LOSS", repr(float(loss)), repr(float(acc)))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two_processes(out):
    """Both processes' (returncode, output). The port is free when
    chosen but may be taken again before process 0 listens on it (other
    tests start groups too): then the pair runs again on a new port."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("IA_SPGEMM_SHARDS_PER_DEVICE", None)
    for _ in range(3):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-u", "-c", _TWO_PROC, str(pid), str(port),
             out], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=180)[0])
                if p.returncode and "EADDRINUSE" in outs[-1]:
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if len(outs) == 2:
            return [(p.returncode, text) for p, text in zip(procs, outs)]
    raise AssertionError(f"no free port after 3 tries:\n{outs[0]}")


def test_two_gloo_processes_match_one_shard(tmp_path, jax_params):
    out = str(tmp_path / "dp")
    tweights.save_params_npz(out + ".in.npz", jax_params)
    runs = _run_two_processes(out)
    for pid, (rc, text) in enumerate(runs):
        assert rc == 0, f"proc {pid}:\n{text}"
    cfg = ttrain.TrainConfig(batch_size=8)
    p1, [(l1, a1, _)] = _port_steps(
        jax_params, [next(ttrain.synthetic_dataset(cfg, 5))], 1e-3)
    for pid, (_, text) in enumerate(runs):
        line = [ln for ln in text.splitlines() if ln.startswith("LOSS")][0]
        loss, acc = (float(x) for x in line.split()[1:])
        assert loss == pytest.approx(l1, rel=1e-5) and acc == a1
        _close_params(tweights.load_params_npz(f"{out}.{pid}.npz"), p1,
                      1e-5)


def test_save_params_npz_round_trips_both_packages(tmp_path, jax_params):
    menu = ("bitonic", "esc", "dia", "dense_row", "dense")
    sd = tweights.matnet_state_dict(jax_params)
    for src in (jax_params, sd):
        path = str(tmp_path / "t.npz")
        tweights.save_params_npz(path, src, menu=menu)
        for load in (tweights.load_params_npz, jweights.load_params_npz):
            back, m = load(path, with_menu=True)
            assert m == menu
            _close_params(_np_tree(back), jax_params, 0.0)
    jpath = str(tmp_path / "j.npz")
    jweights.save_params_npz(jpath, jax_params, menu=menu)
    with np.load(jpath) as j, np.load(str(tmp_path / "t.npz")) as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k])


def test_load_keras_h5_matches_jax(tmp_path, jax_params):
    """On a Keras-layout h5 file the test writes (the repository ships
    none); skips where h5py is not installed."""
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "w.h5")
    layers = {"branch1": ("conv2d_1", "conv2d_2", "conv2d_3", "dense_2"),
              "branch2": ("conv2d_4", "conv2d_5", "conv2d_6", "dense_3")}
    with h5py.File(path, "w") as f:
        def put(name, p):
            g = f.create_group(name).create_group(name)
            g["kernel:0"] = p["kernel"]
            g["bias:0"] = p["bias"]
        for br, names in layers.items():
            for sub, name in zip(("conv1", "conv2", "conv3", "dense"), names):
                put(name, jax_params[br][sub])
        put("dense_1", jax_params["feature_dense"])
        put("dense_4", jax_params["head"])
    got = tweights.load_keras_h5(path)
    _close_params(got, jax_params, 0.0)
    _close_params(got, _np_tree(jweights.load_keras_h5(path)), 0.0)


def test_load_keras_h5_without_h5py_says_so(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py"):
        tweights.load_keras_h5("any.h5")


def test_graft_entry_forward_matches_jax(jax_params):
    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (4, 5) and bool(torch.isfinite(out).all())
    params = tweights.matnet_state_dict(jax_params)
    x = _batch(4)
    got = fn(params, *(torch.from_numpy(a) for a in x[:3]))
    want = jmatnet.MatNet().apply({"params": jax_params},
                                  *(jnp.asarray(a) for a in x[:3]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_dryrun_multichip_on_cpu_shards(capsys):
    out = graft_entry.dryrun_multichip(4, device="cpu")
    assert np.isfinite(out["loss"])
    assert out["dist_err"] < 1e-4 and out["ring_err"] < 1e-3
    assert graft_entry.main(["2", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "entry forward: (4, 5)" in text
    assert "dryrun_multichip(2) on cpu" in text and "- OK" in text
