"""MatNet weights (PyTorch port of ``ia_spgemm_tpu.models.weights``).

The repository's ``weights/`` holds the weight sets as flat npz
snapshots: the reference's shipped sets ``{Intel,Amd,P100}_matnet.npz``
(converted once from its Keras h5 files) and the selectors retrained on
TPU winners, ``TPU_upcycled*.npz``, whose ``__menu__`` entry names the
algorithm of each class. A snapshot loads as a numpy tree in the JAX
package's layout (Flax names; conv kernels HWIO, dense kernels (in,
out)); ``matnet_state_dict`` carries it into the port's MatNet.
``save_params_npz`` writes the same flat layout, from a numpy tree or a
state_dict, so the two packages read each other's files.
``load_keras_h5`` reads the reference's Keras h5 files (not shipped
here) where ``h5py`` is installed: ``find_weights`` falls back to
``{name}_weights.h5`` in ``REFERENCE_WEIGHTS_DIR`` for a set that has no
snapshot, as the JAX package does.
"""

from __future__ import annotations

import functools
import os
from typing import Dict

import numpy as np
import torch

LOCAL_WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "weights")
# the reference's NetWeights/ (MatNet.py:81 reads ./NetWeights/
# Intel_weights.h5): IA_SPGEMM_REFERENCE_WEIGHTS where it is set, else
# NetWeights/ beside weights/
REFERENCE_WEIGHTS_DIR = os.environ.get(
    "IA_SPGEMM_REFERENCE_WEIGHTS",
    os.path.join(os.path.dirname(LOCAL_WEIGHTS_DIR), "NetWeights"))


def load_params_npz(path: str, with_menu: bool = False):
    """A flat npz snapshot -> nested numpy tree (and its class menu, None
    when it has none)."""
    params: Dict = {}
    menu = None
    with np.load(path) as data:
        for key in data.files:
            if key == "__menu__":
                menu = tuple(str(x) for x in data[key])
                continue
            node = params
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(data[key])
    return (params, menu) if with_menu else params


def save_params_npz(path: str, params, menu=None) -> None:
    """Flat npz snapshot of a parameter tree (numpy or JAX, the JAX
    layout) or of a MatNet state_dict, which is written in the JAX layout;
    `menu` records the algorithm each class names (``__menu__``)."""
    if "head" not in params:
        from ia_spgemm_tpu_torch.models.matnet import params_from_state_dict
        params = params_from_state_dict(params)
    flat = {}

    def rec(prefix, tree):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                rec(key, v)
            else:
                flat[key] = np.asarray(v)
    rec("", params)
    if menu is not None:
        flat["__menu__"] = np.asarray(list(menu))
    np.savez(path, **flat)


# Keras layer names in the reference's h5 files, in the Keras graph's
# creation order (MatNet.py:45-79), by the tree's names
_KERAS_LAYERS = {
    "branch1": {"conv1": "conv2d_1", "conv2": "conv2d_2",
                "conv3": "conv2d_3", "dense": "dense_2"},
    "branch2": {"conv1": "conv2d_4", "conv2": "conv2d_5",
                "conv3": "conv2d_6", "dense": "dense_3"},
    "feature_dense": "dense_1",
    "head": "dense_4",
}


def load_keras_h5(path: str) -> Dict:
    """A reference weight file (Keras 2.1 HDF5) -> numpy tree in the JAX
    layout. Keras conv kernels are HWIO and dense kernels (in, out), as
    the tree's: no transposition. Needs ``h5py``."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("load_keras_h5 needs h5py, which is not "
                          "installed; the npz snapshots in weights/ load "
                          "without it (load_params_npz)") from e

    def read(f, tree):
        if isinstance(tree, str):
            g = f[tree][tree]
            return {"kernel": np.array(g["kernel:0"], np.float32),
                    "bias": np.array(g["bias:0"], np.float32)}
        return {k: read(f, v) for k, v in tree.items()}

    with h5py.File(path, "r") as f:
        return read(f, _KERAS_LAYERS)


def infer_arch(params) -> dict:
    """(num_features, num_classes) from the parameter shapes."""
    nf = params["feature_dense"]["kernel"].shape[0]
    nc = params["head"]["kernel"].shape[1]
    return {"num_features": int(nf), "num_classes": int(nc)}


def find_weights(name: str = "Intel") -> str:
    """Path of a weight set: the snapshot ``{name}_matnet.npz`` in the
    repository's weights/ first, then the reference's Keras file
    ``{name}_weights.h5`` in REFERENCE_WEIGHTS_DIR."""
    for d, ext in ((LOCAL_WEIGHTS_DIR, "_matnet.npz"),
                   (REFERENCE_WEIGHTS_DIR, "_weights.h5")):
        p = os.path.join(d, f"{name}{ext}")
        if os.path.exists(p):
            return p
    raise FileNotFoundError(name)


@functools.lru_cache(maxsize=8)
def import_reference_weights(name: str = "Intel"):
    """A weight set (``find_weights``) -> (params, arch), loaded once: an
    npz snapshot with load_params_npz, a Keras h5 with load_keras_h5."""
    path = find_weights(name)
    params = (load_params_npz(path) if path.endswith(".npz")
              else load_keras_h5(path))
    return params, infer_arch(params)


def matnet_state_dict(params) -> Dict[str, torch.Tensor]:
    """The weight carry-over: a numpy (or JAX) parameter tree in the JAX
    package's layout -> the state_dict of ``models.matnet.MatNet``.
    Conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in). A
    dict that is already a state_dict is returned as float32 tensors."""
    if "head" not in params:
        return {k: torch.as_tensor(v, dtype=torch.float32)
                for k, v in params.items()}

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def dense(p):
        return {"weight": t(p["kernel"]).T.contiguous(), "bias": t(p["bias"])}

    def conv(p):
        return {"weight": t(p["kernel"]).permute(3, 2, 0, 1).contiguous(),
                "bias": t(p["bias"])}

    out = {}
    for br in ("branch1", "branch2"):
        for name in ("conv1", "conv2", "conv3"):
            for k, v in conv(params[br][name]).items():
                out[f"{br}.{name}.{k}"] = v
        for k, v in dense(params[br]["dense"]).items():
            out[f"{br}.dense.{k}"] = v
    for name in ("feature_dense", "head"):
        for k, v in dense(params[name]).items():
            out[f"{name}.{k}"] = v
    return out
