"""MatNet weights (PyTorch port of ``ia_spgemm_tpu.models.weights``).

The repository's ``weights/`` holds the weight sets as flat npz
snapshots: the reference's shipped sets ``{Intel,Amd,P100}_matnet.npz``
(converted once from its Keras h5 files) and the selectors retrained on
TPU winners, ``TPU_upcycled*.npz``, whose ``__menu__`` entry names the
algorithm of each class. A snapshot loads as a numpy tree in the JAX
package's layout (Flax names; conv kernels HWIO, dense kernels (in,
out)); ``matnet_state_dict`` carries it into the port's MatNet.
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


def infer_arch(params) -> dict:
    """(num_features, num_classes) from the parameter shapes."""
    nf = params["feature_dense"]["kernel"].shape[0]
    nc = params["head"]["kernel"].shape[1]
    return {"num_features": int(nf), "num_classes": int(nc)}


def find_weights(name: str = "Intel") -> str:
    """Path of a shipped weight set in the repository's weights/."""
    p = os.path.join(LOCAL_WEIGHTS_DIR, f"{name}_matnet.npz")
    if os.path.exists(p):
        return p
    raise FileNotFoundError(name)


@functools.lru_cache(maxsize=8)
def import_reference_weights(name: str = "Intel"):
    """A shipped weight set -> (params, arch), loaded once."""
    params = load_params_npz(find_weights(name))
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
