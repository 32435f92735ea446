"""MatNet, the input-aware algorithm selector, as a ``torch.nn.Module``
(PyTorch port of ``ia_spgemm_tpu.models.matnet``).

Topology of the reference's Keras graph (MatNet.py:45-79), as the JAX
package's Flax module has it:

per image branch (x2):
  Conv 16@3x3 valid stride 1 tanh -> MaxPool 2x2          128 -> 126 -> 63
  Conv 16@5x5 stride 2 SAME tanh  -> MaxPool 2x2           63 -> 32 -> 16
  Conv 16@5x5 stride 2 SAME tanh  -> MaxPool 2x2           16 -> 8 -> 4
  Flatten in HWC order (4*4*16 = 256) -> Dense 32 tanh
feature branch: Dense(nf -> nf) tanh      (nf = 26 CPU weights, 18 GPU)
head: Concat(32 + 32 + nf) -> Dense(num_classes)   (logits)

TensorFlow's SAME padding with stride 2 can be asymmetric: conv2
(63 -> 32) pads (2, 2), conv3 (16 -> 8) pads (1, 2), top/left first; the
padding is explicit (``F.pad``). The public functions keep the JAX
layout: images (128, 128) or (B, 128, 128, 1), HWC. MatNet has no
Pallas kernel; it runs in float32 on the device of its inputs (the
card when they are not tensors), with cuDNN's TF32 off so the
convolutions keep float32 precision.

``init_params`` draws a fresh parameter tree in the JAX layout, and
``params_from_state_dict`` carries a trained module's state back into
it, so weights trained here save as the JAX package's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ia_spgemm_tpu_torch.formats.types import DEFAULT_DEVICE, checked_device

# CPU-build class menu (README.md:5-8) and GPU-build menu (main.cu:539-544).
CPU_CLASSES = ("mkl", "csr", "dia", "ell", "coo")
GPU_CLASSES = ("cusp", "cusparse", "nsparse")


def no_tf32():
    """cuDNN in float32 (TF32 off), the precision the JAX package's
    convolutions keep on the CPU; inference and training both run under
    it."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _same_pad(size: int, kernel: int, stride: int) -> tuple:
    """TensorFlow SAME padding (before, after) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ImageBranch(nn.Module):
    """One density-image CNN branch; NCHW inside."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 16, 3)
        self.conv2 = nn.Conv2d(16, 16, 5, stride=2)
        self.conv3 = nn.Conv2d(16, 16, 5, stride=2)
        self.dense = nn.Linear(256, 32)

    @staticmethod
    def _conv_same(conv, x):
        (t, b), (left, r) = (_same_pad(x.shape[2], 5, 2),
                             _same_pad(x.shape[3], 5, 2))
        return conv(F.pad(x, (left, r, t, b)))

    def forward(self, x):                       # x: (B, 1, 128, 128)
        x = F.max_pool2d(torch.tanh(self.conv1(x)), 2, 2)
        x = F.max_pool2d(torch.tanh(self._conv_same(self.conv2, x)), 2, 2)
        x = F.max_pool2d(torch.tanh(self._conv_same(self.conv3, x)), 2, 2)
        # flatten in HWC order, as the Flax/Keras graph does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.tanh(self.dense(x))


class MatNet(nn.Module):
    def __init__(self, num_classes: int = 5, num_features: int = 26):
        super().__init__()
        self.num_classes = num_classes
        self.num_features = num_features
        self.branch1 = ImageBranch()
        self.branch2 = ImageBranch()
        self.feature_dense = nn.Linear(num_features, num_features)
        self.head = nn.Linear(32 + 32 + num_features, num_classes)

    def forward(self, img1, img2, feats):
        """img1/img2: (B, 128, 128, 1) normalized x255/max; feats:
        (B, nf). Returns (B, num_classes) logits."""
        b1 = self.branch1(img1.permute(0, 3, 1, 2))
        b2 = self.branch2(img2.permute(0, 3, 1, 2))
        f = torch.tanh(self.feature_dense(feats))
        return self.head(torch.cat([b1, b2, f], dim=-1))


# Modules built from a parameter tree, keyed by (id(tree), device); each
# entry pins its tree, so an id is not reused while it is cached.
_MODULES: dict = {}
_MODULES_MAX = 4


def module_for(params, device, *, num_classes: int, num_features: int
               ) -> MatNet:
    """The MatNet holding `params` (a numpy / JAX parameter tree or a
    state_dict of this module) on `device`, built once per tree."""
    from ia_spgemm_tpu_torch.models.weights import matnet_state_dict
    key = (id(params), str(device), num_classes, num_features)
    hit = _MODULES.get(key)
    if hit is not None:
        return hit[0]
    net = MatNet(num_classes=num_classes, num_features=num_features)
    net.load_state_dict(matnet_state_dict(params))
    net = net.to(device).eval()
    if len(_MODULES) >= _MODULES_MAX:
        _MODULES.pop(next(iter(_MODULES)))
    _MODULES[key] = (net, params)
    return net


def _as_f32(x, device, shape):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32).reshape(shape)


def predict_logits(params, img1, img2, feats, *, num_classes=5,
                   num_features=26, device=None) -> torch.Tensor:
    """(num_classes,) float32 logits for one input, on `device` (default:
    the device of img1 when it is a tensor, else the card, which raises
    when there is none; pass device="cpu" for the host)."""
    if device is None:
        device = (img1.device if isinstance(img1, torch.Tensor)
                  else DEFAULT_DEVICE)
    device = checked_device(device)
    net = module_for(params, device, num_classes=num_classes,
                     num_features=num_features)
    x1 = _as_f32(img1, device, (1, 128, 128, 1))
    x2 = _as_f32(img2, device, (1, 128, 128, 1))
    f = _as_f32(feats, device, (1, num_features))
    with torch.no_grad(), no_tf32():
        return net(x1, x2, f)[0]


def predict_class(params, img1, img2, feats, *, num_classes=5,
                  num_features=26, device=None) -> int:
    """argmax class, the reference's Pred() return (MatNet.py:92-96)."""
    return int(torch.argmax(predict_logits(
        params, img1, img2, feats, num_classes=num_classes,
        num_features=num_features, device=device)))


# Flax's default kernel initializer, lecun_normal: a normal truncated to
# two standard deviations, with variance 1 / fan_in after the
# truncation; this divisor (the std of a unit normal truncated to
# [-2, 2]) is Flax's correction for it.
_TRUNC_STD = 0.87962566103423978

# (name, kernel shape) of each parameter tree leaf group, in the JAX
# layout: conv kernels HWIO, dense kernels (in, out).
_BRANCH_LAYERS = (("conv1", (3, 3, 1, 16)), ("conv2", (5, 5, 16, 16)),
                  ("conv3", (5, 5, 16, 16)), ("dense", (256, 32)))


def _lecun_normal(shape, generator) -> np.ndarray:
    fan_in = math.prod(shape[:-1])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)
    return w.numpy()


def init_params(seed_or_generator=0, num_classes: int = 5,
                num_features: int = 26) -> dict:
    """A fresh MatNet parameter tree (numpy, float32) in the JAX
    package's layout: Flax names, conv kernels HWIO, dense kernels (in,
    out). Kernels are Flax's default lecun_normal, biases zero.

    Drawn on the host from a ``torch.Generator`` (or one seeded with the
    given int): the distributions are Flax's, the draws are not bit-equal
    to ``jax.random.PRNGKey``'s."""
    g = seed_or_generator
    if not isinstance(g, torch.Generator):
        g = torch.Generator().manual_seed(int(g))

    def layer(shape):
        return {"kernel": _lecun_normal(shape, g),
                "bias": np.zeros(shape[-1], np.float32)}

    params = {br: {name: layer(shape) for name, shape in _BRANCH_LAYERS}
              for br in ("branch1", "branch2")}
    params["feature_dense"] = layer((num_features, num_features))
    params["head"] = layer((32 + 32 + num_features, num_classes))
    return params


def params_from_state_dict(state_dict) -> dict:
    """The inverse of ``weights.matnet_state_dict``: a MatNet state_dict
    -> numpy tree in the JAX layout (OIHW -> HWIO, (out, in) -> (in,
    out)). Any tensors keyed like the state_dict convert, gradients
    included."""
    out: dict = {}
    for key, t in state_dict.items():
        *path, kind = key.split(".")
        x = t.detach().to("cpu", torch.float32).numpy()
        if kind == "weight":
            x = x.transpose(2, 3, 1, 0) if x.ndim == 4 else x.T
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node["kernel" if kind == "weight" else "bias"] = \
            np.ascontiguousarray(x)
    return out
