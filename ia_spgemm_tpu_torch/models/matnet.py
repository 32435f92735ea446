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
Pallas kernel; it runs in float32 on the device of its inputs, with
cuDNN's TF32 off so the convolutions keep float32 precision.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# CPU-build class menu (README.md:5-8) and GPU-build menu (main.cu:539-544).
CPU_CLASSES = ("mkl", "csr", "dia", "ell", "coo")
GPU_CLASSES = ("cusp", "cusparse", "nsparse")


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
    the device of img1 when it is a tensor, else the CPU)."""
    if device is None:
        device = img1.device if isinstance(img1, torch.Tensor) else "cpu"
    net = module_for(params, device, num_classes=num_classes,
                     num_features=num_features)
    x1 = _as_f32(img1, device, (1, 128, 128, 1))
    x2 = _as_f32(img2, device, (1, 128, 128, 1))
    f = _as_f32(feats, device, (1, num_features))
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        return net(x1, x2, f)[0]


def predict_class(params, img1, img2, feats, *, num_classes=5,
                  num_features=26, device=None) -> int:
    """argmax class, the reference's Pred() return (MatNet.py:92-96)."""
    return int(torch.argmax(predict_logits(
        params, img1, img2, feats, num_classes=num_classes,
        num_features=num_features, device=device)))
