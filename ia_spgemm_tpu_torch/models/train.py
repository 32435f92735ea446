"""MatNet training, the upcycle path (PyTorch port of
``ia_spgemm_tpu.models.train``).

Softmax cross-entropy over (img1, img2, features) -> winning-algorithm
labels harvested from the benchmark harness, with Adam: optax's
``adam`` formula, which ``torch.optim.Adam(lr, betas=(0.9, 0.999),
eps=1e-8)`` computes. The JAX package jits the step and lets GSPMD
average the gradients of a batch sharded over its mesh; here the step is
eager and the data parallelism explicit over a ``parallel.mesh.Mesh``:
each shard takes an equal slice of the batch (the batch must divide by
the shards, as the JAX package's sharding requires), shards may share a
card, the shards' gradients are averaged, and across processes summed
with ``all_reduce`` on the mesh's group. The convolutions run with
cuDNN's TF32 off, as ``matnet.predict_logits`` does.

``train`` returns its parameters as a numpy tree in the JAX layout, so
they save (``weights.save_params_npz``) and serve as the JAX package's
do.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ia_spgemm_tpu_torch.formats.types import DEFAULT_DEVICE, checked_device
from ia_spgemm_tpu_torch.models.matnet import (MatNet, init_params,
                                               no_tf32,
                                               params_from_state_dict)
from ia_spgemm_tpu_torch.models.weights import matnet_state_dict


@dataclasses.dataclass
class TrainConfig:
    num_classes: int = 5
    num_features: int = 26
    learning_rate: float = 1e-3
    batch_size: int = 32
    steps: int = 200
    seed: int = 0


def _tensors(batch, device, sl=slice(None)):
    """(img1, img2, feats, labels)[sl] as float32 / int64 tensors on
    device."""
    *xs, labels = (torch.as_tensor(x)[sl] for x in batch)
    return (*(x.to(device=device, dtype=torch.float32) for x in xs),
            labels.to(device=device, dtype=torch.long))


def loss_and_accuracy(model: MatNet, img1, img2, feats, labels):
    """Mean softmax cross-entropy over integer labels, and the argmax
    accuracy (a detached 0-d tensor)."""
    logits = model(img1, img2, feats)
    loss = F.cross_entropy(logits, labels, reduction="mean")
    acc = (logits.argmax(-1) == labels).float().mean().detach()
    return loss, acc


def make_train_step(model: MatNet, optimizer: torch.optim.Optimizer,
                    mesh=None):
    """train_step(batch) -> (loss, acc): one Adam step of `model` (on
    its own device) over a (img1, img2, feats, labels) batch of numpy
    arrays or tensors. With a mesh, the batch splits over its shards;
    the gradients left in ``model``'s parameters are the average over
    every shard (of every process). loss and acc are 0-d tensors on the
    model's device, averaged the same way."""
    master = next(model.parameters()).device
    replicas: dict = {}     # a copy of the model per other shard device

    def replica(dev):
        """The model's copy on dev, holding this step's weights and no
        gradient."""
        if dev not in replicas:
            replicas[dev] = MatNet(model.num_classes,
                                   model.num_features).to(dev)
        net = replicas[dev]
        with torch.no_grad():
            for p, q in zip(net.parameters(), model.parameters()):
                p.copy_(q)
        net.zero_grad(set_to_none=True)
        return net

    def dp_backward(batch):
        """Forward and backward over the shards (one on the master
        device without a mesh); (mean loss, mean accuracy)."""
        if mesh is None:
            n, shards = 1, [(0, master)]
        else:
            n, shards = mesh.num_shards, zip(mesh.local_shards, mesh.devices)
        size = len(batch[3])
        if size % n:
            raise ValueError(f"batch of {size} does not split over "
                             f"{n} shards")
        per = size // n
        sums = torch.zeros(2, device=master)
        nets = {master: model}
        for j, dev in shards:
            dev = torch.device(dev)
            if dev not in nets:
                nets[dev] = replica(dev)
            net = nets[dev]
            loss, acc = loss_and_accuracy(
                net, *_tensors(batch, dev, slice(j * per, (j + 1) * per)))
            (loss / n).backward()
            sums += torch.stack([loss.detach(), acc]).to(master)
        params = list(model.parameters())
        for net in nets.values():
            if net is model:
                continue
            for p, q in zip(params, net.parameters()):
                g = q.grad.to(master)
                p.grad = g if p.grad is None else p.grad + g
        if mesh is not None and mesh.spans_processes:
            import torch.distributed as dist

            from ia_spgemm_tpu_torch.parallel.mesh import comm_device
            comm = comm_device(mesh)
            flat = torch.cat([p.grad.flatten() for p in params]
                             + [sums]).to(comm)
            dist.all_reduce(flat, group=mesh.group)
            flat = flat.to(master)
            off = 0
            for p in params:
                k = p.grad.numel()
                p.grad.copy_(flat[off:off + k].view_as(p.grad))
                off += k
            sums = flat[off:]
        return sums[0] / n, sums[1] / n

    def train_step(batch):
        optimizer.zero_grad(set_to_none=True)
        with no_tf32():
            loss, acc = dp_backward(batch)
            optimizer.step()
        return loss, acc

    return train_step


def make_model(config: "TrainConfig", params=None, device=None):
    """(MatNet holding `params` (default: init_params(config.seed)) on
    `device`, its Adam optimizer at config.learning_rate)."""
    model = MatNet(num_classes=config.num_classes,
                   num_features=config.num_features)
    if params is None:
        params = init_params(config.seed, config.num_classes,
                             config.num_features)
    model.load_state_dict(matnet_state_dict(params))
    model = model.to(checked_device(DEFAULT_DEVICE if device is None
                                    else device))
    opt = torch.optim.Adam(model.parameters(), lr=config.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    return model, opt


def train(dataset: Iterator[Tuple], config: TrainConfig = TrainConfig(),
          params=None, mesh=None, device=None, log_every: int = 50,
          log=print):
    """Train MatNet. `dataset` yields (img1, img2, feats, labels) batches
    with a leading batch dim; params: a numpy / JAX tree or a state_dict
    (default: init_params(config.seed)). The model lives on `device`
    (default: the mesh's first shard, else the card; with no card it
    raises unless device="cpu"); with a mesh the batch splits over its
    shards. Returns (params as a numpy tree in the JAX layout, history of
    (step, loss, acc) every log_every steps)."""
    if device is None and mesh is not None:
        device = mesh.devices[0]
    model, opt = make_model(config, params, device)
    step_fn = make_train_step(model, opt, mesh)
    history = []
    for step, batch in enumerate(dataset):
        if step >= config.steps:
            break
        loss, acc = step_fn(batch)
        if step % log_every == 0:
            history.append((step, float(loss), float(acc)))
            log(f"step {step}: loss={float(loss):.4f} acc={float(acc):.3f}")
    return params_from_state_dict(model.state_dict()), history


def synthetic_dataset(config: TrainConfig, seed: int = 0):
    """Deterministic synthetic batches for tests: class k's images carry a
    k-dependent block pattern so the task is learnable (the JAX
    package's, draw for draw)."""
    rng = np.random.default_rng(seed)
    while True:
        labels = rng.integers(0, config.num_classes, config.batch_size)
        img1 = rng.random((config.batch_size, 128, 128, 1)).astype(np.float32)
        img2 = rng.random((config.batch_size, 128, 128, 1)).astype(np.float32)
        feats = rng.random((config.batch_size,
                            config.num_features)).astype(np.float32)
        for b, k in enumerate(labels):
            img1[b, 16 * k:16 * k + 16, :16, 0] += 4.0
            feats[b, k % config.num_features] += 4.0
        yield img1, img2, feats, labels.astype(np.int32)
