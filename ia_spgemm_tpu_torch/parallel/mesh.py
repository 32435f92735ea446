"""The shard mesh (PyTorch port of ``ia_spgemm_tpu.parallel.mesh``).

The JAX package names its shards by ``jax.sharding.Mesh`` devices and
gets several on one host from ``--xla_force_host_platform_device_count``.
Here a mesh is an explicit list of ``torch.device``s, one per shard of
this process, in which a device may repeat: shards that share a card run
one after another on it, which is how one card (or the CPU) stands in
for several. ``IA_SPGEMM_SHARDS_PER_DEVICE`` (default 1) plays the XLA
flag's part: every visible device counts that many times.

A mesh may span processes (``parallel.multihost.initialize``): every
process then holds the same number of shards, process r the global
shards ``[r * L, (r + 1) * L)``, and ``group`` is the process group the
collectives run over.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import torch

SHARDS_PER_DEVICE_ENV = "IA_SPGEMM_SHARDS_PER_DEVICE"


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]   # this process's shards, in order
    axis_name: str = "x"
    num_shards: int = 0                 # over all processes (0: local)
    first_shard: int = 0                # global index of devices[0]
    group: object = None                # process group, None in one process

    def __post_init__(self):
        if not self.num_shards:
            object.__setattr__(self, "num_shards", len(self.devices))

    @property
    def local_shards(self) -> range:
        """Global indices of this process's shards."""
        return range(self.first_shard, self.first_shard + len(self.devices))

    @property
    def spans_processes(self) -> bool:
        return self.group is not None


def shards_per_device() -> int:
    n = int(os.environ.get(SHARDS_PER_DEVICE_ENV, "1"))
    if n < 1:
        raise ValueError(f"{SHARDS_PER_DEVICE_ENV}={n} must be >= 1")
    return n


def visible_devices(device_type: str = "cuda") -> list:
    """This process's devices, each repeated shards_per_device() times.

    "cuda": every card, or in a process group with the NCCL backend the
    one card of this process (rank modulo the card count); "cpu": the
    host."""
    import torch.distributed as dist

    if device_type == "cpu":
        devs = [torch.device("cpu")]
    elif device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA GPU is available (use the cpu "
                               "device type for the plain versions)")
        n = torch.cuda.device_count()
        if dist.is_initialized() and dist.get_backend() == "nccl":
            devs = [torch.device("cuda", dist.get_rank() % n)]
        else:
            devs = [torch.device("cuda", i) for i in range(n)]
    else:
        raise ValueError(f"unknown device type {device_type!r}")
    k = shards_per_device()
    return [d for d in devs for _ in range(k)]


def make_mesh(num_devices: int | None = None, axis_name: str = "x",
              devices=None, device_type: str = "cuda") -> Mesh:
    """A mesh of num_devices shards (default: every visible shard).

    ``devices``: this process's shard devices, given explicitly (a
    device may repeat, e.g. ``[cuda:0] * 4``); default
    ``visible_devices(device_type)``. Asking for more shards than there
    are raises, as the JAX package does. In a process group the mesh
    takes every process's shards."""
    import torch.distributed as dist

    devs = [torch.device(d) for d in
            (visible_devices(device_type) if devices is None else devices)]
    if dist.is_initialized() and dist.get_world_size() > 1:
        world, rank = dist.get_world_size(), dist.get_rank()
        total = world * len(devs)
        n = num_devices or total
        if n != total:
            raise ValueError(f"asked for {n} shards; a mesh over {world} "
                             f"processes takes all {total}")
        return Mesh(tuple(devs), axis_name, total, rank * len(devs),
                    dist.group.WORLD)
    n = num_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, have {len(devs)}")
    return Mesh(tuple(devs[:n]), axis_name)


def comm_device(mesh: Mesh) -> torch.device:
    """Where a collective's tensors must lie: the host for gloo (it has
    no CUDA collectives, so card tensors cross as host copies), this
    process's first device otherwise."""
    import torch.distributed as dist
    if dist.get_backend(mesh.group) == "gloo":
        return torch.device("cpu")
    return mesh.devices[0]


def gather_shards(mesh: Mesh, tensors, device) -> torch.Tensor:
    """Every shard's tensor (equal shapes), stacked (D, ...) on device:
    a stack of this process's shards in one process, an all_gather over
    the group (the counterpart of ``lax.all_gather``) across processes.
    ``tensors`` are this process's shards' tensors, in shard order."""
    if not mesh.spans_processes:
        return torch.stack([t.to(device) for t in tensors])
    import torch.distributed as dist
    comm = comm_device(mesh)
    local = torch.stack([t.to(comm) for t in tensors])
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts).to(device)


def card_identities(mesh: Mesh) -> list:
    """Every process's card identities, in rank order (an
    ``all_gather_object`` over the mesh's group: COLLECTIVE). Each is a
    dict: "cards", the UUID of each of the process's shards' devices
    (None for a host shard); "visible", the UUIDs of the cards it sees,
    by index; "peer", the (i, j) index pairs of those cards where i can
    reach j's memory."""
    import torch.distributed as dist

    def uuid(dev) -> str | None:
        dev = torch.device(dev)
        return (str(torch.cuda.get_device_properties(dev).uuid)
                if dev.type == "cuda" else None)

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    mine = {"cards": [uuid(d) for d in mesh.devices],
            "visible": [uuid(torch.device("cuda", i)) for i in range(n)],
            "peer": [(i, j) for i in range(n) for j in range(n)
                     if i != j and torch.cuda.can_device_access_peer(i, j)]}
    every = [None] * dist.get_world_size(mesh.group)
    dist.all_gather_object(every, mine, group=mesh.group)
    return every
