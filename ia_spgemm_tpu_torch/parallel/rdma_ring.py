"""The ring's block hop (PyTorch port of
``ia_spgemm_tpu.parallel.rdma_ring``): wrapper, plain version, count.

=====  ==============  =============================================
 K13   ring_hop_rdma   parallel/rdma_ring.py:31 _hop_kernel
=====  ==============  =============================================

(file:line of the JAX package.) One ring step moves every shard's block
to its left neighbour: shard d receives the block of shard (d + 1) % D,
the permutation ``[(i, (i - 1) % D)]`` of the JAX ring. The JAX kernel
pushed a chip's block by remote DMA after a barrier with both
neighbours. ``ring_hop_rdma`` allocates every receiver's fresh output
first (the barrier's job), then launches the hand-written kernel of
``csrc/ring.cu`` once per source card: one launch carries all the blocks
of every array it is given (the ring passes a step's column and value
blocks together). On one card stream order orders it; with several
cards in one process the source card stores into peer memory, after
peer access is enabled, with events ordering the receiver's allocation,
the push and the receiver's use. On CPU tensors the plain version runs
(``ring_hop_plain``, a copy per block). There is no fallback: a failed
build or launch, or cards that cannot reach each other, raise. Across
processes the ring hops through ``torch.distributed`` instead
(``parallel/ring.py``), never through this kernel.
"""

from __future__ import annotations

import torch

from ia_spgemm_tpu_torch.ops.bitonic_kernels import _cuda_or_raise, _launch


def _targets(arrays, devices):
    """The receivers' devices (default: each block's own), after checking
    that every array has one contiguous block per shard and that the
    blocks lie all on the host or all on cards."""
    if not arrays or not arrays[0]:
        raise ValueError("ring hop of no blocks")
    D = len(arrays[0])
    devices = ([b.device for b in arrays[0]] if devices is None
               else [torch.device(d) for d in devices])
    if len(devices) != D:
        raise ValueError(f"{len(devices)} devices for {D} shards")
    kinds = {d.type for d in devices}
    for arr in arrays:
        if len(arr) != D:
            raise ValueError(f"arrays of {len(arr)} and {D} blocks")
        for b in arr:
            if not b.is_contiguous():
                raise ValueError("ring hop blocks must be contiguous")
            kinds.add(b.device.type)
    if len(kinds) != 1:
        raise ValueError(f"blocks and receivers on {sorted(kinds)}: all "
                         "on the host or all on cards")
    return devices


def ring_hop_plain(*arrays, devices=None):
    """out[d] = blocks[(d + 1) % D], a fresh copy on devices[d], for each
    array of per-shard blocks; returns one list per array."""
    devices = _targets(arrays, devices)
    D = len(devices)
    return [[arr[(d + 1) % D].to(devices[d], copy=True) for d in range(D)]
            for arr in arrays]


def _enable_peer(src: torch.device, dst: torch.device):
    from ia_spgemm_tpu_torch import _build
    if not torch.cuda.can_device_access_peer(src, dst):
        raise RuntimeError(f"{src} cannot reach {dst} (no peer access)")
    with torch.cuda.device(src):
        err = _build.load()["ia_k13_enable_peer_access"](dst.index)
    if err != 0:
        raise RuntimeError(f"enabling peer access {src} -> {dst}: CUDA "
                           f"error {err}")


def _push(src_dev: torch.device, pairs):
    """One K13 launch on src_dev's current stream copying every (source,
    destination) pair; destinations on other cards are ordered by
    events and kept alive for the push by record_stream."""
    remote = sorted({d.device for _, d in pairs if d.device != src_dev},
                    key=str)
    stream = torch.cuda.current_stream(src_dev)
    for rdev in remote:
        _enable_peer(src_dev, rdev)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(rdev))
        stream.wait_event(ready)      # the receiver's buffer is allocated
    sizes = [s.numel() * s.element_size() for s, _ in pairs]
    with torch.cuda.device(src_dev):
        table = torch.tensor([[s.data_ptr(), d.data_ptr(), n]
                              for (s, d), n in zip(pairs, sizes)],
                             dtype=torch.int64).to(src_dev)
    _launch("ia_k13_ring_hop", table, len(pairs), max(sizes),
            device=src_dev)
    for rdev in remote:
        done = torch.cuda.Event()
        done.record(stream)
        torch.cuda.current_stream(rdev).wait_event(done)   # push landed
    for _, d in pairs:
        if d.device != src_dev:
            d.record_stream(stream)


def ring_hop_rdma(*arrays, devices=None):
    """K13: one ring step for each array of per-shard blocks (block d on
    shard d's device): returns one list per array whose entry d is a
    fresh tensor on devices[d] (default: block d's device) holding block
    (d + 1) % D."""
    devices = _targets(arrays, devices)
    if devices[0].type == "cpu":
        return ring_hop_plain(*arrays, devices=devices)
    D = len(devices)
    outs = []
    by_src = {}
    for arr in arrays:
        out = []
        for d in range(D):
            src = arr[(d + 1) % D]
            _cuda_or_raise(src)
            dst = torch.empty(src.shape, dtype=src.dtype, device=devices[d])
            out.append(dst)
            if src.numel():
                by_src.setdefault(src.device, []).append((src, dst))
        outs.append(out)
    for src_dev, pairs in by_src.items():
        _push(src_dev, pairs)
        ring_hop_rdma.launches += 1
    return outs


def rdma_available(mesh) -> bool:
    """use_rdma='auto' gate: a mesh of more than one shard, in one
    process, whose every shard lies on a CUDA card that the others can
    reach (the same card, or peer access)."""
    devs = set(getattr(mesh, "devices", ()))
    if (getattr(mesh, "spans_processes", True) or mesh.num_shards < 2
            or any(d.type != "cuda" for d in devs)):
        return False
    return all(a == b or torch.cuda.can_device_access_peer(a, b)
               for a in devs for b in devs)


KERNELS = {"K13": ring_hop_rdma}
ring_hop_rdma.launches = 0


def reset_launch_counts():
    ring_hop_rdma.launches = 0


def launch_counts() -> dict:
    return {"K13": ring_hop_rdma.launches}
