"""The ring's block hop (PyTorch port of
``ia_spgemm_tpu.parallel.rdma_ring``): wrapper, plain version, count.

=====  ==============  =============================================
 K13   ring_hop_rdma   parallel/rdma_ring.py:31 _hop_kernel
=====  ==============  =============================================

(file:line of the JAX package.) One ring step moves every shard's block
to its left neighbour: shard d receives the block of shard (d + 1) % D,
the permutation ``[(i, (i - 1) % D)]`` of the JAX ring. The JAX kernel
pushed a chip's block by remote DMA after a barrier with both
neighbours. Here the receivers exist before the launch (the barrier's
job): a public call allocates them (one buffer per array and device),
and the ring passes two sets made once per ring call
(``alloc_receivers``) and alternates them. ``ring_hop_rdma`` then
launches the hand-written kernel of ``csrc/ring.cu`` once per source
card (and per 128 copies): the (source, destination, bytes) table goes
in as a kernel parameter, so a call makes no host-to-device copy, and
the checks of a layout of blocks run once and are cached. On one card
stream order orders the hop; with several cards in one process the
source card stores into peer memory, after peer access is enabled (once
per pair), with events ordering the receivers' earlier use, the push and
their next use. On CPU tensors the plain version runs (``ring_hop_plain``,
a copy per block). There is no fallback: a failed build or launch, or
cards that cannot reach each other, raise. Across processes the ring
hops through ``torch.distributed`` instead (``parallel/ring.py``), never
through this kernel.
"""

from __future__ import annotations

import weakref
from array import array
from itertools import chain

import torch

from ia_spgemm_tpu_torch import _build

MAX_COPIES = 128    # copies one launch carries (csrc/ring.cu kMaxCopies)


class Receivers(list):
    """Per array, the receivers of one ring step (entry d on shard d's
    device, shaped like block (d + 1) % D), made by ``alloc_receivers``
    for one layout of blocks; ``ring_hop_rdma(..., out=)`` and
    ``ring_hop_plain(..., out=)`` write into them and return these lists.
    ``layout`` is the layout they were made for; ``own`` the layout of
    the receivers themselves, so that a hop whose blocks are the lists of
    an earlier hop's receivers skips computing it."""

    layout: tuple = ()
    own: tuple | None = None


class _Views(list):
    """One array's receivers; ``owner`` a weak reference to their
    Receivers (a strong one would make a cycle, and the cycle would keep
    a public call's receivers, and their memory, alive until the garbage
    collector runs)."""

    owner = staticmethod(lambda: None)


_LAYOUTS: dict = {}     # layout key -> _layout's tuple
_MAX_LAYOUTS = 64


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


def _layout(arrays, devices):
    """(layout key, receiver devices, copy plan, receiver plan, same),
    checked once per layout of blocks and cached. The copy plan maps each
    source device to its copies: the source blocks' and the receivers'
    positions in the arrays laid end to end, a table of (0, 0, bytes)
    triples to fill with their pointers, and the receivers on other
    devices; zero-byte blocks are left out. The receiver plan gives each
    array's buffers: (device, receivers, shape, type), one buffer per
    device where the array's blocks share shape and type, one per block
    otherwise. ``same``: the receivers have this layout themselves."""
    owner = (arrays[0].owner() if arrays and isinstance(arrays[0], _Views)
             else None)
    if (devices is None and owner is not None and owner.own is not None
            and len(arrays) == len(owner)
            and all(a is b for a, b in zip(arrays, owner))):
        return owner.own
    key = (tuple((b.shape, b.stride(), b.dtype, b.device)
                 for arr in arrays for b in arr),
           tuple(map(len, arrays)),
           None if devices is None else tuple(map(str, devices)))
    hit = _LAYOUTS.get(key)
    if hit is None:
        targets = _targets(arrays, devices)
        if targets[0].type not in ("cpu", "cuda"):
            raise ValueError(f"no kernel for device {targets[0]}")
        if len(_LAYOUTS) >= _MAX_LAYOUTS:
            _LAYOUTS.clear()
        D = len(targets)
        plan = {}
        for a, arr in enumerate(arrays):
            for d in range(D):
                src = arr[(d + 1) % D]
                n = src.numel() * src.element_size()
                if n:
                    srcs, dsts, table, remote = plan.setdefault(
                        src.device, ([], [], [], []))
                    srcs.append(a * D + (d + 1) % D)
                    dsts.append(a * D + d)
                    table += (0, 0, n)
                    if targets[d] != src.device:
                        remote.append(a * D + d)
        recv, same = [], devices is None
        for arr in arrays:
            if len({(b.shape, b.dtype) for b in arr}) == 1:
                by_dev = {}
                for d, dev in enumerate(targets):
                    by_dev.setdefault(dev, []).append(d)
                recv.append([(dev, ds, arr[0].shape, arr[0].dtype)
                             for dev, ds in by_dev.items()])
                same = same and all(b.device == t
                                    for b, t in zip(arr, targets))
            else:
                recv.append([(dev, [d], arr[(d + 1) % D].shape,
                              arr[(d + 1) % D].dtype)
                             for d, dev in enumerate(targets)])
                same = False
        hit = (key, targets, plan, recv, same)
        _LAYOUTS[key] = hit
    return hit


def alloc_receivers(*arrays) -> Receivers:
    """Uninitialised receivers for one ring step of these blocks (each
    shard's on its own block's device): per array, one (shards on the
    device, *block shape) buffer per device whose views are the entries
    (one tensor per block where the array's blocks differ in shape or
    type)."""
    return _alloc(_layout(arrays, None))


def _alloc(hit) -> Receivers:
    """alloc_receivers for a layout already looked up."""
    key, targets, _, recv, same = hit
    outs = Receivers()
    owner = weakref.ref(outs)
    for groups in recv:
        if len(groups) == 1:        # one buffer: its views in shard order
            dev, ds, shape, dtype = groups[0]
            out = _Views(torch.empty((len(ds), *shape), dtype=dtype,
                                     device=dev).unbind(0))
        else:
            out = _Views([None] * len(targets))
            for dev, ds, shape, dtype in groups:
                for d, view in zip(ds, torch.empty(
                        (len(ds), *shape), dtype=dtype,
                        device=dev).unbind(0)):
                    out[d] = view
        out.owner = owner
        outs.append(out)
    outs.layout = key
    outs.own = hit if same else _layout(tuple(outs), None)
    return outs


def _check_out(out, key):
    if not isinstance(out, Receivers) or not (
            out.layout is key or out.layout == key):
        raise ValueError("out= takes the Receivers that alloc_receivers "
                         "made for this layout of blocks")


def ring_hop_plain(*arrays, devices=None, out=None):
    """out[d] = blocks[(d + 1) % D] for each array of per-shard blocks,
    a fresh copy on devices[d], or a copy into the given receivers
    (``alloc_receivers``); returns one list per array."""
    if out is None:
        devices = _targets(arrays, devices)
        D = len(devices)
        return [[arr[(d + 1) % D].to(devices[d], copy=True)
                 for d in range(D)] for arr in arrays]
    _check_out(out, _layout(arrays, devices)[0])
    for arr, o in zip(arrays, out):
        for d, dst in enumerate(o):
            dst.copy_(arr[(d + 1) % len(arr)])
    return list(out)


def pack_launches(flat):
    """(source pointer, destination pointer, bytes) triples, flattened
    (three ints per copy) -> the host tables of K13's launches: a list of
    (int64 array, copies), at most MAX_COPIES copies each, in order."""
    if len(flat) % 3:
        raise ValueError(f"{len(flat)} ints are not whole triples")
    step = 3 * MAX_COPIES
    return [(array("q", flat[i:i + step]), len(flat[i:i + step]) // 3)
            for i in range(0, len(flat), step)]


_PEERS: set = set()     # (source, destination) pairs with peer access on


def _enable_peer(src: torch.device, dst: torch.device):
    if (src, dst) in _PEERS:
        return
    if not torch.cuda.can_device_access_peer(src, dst):
        raise RuntimeError(f"{src} cannot reach {dst} (no peer access)")
    with torch.cuda.device(src):
        err = _build.load()["ia_k13_enable_peer_access"](dst.index)
    if err != 0:
        raise RuntimeError(f"enabling peer access {src} -> {dst}: CUDA "
                           f"error {err}")
    _PEERS.add((src, dst))


def _launch_k13(tables, stream):
    fn = _build.load()["ia_k13_ring_hop"]
    for table, n in tables:
        err = fn(table.buffer_info()[0], n, stream)
        if err != 0:
            raise RuntimeError(f"ia_k13_ring_hop launch failed: CUDA error "
                               f"{err}")
        ring_hop_rdma.launches += 1


def _push(src_dev: torch.device, flat, remote_dsts):
    """K13 launches on src_dev's current stream copying every (source,
    destination, bytes) triple of ``flat``; destinations on other cards
    are ordered by events and kept alive for the push by
    record_stream."""
    remote = sorted({d.device for d in remote_dsts}, key=str)
    stream = torch.cuda.current_stream(src_dev.index)   # an int: cheaper
    for rdev in remote:
        _enable_peer(src_dev, rdev)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(rdev))
        stream.wait_event(ready)      # the receivers' earlier use is done
    tables = pack_launches(flat)
    if torch.cuda.current_device() == src_dev.index:
        _launch_k13(tables, stream.cuda_stream)
    else:
        with torch.cuda.device(src_dev):
            _launch_k13(tables, stream.cuda_stream)
    for rdev in remote:
        done = torch.cuda.Event()
        done.record(stream)
        torch.cuda.current_stream(rdev).wait_event(done)   # push landed
    for d in remote_dsts:
        d.record_stream(stream)


def ring_hop_rdma(*arrays, devices=None, out=None):
    """K13: one ring step for each array of per-shard blocks (block d on
    shard d's device): returns one list per array whose entry d, on
    devices[d] (default: block d's device), holds block (d + 1) % D.

    Without ``out`` the entries are fresh tensors. ``out`` (the port's
    own callers) is a set of receivers from ``alloc_receivers`` for the
    same layout, written in place and returned. Ordering rule for reused
    receivers: a hop writes its receivers after every operation enqueued
    before it on their devices (stream order on one card; an event per
    receiving card across cards), so the ring's step s may write the set
    that step s - 1 read, alternating two sets."""
    hit = _layout(arrays, devices)
    key, targets, plan, _, _ = hit
    if targets[0].type == "cpu":
        return ring_hop_plain(*arrays, devices=devices, out=out)
    if out is None:
        out = _alloc(hit)
    else:
        _check_out(out, key)
    blocks = list(chain.from_iterable(arrays))
    recv = list(chain.from_iterable(out))
    for src_dev, (srcs, dsts, table, remote) in plan.items():
        flat = table.copy()
        flat[0::3] = [blocks[i].data_ptr() for i in srcs]
        flat[1::3] = [recv[i].data_ptr() for i in dsts]
        _push(src_dev, flat, [recv[i] for i in remote])
    return list(out)


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
