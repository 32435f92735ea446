"""The ring's block hop (PyTorch port of
``ia_spgemm_tpu.parallel.rdma_ring``): wrappers, plain versions, count.

=====  ==============  =============================================
 K13   ring_hop_rdma   parallel/rdma_ring.py:31 _hop_kernel
       ring_hop_xproc  (the same kernel across processes)
=====  ==============  =============================================

(file:line of the JAX package.) One ring step moves every shard's block
to its left neighbour: shard d receives the block of shard (d + 1) % D,
the permutation ``[(i, (i - 1) % D)]`` of the JAX ring. The JAX kernel
pushed a chip's block by remote DMA after a barrier with both
neighbours, whichever process held them.

In one process the receivers exist before the launch (the barrier's
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
a copy per block).

Across processes nothing orders the two sides, so ``ring_hop_xproc``
launches the kernel's other instance, which computes what
``_hop_kernel`` computes, barrier included: each process's two receiver
sets and four signal words are shared with its neighbours through CUDA
IPC (``shared_receivers``, once per layout and process group), and one
launch per step meets both neighbours at the barrier, copies the local
blocks and pushes block 0 into the left neighbour's last receiver, then
waits until its own incoming block has landed. A process's shards may
lie on several cards: the launch runs on its home card (``home_slot``),
which holds its signal words and reads and stores the blocks and
receivers of its other cards by peer access, with events ordering each
card's reads of its receivers before the launch and the launch before
its next reads. The expected counts come from ``HopCounters``; every
spin is bounded by ``SPIN_LIMIT_S`` and ``check_hops`` raises on a
timeout. Its plain version is the point-to-point hop of
``torch.distributed`` (``ring_hop_processes_plain``). There is no
fallback: a failed build, launch, peer enable or IPC open, or cards that
cannot reach each other, raise.
"""

from __future__ import annotations

import dataclasses
import weakref
from array import array
from itertools import chain

import torch

from ia_spgemm_tpu_torch import _build
from ia_spgemm_tpu_torch.parallel.mesh import card_identities, comm_device

MAX_COPIES = 128    # copies one launch carries (csrc/ring.cu kMaxCopies)
CHUNK_BYTES = 16 * 256 * 4   # csrc/ring.cu kChunkBytes: the delivery unit
SPIN_LIMIT_S = 10.0          # each spin of the cross-process instance
# a process's signal words (csrc/ring.cu kFromLeft ... kError)
FROM_LEFT, FROM_RIGHT, DELIVERED, ERROR = range(4)
ERRORS = {1: "a neighbour did not arrive at the barrier",
          2: "the incoming block was not delivered"}


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
    """use_rdma='auto' gate, the same in every process: a mesh of two or
    more shards, every one on a CUDA card. In one process the cards must
    reach each other (the same card, or peer access); across processes
    each process's home card must reach its other cards and map both
    neighbours' memory (``card_gate``, decided once per process group
    from every process's card identities: COLLECTIVE the first time)."""
    if mesh is None or mesh.num_shards < 2:
        return False
    if mesh.spans_processes:
        key = (id(mesh.group), tuple(map(str, mesh.devices)))
        if key not in _GATES:
            _GATES[key] = card_gate(card_identities(mesh))
        return _GATES[key]
    devs = set(mesh.devices)
    if any(d.type != "cuda" for d in devs):
        return False
    return all(a == b or torch.cuda.can_device_access_peer(a, b)
               for a in devs for b in devs)


def home_slot(cards, rank: int) -> int:
    """Which of a process's shards lies on its home card, the card that
    launches its hops across processes and holds its signal words:
    ``cards`` are the shards' devices (or card identities), in shard
    order. The process's distinct cards, in order of first use, taken at
    rank modulo their count, so that processes holding the same cards
    launch on different ones (a kernel waiting at the barrier holds its
    card's time slice from the other processes' contexts)."""
    distinct = list(dict.fromkeys(cards))
    return list(cards).index(distinct[rank % len(distinct)])


def card_gate(infos) -> bool:
    """The gate across processes from every process's card identities
    (``mesh.card_identities``, in rank order). Every shard on a card the
    process sees; the home card (``home_slot``) the same card as, or with
    peer access to, each card it reads or stores: the process's own
    cards, the left neighbour's last shard's (its incoming receiver) and
    both neighbours' home cards (their signal words). A neighbour's card
    must have the same index in both processes (an IPC handle names its
    maker's card by index)."""
    W = len(infos)
    if W < 2 or any(not i["cards"] or None in i["cards"]
                    or not set(i["cards"]) <= set(i["visible"])
                    for i in infos):
        return False
    homes = [i["cards"][home_slot(i["cards"], r)]
             for r, i in enumerate(infos)]
    for r, me in enumerate(infos):
        left, right = infos[(r - 1) % W], infos[(r + 1) % W]
        vis = me["visible"]
        home = vis.index(homes[r])
        for card, nb in ([(c, me) for c in me["cards"]]
                         + [(left["cards"][-1], left),
                            (homes[(r - 1) % W], left),
                            (homes[(r + 1) % W], right)]):
            if (card not in vis
                    or vis.index(card) != nb["visible"].index(card)):
                return False
            j = vis.index(card)
            if j != home and (home, j) not in me["peer"]:
                return False
    return True


_GATES: dict = {}


def ring_hop_processes_plain(mesh, *arrays, out=None):
    """The plain version of K13 across processes (the counterpart of
    ``lax.ppermute`` over a mesh that spans processes): blocks move one
    shard left within the process, and each process's first block goes
    to the previous process by point-to-point send (host copies under
    gloo, which has no CUDA send / receive). Returns fresh tensors, one
    list per array, or fills ``out`` (a set of ``shared_receivers``)."""
    import torch.distributed as dist
    world = dist.get_world_size(mesh.group)
    rank = dist.get_rank(mesh.group)
    comm = comm_device(mesh)
    outs = []
    for arr in arrays:
        send = arr[0].to(comm).contiguous()
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, (rank - 1) % world, mesh.group),
            dist.P2POp(dist.irecv, recv, (rank + 1) % world, mesh.group)])
        for r in reqs:
            r.wait()
        L = len(arr)
        outs.append([arr[i + 1].to(mesh.devices[i], copy=True)
                     for i in range(L - 1)]
                    + [recv.to(mesh.devices[L - 1])])
    if out is None:
        return outs
    for o, got in zip(out, outs):
        for dst, src in zip(o, got):
            dst.copy_(src)
    return list(out)


class HopCounters:
    """What a process's signal words must reach at its next hop across
    processes: ``arrivals``, each of its from-left and from-right words
    (its hops so far, the next included), and ``delivered`` (the chunks
    of every block it has received so far). They only grow, across the
    steps and the calls of the ring, as the words do; none is reset."""

    def __init__(self):
        self.arrivals = 0
        self.delivered = 0

    def next(self, incoming_chunks: int) -> tuple:
        self.arrivals += 1
        self.delivered += incoming_chunks
        return self.arrivals, self.delivered


def chunks_of(nbytes: int) -> int:
    """The chunks a copy of nbytes is cut into (and delivered in)."""
    return -(-nbytes // CHUNK_BYTES)


def xproc_copy_table(blocks, receivers, left, nbytes):
    """The copy table of one hop across processes, from addresses alone:
    ``blocks[a][i]`` and ``receivers[a][i]``, this process's block i and
    receiver i of array a; ``left[a]``, the left neighbour's last
    receiver of array a; ``nbytes[a]``, the bytes of each block of array
    a. Returns (flat (source, destination, bytes) triples, n_remote): the
    local copies (block i + 1 into receiver i) first, then each array's
    block 0 into the left neighbour, the last n_remote; zero-byte arrays
    are left out."""
    local, remote = [], []
    for a, n in enumerate(nbytes):
        if not n:
            continue
        for i in range(len(blocks[a]) - 1):
            local += (blocks[a][i + 1], receivers[a][i], n)
        remote += (blocks[a][0], left[a], n)
    return local + remote, len(remote) // 3


@dataclasses.dataclass
class _Peers:
    """This process's signal words on its card (int64 FROM_LEFT ...
    ERROR, zeroed once) and its neighbours', mapped by CUDA IPC, with
    its hop counters; ``failed`` once a hop timed out."""
    own: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    counters: HopCounters
    failed: str | None = None


class XReceivers(list):
    """One of the two receiver sets of a ring across processes
    (``shared_receivers``): per array, this process's L receivers, entry
    i (shaped like the blocks, on shard i's device) for local block i + 1
    and entry L - 1, which the right neighbour writes, for the next
    process's block 0. ``left``: per array, the left neighbour's entry
    L - 1 of the same set, mapped by CUDA IPC under the home card (None
    for a zero-byte array; empty on the host); ``peers`` the signal words
    (None on the host); ``home`` the device that launches the hops;
    ``others`` the process's other cards, ordered against the launch by
    events; ``chunks`` the chunks of one hop's incoming blocks;
    ``layout`` the blocks' devices and layout (``_xlayout``)."""

    left: tuple = ()
    peers = None
    home = None
    others: tuple = ()
    chunks = 0
    layout: tuple = ()


_SIGNALS: dict = {}     # (group, card) -> _Peers
_SHARED: dict = {}      # (group, devices, layout) -> the two XReceivers
_MAX_SHARED = 8


def _xlayout(arrays):
    """(each shard's device, per array (blocks, shape, type)), checked:
    every array holds one contiguous block per local shard, all of one
    shape and type, and block i of every array lies on shard i's
    device, all on the host or all on cards. The second part is what
    the processes of a ring must share."""
    if not arrays or not arrays[0]:
        raise ValueError("ring hop of no blocks")
    devs = tuple(b.device for b in arrays[0])
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"blocks on {sorted(set(map(str, devs)))}: all on "
                         "the host or all on cards")
    per = []
    for arr in arrays:
        if tuple(b.device for b in arr) != devs:
            raise ValueError("a hop across processes takes block i of every "
                             "array on shard i's device")
        if len({(b.shape, b.dtype) for b in arr}) != 1:
            raise ValueError("a hop across processes takes blocks of one "
                             "shape and type per array")
        if not all(b.is_contiguous() for b in arr):
            raise ValueError("ring hop blocks must be contiguous")
        per.append((len(arr), tuple(arr[0].shape), str(arr[0].dtype)))
    return devs, tuple(per)


def _open(handle, dev):
    """A neighbour's tensor from its ``reduce_tensor`` pair, mapped for
    dev, the card whose kernels store into it: CUDA maps an IPC handle
    into the context that opens it (with peer access enabled lazily), so
    the handle opens under dev and not under its maker's card, and peer
    access dev -> maker is enabled first."""
    import inspect
    fn, args = handle
    args = list(args)
    i = list(inspect.signature(fn).parameters).index("storage_device")
    maker = torch.device("cuda", args[i])
    if maker != dev:
        _enable_peer(dev, maker)
    args[i] = dev.index
    return fn(*args)


def _peers(mesh, dev) -> _Peers:
    """The signal words of this process on dev, shared with both
    neighbours: COLLECTIVE the first time per process group and card."""
    key = (id(mesh.group), dev)
    got = _SIGNALS.get(key)
    if got is None:
        import torch.distributed as dist
        from torch.multiprocessing.reductions import reduce_tensor
        if _build.load()["ia_k13_chunk_bytes"]() != CHUNK_BYTES:
            raise RuntimeError("csrc/ring.cu's kChunkBytes is not "
                               f"CHUNK_BYTES ({CHUNK_BYTES})")
        own = torch.zeros(4, dtype=torch.int64, device=dev)
        torch.cuda.synchronize(dev)   # zero before a neighbour adds to it
        world = dist.get_world_size(mesh.group)
        rank = dist.get_rank(mesh.group)
        handles = [None] * world
        dist.all_gather_object(handles, reduce_tensor(own), group=mesh.group)
        got = _Peers(own, _open(handles[(rank - 1) % world], dev),
                     _open(handles[(rank + 1) % world], dev), HopCounters())
        _SIGNALS[key] = got
    return got


def shared_receivers(mesh, *arrays) -> list:
    """The two receiver sets (``XReceivers``) of a ring across processes
    for these blocks (each array's blocks of one shape and type, block i
    on shard i's device, the same shapes and types in every process),
    made once per layout and process group and kept: COLLECTIVE when
    made (every process of the group calls it together). Each receiver
    lies on its shard's device. On cards, the entries the right
    neighbour writes are shared with it through CUDA IPC
    (``torch.multiprocessing.reductions.reduce_tensor``: the caching
    allocator's handle and offset), exchanged with ``all_gather_object``
    and opened under the neighbour's home card; peer access from the
    home card to the process's other cards is enabled here. The
    mappings, and the storages behind them, live as long as the sets.
    On the host the sets are plain receivers
    (``ring_hop_processes_plain`` fills them)."""
    devs, layout = _xlayout(arrays)
    key = (id(mesh.group), devs, layout)
    sets = _SHARED.get(key)
    if sets is not None:
        return sets
    sets = [XReceivers(alloc_receivers(*arrays)) for _ in range(2)]
    nbytes = [arr[0].numel() * arr[0].element_size() for arr in arrays]
    if devs[0].type == "cuda":
        import torch.distributed as dist
        from torch.multiprocessing.reductions import reduce_tensor
        world = dist.get_world_size(mesh.group)
        rank = dist.get_rank(mesh.group)
        home = devs[home_slot(devs, rank)]
        others = tuple(d for d in dict.fromkeys(devs) if d != home)
        for d in others:
            _enable_peer(home, d)
        peers = _peers(mesh, home)
        mine = (layout, [[reduce_tensor(o[-1]) if n else None
                          for o, n in zip(s, nbytes)] for s in sets])
        every = [None] * world
        dist.all_gather_object(every, mine, group=mesh.group)
        if any(lay != layout for lay, _ in every):
            raise ValueError("the processes of the ring hold blocks of "
                             f"different layouts: {[e[0] for e in every]}")
        for s, handles in zip(sets, every[(rank - 1) % world][1]):
            s.left = tuple(None if h is None else _open(h, home)
                           for h in handles)
            s.peers, s.home, s.others = peers, home, others
    for s in sets:
        s.chunks = sum(map(chunks_of, nbytes))
        s.layout = (devs, layout)
    if len(_SHARED) >= _MAX_SHARED:
        _SHARED.clear()
    _SHARED[key] = sets
    return sets


def release_shared():
    """Drops every cached cross-process receiver set, signal word and
    gate (and with them the IPC mappings): every process of the group
    together, once no hop is in flight."""
    _SHARED.clear()
    _SIGNALS.clear()
    _GATES.clear()


def ring_hop_xproc(mesh, *arrays, out):
    """K13 across processes: one ring step of this process's blocks
    (each array's blocks, one per local shard, on its shard's device):
    block i + 1 into receiver i, block 0 into the left neighbour's last
    receiver; ``out`` is one of the two sets of ``shared_receivers`` for
    these blocks (the ring alternates them). Returns out's lists. One
    launch on the home card, not synchronised: the barrier with both
    neighbours, the copies, the wait for this process's incoming block;
    before it the home card's stream waits for every other card's work
    so far (their reads of the receivers it writes), after it every
    other card's stream waits for the launch. ``check_hops`` reads the
    kernel's error word. On host blocks the plain version fills out."""
    devs, layout = _xlayout(arrays)
    if not isinstance(out, XReceivers) or out.layout != (devs, layout):
        raise ValueError("out= takes a set that shared_receivers made for "
                         "these blocks' devices and layout")
    if devs[0].type == "cpu":
        return ring_hop_processes_plain(mesh, *arrays, out=out)
    peers = out.peers
    if peers.failed:
        raise RuntimeError(peers.failed)
    table, n, n_remote, words, targets = xproc_launch_args(arrays, out)
    home = out.home
    stream = torch.cuda.current_stream(home)
    for d in out.others:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(d))
        stream.wait_event(ready)
    with torch.cuda.device(home):
        err = _build.load()["ia_k13_ring_hop_xproc"](
            table.buffer_info()[0], n, n_remote, words.buffer_info()[0],
            targets.buffer_info()[0], stream.cuda_stream)
    if err != 0:
        peers.failed = f"ia_k13_ring_hop_xproc launch failed: CUDA error {err}"
        raise RuntimeError(peers.failed)
    ring_hop_rdma.launches += 1
    if out.others:
        done = torch.cuda.Event()
        done.record(stream)
        for d in out.others:
            torch.cuda.current_stream(d).wait_event(done)
    return list(out)


def xproc_launch_args(arrays, out):
    """The host arguments of one launch of K13 across processes, these
    blocks into ``out`` (a set of ``shared_receivers``): (int64 table of
    (source, destination, bytes) triples, copies, copies into the left
    neighbour, int64 addresses of this process's, the left's and the
    right's signal words, int64 (arrivals, delivered, spin limit ns)).
    Advances the process's hop counters."""
    nbytes = [arr[0].numel() * arr[0].element_size() for arr in arrays]
    flat, n_remote = xproc_copy_table(
        [[b.data_ptr() for b in arr] for arr in arrays],
        [[r.data_ptr() for r in o] for o in out],
        [0 if t is None else t.data_ptr() for t in out.left], nbytes)
    if len(flat) > 3 * MAX_COPIES:
        raise ValueError(f"{len(flat) // 3} copies in one hop across "
                         f"processes (at most {MAX_COPIES})")
    peers = out.peers
    arrivals, delivered = peers.counters.next(out.chunks)
    return (array("q", flat or [0]), len(flat) // 3, n_remote,
            array("q", [peers.own.data_ptr(), peers.left.data_ptr(),
                        peers.right.data_ptr()]),
            array("q", [arrivals, delivered, int(SPIN_LIMIT_S * 1e9)]))


def check_hops(recv) -> None:
    """Raises if a hop across processes into these receivers (a set of
    ``shared_receivers``) timed out: reads this process's error word,
    which synchronises its stream (the ring's call ends with it). A
    failure stays: every later hop of the process group raises."""
    peers = recv.peers
    if peers is None:
        return
    if peers.failed:
        raise RuntimeError(peers.failed)
    code = int(peers.own[ERROR].item())
    if code:
        peers.failed = (f"K13 across processes: {ERRORS.get(code, code)} "
                        f"within the spin limit of {SPIN_LIMIT_S} s")
        raise RuntimeError(peers.failed)


KERNELS = {"K13": ring_hop_rdma}
ring_hop_rdma.launches = 0


def reset_launch_counts():
    ring_hop_rdma.launches = 0


def launch_counts() -> dict:
    return {"K13": ring_hop_rdma.launches}
