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
computes what ``_hop_kernel`` computes, barrier included, and no kernel
waits: each process's two receiver sets are shared with its neighbours
through CUDA IPC (``shared_receivers``, once per layout and process
group), and its signal words lie in a page of pinned host memory that
its neighbours map too (``_signals``). A hop runs on side streams of the
process's cards. On its home card (``home_slot``), after every card's
work so far (the gathers that read the receivers it writes), the
barrier: the stream writes the running hop count into both neighbours'
arrival words and waits until its own two reach it. Then on every card
that holds a source block the copy kernel of ``csrc/ring.cu`` (block
i + 1 into receiver i, and from shard 0's card block 0 into the left
neighbour's last receiver: loads local, stores local or over NVLink).
Then, after every card's copies, it writes the count into the left's
delivered word and waits until its own reaches it. Each card's current
stream waits for the hop before it reads the receivers: at once
(``join=True``), or when the caller joins, so that the ring overlaps the
hop of step s with the gather of step s, which also only reads the
blocks. The counts come from ``HopCounters``. A stream wait has no time
limit, so a thread of each process is the watchdog (``_watch``): once its
words have not moved for ``SPIN_LIMIT_S`` while a hop is pending, it
halts this process's later pushes, alerts its neighbours and releases
its own waits, so that no wait outlasts the limit whoever synchronises
behind it; ``check_hops`` waits for a ring call's hops and raises if the
watchdog gave up. Its plain version is the point-to-point hop of
``torch.distributed`` (``ring_hop_processes_plain``). There is no
fallback: a failed build, launch, peer enable, IPC open or page mapping,
a card without 64-bit stream memory operations, or cards that cannot
reach each other, raise.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import operator
import threading
import weakref
from array import array
from itertools import chain

import torch

from ia_spgemm_tpu_torch import _build, tracing
from ia_spgemm_tpu_torch.parallel.mesh import card_identities, comm_device

MAX_COPIES = 128    # copies one launch carries (csrc/ring.cu kMaxCopies)
SPIN_LIMIT_S = 10.0     # the watchdog's limit on a hop that does not move
WATCH_TICK_S = 0.02     # how often the watchdog looks at a pending hop
# a process's signal words (int64 in its shared page): the arrival counts
# its neighbours write, the delivered count its right neighbour writes,
# its own error code (its watchdog's; it halts its pushes) and an alert
# (a neighbour's watchdog's code)
FROM_LEFT, FROM_RIGHT, DELIVERED, ERROR, ALERT = range(5)
ERRORS = {1: "a neighbour did not arrive at the barrier",
          2: "the incoming block was not delivered"}
RELEASE = 1 << 62   # past every count: the watchdog's release of its waits
WRITE, WAIT = 0, 1  # the kinds of csrc/ring.cu ia_k13_stream_ops (kWrite...)


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
_OWN: dict = {}         # layout key -> its receivers' own _layout tuple
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
            _OWN.clear()
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
    if same:
        outs.own = hit
    else:   # the receivers' own layout follows from the blocks'
        outs.own = _OWN.get(key)
        if outs.own is None:
            outs.own = _OWN[key] = _layout(tuple(outs), None)
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
        tracing.count("launch.K13")


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
    each card that stores a block must reach the card it stores into
    (``card_gate``, decided once per process group from every process's
    card identities: COLLECTIVE the first time)."""
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
    """Which of a process's shards lies on its home card, whose side
    stream carries the barrier and the delivery of its hops across
    processes and orders its other cards' copies: ``cards`` are the
    shards' devices (or card identities), in shard order. The process's
    distinct cards, in order of first use, taken at rank modulo their
    count, so that processes holding the same cards wait on different
    ones."""
    distinct = list(dict.fromkeys(cards))
    return list(cards).index(distinct[rank % len(distinct)])


def card_gate(infos) -> bool:
    """The gate across processes from every process's card identities
    (``mesh.card_identities``, in rank order). Every shard on a card the
    process sees; each card that stores a block the same card as, or
    with peer access to, the card it stores into: the card of shard i + 1
    into shard i's (the local copies) and the card of shard 0 into the
    left neighbour's last shard's (its incoming receiver), which must
    have the same index in both processes (an IPC handle names its
    maker's card by index). The signal words lie in host memory, which
    every card reaches."""
    W = len(infos)
    if W < 2 or any(not i["cards"] or None in i["cards"]
                    or not set(i["cards"]) <= set(i["visible"])
                    for i in infos):
        return False
    for r, me in enumerate(infos):
        left = infos[(r - 1) % W]
        vis, cards, into = me["visible"], me["cards"], left["cards"][-1]
        if (into not in vis
                or vis.index(into) != left["visible"].index(into)):
            return False
        for src, dst in [*zip(cards[1:], cards), (cards[0], into)]:
            i, j = vis.index(src), vis.index(dst)
            if i != j and (i, j) not in me["peer"]:
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
    """The running count of a process's hops across processes: the value
    it writes into its neighbours' words, and that its own words must
    reach, at its next hop. It only grows, across the steps and the calls
    of the ring, as the words do; it is never reset."""

    def __init__(self):
        self.hops = 0

    def next(self) -> int:
        self.hops += 1
        return self.hops


def xproc_copy_tables(blocks, receivers, left, nbytes, cards):
    """The copies of one hop across processes, from addresses alone, by
    the card that holds their source: ``blocks[a][i]`` and
    ``receivers[a][i]``, this process's block i and receiver i of array
    a; ``left[a]``, the left neighbour's last receiver of array a;
    ``nbytes[a]``, the bytes of each block of array a; ``cards[i]``,
    shard i's card. Returns {card: (flat (source, destination, bytes)
    triples, pushes)} over the cards in shard order that hold a copy:
    block i + 1 into receiver i on block i + 1's card, then each array's
    block 0 into the left neighbour on shard 0's card, whose ``pushes``
    is True; zero-byte arrays are left out."""
    out = {c: ([], False) for c in dict.fromkeys(cards)}
    for a, n in enumerate(nbytes):
        if not n:
            continue
        for i in range(len(blocks[a]) - 1):
            out[cards[i + 1]][0].extend((blocks[a][i + 1], receivers[a][i],
                                         n))
    for a, n in enumerate(nbytes):
        if n:
            out[cards[0]] = (out[cards[0]][0], True)
            out[cards[0]][0].extend((blocks[a][0], left[a], n))
    return {c: t for c, t in out.items() if t[0]}


@dataclasses.dataclass
class _Signals:
    """This process's signal words and its neighbours' (``_signals``):
    ``words``, ``left_words``, ``right_words``, the host's views of the
    three pages (int64, FROM_LEFT ... ALERT); ``own``, ``left``,
    ``right``, the cards' addresses of the same words; ``counters`` its
    hops; ``pages`` the host addresses it pinned; ``halts``, per card
    that pushes, the int64 in its memory that each push copies its error
    word into first; ``done`` the event after its last hop; ``failed``
    once its watchdog gave up (every later hop raises); ``stop`` ends its
    watchdog thread, ``watchdog``; ``group`` the process group."""
    words: object
    left_words: object
    right_words: object
    own: int
    left: int
    right: int
    counters: HopCounters
    pages: list
    halts: dict = dataclasses.field(default_factory=dict)
    done: object = None
    failed: str | None = None
    stop: threading.Event = dataclasses.field(default_factory=threading.Event)
    watchdog: threading.Thread | None = None
    group: object = None


class XReceivers(list):
    """One of the two receiver sets of a ring across processes
    (``shared_receivers``): per array, this process's L receivers, entry
    i (shaped like the blocks, on shard i's device) for local block i + 1
    and entry L - 1, which the right neighbour writes, for the next
    process's block 0. ``left``: per array, the left neighbour's entry
    L - 1 of the same set, mapped by CUDA IPC under shard 0's card, which
    pushes into it (None for a zero-byte array; empty on the host);
    ``peers`` the signal words (None on the host); ``home`` the card
    whose side stream carries the barrier and the delivery; ``cards`` the
    process's cards; ``done`` the event after the last hop into the set;
    ``layout`` the blocks' devices and layout (``_xlayout``); ``pair``
    both sets; ``tables`` the launch tables by the blocks' addresses and
    ``events`` the set's events, both kept (an event is recorded again
    at each hop; a wait already enqueued keeps the record it saw)."""

    left: tuple = ()
    peers = None
    home = None
    cards: tuple = ()
    done = None
    layout: tuple = ()
    pair: tuple = ()

    def __init__(self, *args):
        super().__init__(*args)
        self.tables = {}
        self.events = {}

    def event(self, name):
        ev = self.events.get(name)
        if ev is None:
            ev = self.events[name] = torch.cuda.Event()
        return ev

    def join(self) -> None:
        """Every card's current stream waits for the last hop into this
        set (its receivers written, its incoming block delivered) before
        the work enqueued after this call."""
        if self.done is not None:
            for d in self.cards:
                torch.cuda.current_stream(d).wait_event(self.done)


_SIGNALS: dict = {}     # process group -> _Signals
_SHARED: dict = {}      # (group, devices, layout) -> the two XReceivers
_MAX_SHARED = 8
_READY: set = set()     # cards checked for stream waits, kernels loaded
_SIDE: dict = {}        # card -> the side stream of its hops


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


def _side(dev: torch.device):
    got = _SIDE.get(dev)
    if got is None:
        got = _SIDE[dev] = torch.cuda.Stream(device=dev)
    return got


def _page(path: str, create: bool):
    """One page of POSIX shared memory at path (created zeroed, or
    opened), pinned and mapped for every card: (int64 view of its first
    8 words, host address, the cards' address)."""
    import mmap
    import os
    fd = os.open(path, os.O_RDWR | (os.O_CREAT | os.O_EXCL if create
                                    else 0), 0o600)
    try:
        if create:
            os.ftruncate(fd, mmap.PAGESIZE)
        mm = mmap.mmap(fd, mmap.PAGESIZE)
    finally:
        os.close(fd)
    view = (ctypes.c_int64 * 8).from_buffer(mm)
    host = ctypes.addressof(view)
    dev = ctypes.c_longlong()
    err = _build.load()["ia_k13_host_map"](host, mmap.PAGESIZE,
                                           ctypes.addressof(dev))
    if err != 0:
        raise RuntimeError(f"pinning the signal page {path}: CUDA error "
                           f"{err}")
    return view, host, dev.value


def _signals(mesh, home, cards) -> _Signals:
    """This process's signal words, shared with both neighbours: a page
    of shared memory each (``/dev/shm``, unlinked once every neighbour
    has mapped it), pinned for every card. COLLECTIVE the first time per
    process group. Checks first that each of ``cards`` takes 64-bit
    stream memory operations, and loads the kernels onto it (a lazy load
    at a launch behind a stream wait would wait for the neighbours)."""
    for d in cards:
        if d not in _READY:
            lib = _build.load()
            r = lib["ia_k13_can_wait"](d.index)
            if r != 1:
                raise RuntimeError(
                    f"{d} takes no 64-bit stream memory operations, which "
                    "K13 across processes waits with" + (
                        f" (CUresult {-r})" if r < 0 else ""))
            with torch.cuda.device(d):
                err = lib["ia_k13_load_kernels"]()
            if err != 0:
                raise RuntimeError(f"loading K13 onto {d}: CUDA error {err}")
            _READY.add(d)
    got = _SIGNALS.get(id(mesh.group))
    if got is not None:
        return got
    import os
    import secrets

    import torch.distributed as dist
    world = dist.get_world_size(mesh.group)
    rank = dist.get_rank(mesh.group)
    path = f"/dev/shm/ia_spgemm_k13_{os.getpid()}_{secrets.token_hex(8)}"
    with torch.cuda.device(home):
        try:
            pages = {path: _page(path, True)}
            paths = [None] * world
            dist.all_gather_object(paths, path, group=mesh.group)
            for r in ((rank - 1) % world, (rank + 1) % world):
                if paths[r] not in pages:
                    pages[paths[r]] = _page(paths[r], False)
            # every neighbour has mapped this page: it may go from /dev/shm
            dist.all_gather_object([None] * world, None, group=mesh.group)
        finally:
            if os.path.exists(path):
                os.unlink(path)
    own = pages[path]
    left, right = (pages[paths[(rank + d) % world]] for d in (-1, 1))
    got = _Signals(own[0], left[0], right[0], own[2], left[2], right[2],
                   HopCounters(), [p[1] for p in pages.values()],
                   group=mesh.group)
    if not _SIGNALS:
        import atexit
        atexit.register(_stop_watchdogs)
    got.watchdog = threading.Thread(target=_watch, args=(got, home),
                                    name="k13-watchdog", daemon=True)
    got.watchdog.start()
    _SIGNALS[id(mesh.group)] = got
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
    and opened under the card of the neighbour's shard 0, which pushes
    into them; peer access from each card to the card it stores into is
    enabled here, and the signal words are made (``_signals``). The
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
        cards = tuple(dict.fromkeys(devs))
        for src, dst in zip(devs[1:], devs):   # block i + 1 -> receiver i
            if src != dst:
                _enable_peer(src, dst)
        peers = _signals(mesh, home, cards)
        if devs[0] not in peers.halts:
            peers.halts[devs[0]] = torch.zeros(1, dtype=torch.int64,
                                               device=devs[0])
        mine = (layout, [[reduce_tensor(o[-1]) if n else None
                          for o, n in zip(s, nbytes)] for s in sets])
        every = [None] * world
        dist.all_gather_object(every, mine, group=mesh.group)
        if any(lay != layout for lay, _ in every):
            raise ValueError("the processes of the ring hold blocks of "
                             f"different layouts: {[e[0] for e in every]}")
        for s, handles in zip(sets, every[(rank - 1) % world][1]):
            s.left = tuple(None if h is None else _open(h, devs[0])
                           for h in handles)
            s.peers, s.home, s.cards = peers, home, cards
    for s in sets:
        s.layout, s.pair = (devs, layout), tuple(sets)
    if len(_SHARED) >= _MAX_SHARED:
        _SHARED.clear()
    _SHARED[key] = sets
    return sets


def release_shared():
    """Drops every cached cross-process receiver set, signal page and
    gate (and with them the IPC mappings, the pinned pages and the
    watchdogs): COLLECTIVE, every process of each group together, once
    no hop is in flight. A set still held raises at its next hop.

    The order lets the process exit cleanly. A block shared by CUDA IPC
    that its maker frees while a neighbour still has it open waits in
    torch's IPC limbo, and what the limbo still holds at exit is freed by
    its static destructor, after the CUDA state it frees into has gone
    (glibc then aborts the process, or torch warns that the "producer
    process has been terminated before all shared CUDA tensors
    released"). So: the watchdogs stop; every card's queued work ends;
    this process closes its mappings of its left neighbour's receivers;
    a barrier of each group (every mapping of this process's receivers is
    closed); then its own receivers are freed, ``torch.cuda.ipc_collect``
    frees what waited in the limbo, and the signal pages are unpinned.
    The sets refer to each other (``pair``), so each is emptied here
    rather than left to the garbage collector."""
    _stop_watchdogs()
    sets = [s for pair in _SHARED.values() for s in pair]
    _SHARED.clear()
    cards = list(dict.fromkeys(d for s in sets for d in s.cards))
    for d in cards:
        torch.cuda.synchronize(d)
    for s in sets:
        s.left = ()
    if _SIGNALS:
        import torch.distributed as dist
        for sig in _SIGNALS.values():
            dist.barrier(group=sig.group)
    for s in sets:
        s.clear()
        s.pair = ()
        s.tables.clear()
        s.events.clear()
    sets = s = None
    if cards:
        torch.cuda.ipc_collect()
    for sig in _SIGNALS.values():
        sig.failed = "K13 across processes: the shared receivers were released"
        for host in sig.pages:
            _build.load()["ia_k13_host_unmap"](host)
    _SIGNALS.clear()
    _GATES.clear()


def _on(dev):
    """dev as the current device (a guard only where it is not)."""
    return (contextlib.nullcontext() if torch.cuda.current_device()
            == dev.index else torch.cuda.device(dev))


def _launch_xproc(dev, table, n, halt, halt_copy, stream):
    with _on(dev):
        err = _build.load()["ia_k13_ring_hop_xproc"](
            table.buffer_info()[0], n, halt, halt_copy, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"ia_k13_ring_hop_xproc launch failed: CUDA error "
                           f"{err}")
    tracing.count("launch.K13")


def _stream_ops(dev, ops, stream):
    with _on(dev):
        err = _build.load()["ia_k13_stream_ops"](ops.buffer_info()[0],
                                                 len(ops) // 3,
                                                 stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"ia_k13_stream_ops failed: CUresult {err}")


def _mark(marks, name, stream):
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        marks[name] = ev


def ring_hop_xproc(mesh, *arrays, out, join=True, marks=None):
    """K13 across processes: one ring step of this process's blocks
    (each array's blocks, one per local shard, on its shard's device):
    block i + 1 into receiver i, block 0 into the left neighbour's last
    receiver; ``out`` is one of the two sets of ``shared_receivers`` for
    these blocks (the ring alternates them). Returns out's lists.

    Nothing waits on the host. On the side streams of the process's
    cards, after every card's work enqueued so far: the barrier on the
    home card's, one copy launch on each card that holds a source block,
    the delivery on the home card's. ``join=True``: every card's current
    stream then waits for the hop; ``join=False``: the caller may enqueue
    work that only reads the blocks (the ring's gather of the same step)
    and calls ``out.join()`` before anything reads the receivers.
    ``marks``: a dict that receives timed events of the home card's side
    stream ("start", "barrier", "copied", "done"). The watchdog thread
    bounds every wait; ``check_hops`` reports its verdict. On host blocks
    the plain version fills out."""
    if not isinstance(out, XReceivers):
        raise ValueError("out= takes a set that shared_receivers made")
    # the other set's receivers (the ring's later steps) need no check
    if not any(len(arrays) == len(s) and all(map(operator.is_, arrays, s))
               for s in out.pair) and _xlayout(arrays) != out.layout:
        raise ValueError("out= takes a set that shared_receivers made for "
                         "these blocks' devices and layout")
    if out.layout[0][0].type == "cpu":
        return ring_hop_processes_plain(mesh, *arrays, out=out)
    sig = out.peers
    if sig.words[ALERT] and not sig.failed:
        sig.failed = _alerted(sig)
    if sig.failed:
        raise RuntimeError(sig.failed)
    tables, barrier, delivery = xproc_launch_args(arrays, out)
    home = out.home
    side = _side(home)
    for d in out.cards:     # the receivers' readers so far
        ready = out.event(("ready", d))
        ready.record(torch.cuda.current_stream(d))
        side.wait_event(ready)
    _mark(marks, "start", side)
    _stream_ops(home, barrier, side)
    _mark(marks, "barrier", side)
    if any(d != home for d in tables):
        passed = out.event("passed")
        passed.record(side)
    copied = []
    for d, args in tables.items():
        if d != home:
            s = _side(d)
            s.wait_event(passed)
            _launch_xproc(d, *args, s)
            copied.append(out.event(("copied", d)))
            copied[-1].record(s)
    if home in tables:
        _launch_xproc(home, *tables[home], side)
    for ev in copied:
        side.wait_event(ev)
    _mark(marks, "copied", side)
    _stream_ops(home, delivery, side)
    out.done = sig.done = out.event("done")
    out.done.record(side)
    _mark(marks, "done", side)
    if join:
        out.join()
    return list(out)


def xproc_launch_args(arrays, out):
    """The host arguments of one hop across processes, these blocks into
    ``out`` (a set of ``shared_receivers``): ({card: (int64 table of
    (source, destination, bytes) triples, copies, the host address of
    the halt word and of its copy in the card's memory, or 0, 0)}, the
    barrier's and the delivery's int64 (kind, address, value) triples
    for ``ia_k13_stream_ops``). Only the launch that pushes into the left
    neighbour reads the halt word (this process's error word). Advances
    the process's hop count. The tables are kept by the blocks' addresses
    (the layout is the set's, so the addresses fix the copies)."""
    sig = out.peers
    ptrs = tuple(b.data_ptr() for arr in arrays for b in arr)
    tables = out.tables.get(ptrs)
    if tables is None:
        nbytes = [arr[0].numel() * arr[0].element_size() for arr in arrays]
        per = xproc_copy_tables(
            [[b.data_ptr() for b in arr] for arr in arrays],
            [[r.data_ptr() for r in o] for o in out],
            [0 if t is None else t.data_ptr() for t in out.left], nbytes,
            out.layout[0])
        tables = {}
        for d, (flat, pushes) in per.items():
            if len(flat) > 3 * MAX_COPIES:
                raise ValueError(f"{len(flat) // 3} copies from {d} in one "
                                 f"hop across processes (at most "
                                 f"{MAX_COPIES})")
            halt = (ctypes.addressof(sig.words) + 8 * ERROR,
                    sig.halts[d].data_ptr()) if pushes else (0, 0)
            tables[d] = (array("q", flat), len(flat) // 3, *halt)
        if len(out.tables) >= _MAX_SHARED:
            out.tables.clear()
        out.tables[ptrs] = tables
    hops = sig.counters.next()
    barrier = array("q", [WRITE, sig.left + 8 * FROM_RIGHT, hops,
                          WRITE, sig.right + 8 * FROM_LEFT, hops,
                          WAIT, sig.own + 8 * FROM_LEFT, hops,
                          WAIT, sig.own + 8 * FROM_RIGHT, hops])
    delivery = array("q", [WRITE, sig.left + 8 * DELIVERED, hops,
                           WAIT, sig.own + 8 * DELIVERED, hops])
    return tables, barrier, delivery


def check_hops(recv) -> None:
    """The report of the watchdog on this process's hops across processes
    (``recv``, a set of ``shared_receivers``): waits on the host, polling,
    until its last hop has ended or its watchdog (``_watch``) gave up, and
    raises if it gave up or a neighbour's watchdog alerted it. A failure
    stays: every later hop of the process group raises."""
    sig = recv.peers
    if sig is None:
        return
    while not sig.failed and sig.done is not None and not sig.done.query():
        pass
    if sig.words[ALERT] and not sig.failed:
        sig.failed = _alerted(sig)
    if sig.failed:
        raise RuntimeError(sig.failed)


def _watch(sig: _Signals, home) -> None:
    """The watchdog of sig's hops, a thread that ``_signals`` starts, so
    that a stream wait is bounded whoever synchronises behind it: every
    WATCH_TICK_S, ``_tick``; it ends with sig's first failure or at
    ``sig.stop``."""
    import time
    torch.cuda.set_device(home)     # no context on a card it does not use
    since = seen = None
    while not sig.stop.wait(WATCH_TICK_S) and not sig.failed:
        since, seen = _tick(sig, since, seen, time.monotonic())


def _tick(sig: _Signals, since, seen, now):
    """One look of the watchdog at sig, (since, seen) carried from the
    last: while a hop is pending (its last hop's event not reached), the
    time its own words last moved and their values. It gives up
    (``_give_up``) on a neighbour's alert, or once the words have not
    moved for SPIN_LIMIT_S."""
    if sig.done is None or sig.done.query():
        return None, None
    w = sig.words
    if w[ALERT]:
        _give_up(sig)
        return None, None
    words = (w[FROM_LEFT], w[FROM_RIGHT], w[DELIVERED])
    if words != seen:
        return now, words
    if now - since > SPIN_LIMIT_S:
        _give_up(sig)
    return since, seen


def _alerted(sig: _Signals) -> str:
    code = sig.words[ALERT]
    return ("K13 across processes: a neighbour's watchdog gave up "
            f"({ERRORS.get(code, code)})")


def _give_up(sig: _Signals) -> None:
    """Fails sig: sets its error word (its later pushes copy nothing),
    alerts both neighbours, and writes a value past every count into its
    own words until its side streams have drained (for at most
    SPIN_LIMIT_S), so that the card takes new work."""
    import time
    w = sig.words
    if w[ALERT]:
        why, sig.failed = w[ALERT], _alerted(sig)
    else:   # a stream held at a delivery has passed that hop's barrier
        why = 2 if w[DELIVERED] < min(w[FROM_LEFT], w[FROM_RIGHT]) else 1
        sig.failed = (f"K13 across processes: {ERRORS[why]} within the "
                      f"watchdog's limit of {SPIN_LIMIT_S} s")
    w[ERROR] = why
    sig.left_words[ALERT] = sig.right_words[ALERT] = why
    limit = time.monotonic() + SPIN_LIMIT_S
    while not sig.done.query() and time.monotonic() < limit:
        # a neighbour's later write of its count may land after ours
        w[FROM_LEFT] = w[FROM_RIGHT] = w[DELIVERED] = RELEASE


def _stop_watchdogs() -> None:
    for sig in list(_SIGNALS.values()):
        sig.stop.set()
        if sig.watchdog is not None:
            sig.watchdog.join(timeout=1.0)


KERNELS = {"K13": ring_hop_rdma}


def reset_launch_counts():
    tracing.reset_launches(KERNELS)


def launch_counts() -> dict:
    return tracing.launches(KERNELS)
