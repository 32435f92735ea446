"""PyTorch port, the protocol of K13 across processes
(csrc/ring.cu ``k13_ring_hop_xproc``, parallel/rdma_ring.py), modelled
in Python and run under shuffled interleavings of the processes' cards.

Each process holds L shards on C cards (shard i on card i % C), and each
card is one CUDA stream. Per ring call every card runs the gather of
step 0 for its shards, then per step s: on the home card
(``rdma_ring.home_slot``) a wait for every other card's ready event of
step s, the K13 launch (arrive at both neighbours, wait until both of
its own arrival words reach ``arrivals``; then, in a random order, copy
block i + 1 into receiver i of set s % 2 for every i, wherever the two
lie, and copy block 0 chunk by chunk into the left neighbour's last
receiver, each chunk followed by one add to the left's delivered word;
then wait until its own delivered word reaches ``delivered``) and the record of the step's done event; on
every other card the record of its ready event and a wait for the done
event; then on every card the gather of step s + 1 from set s % 2. The
targets come from ``rdma_ring.HopCounters``, the class the wrapper uses.
The scheduler runs one atomic step of a random runnable stream at a time
(a waiting stream is runnable once its condition holds), some streams
of each run picked far less often than the others. The model
asserts that no copy writes a receiver before its owner's gather and
next hop have read what it held, that every gather reads block
(d + s) % D of the current call, that every receiver holds block
(d + 1) % D after a hop, and that the signal words end at the counters'
values. Mutations of the protocol (no barrier, no delivery wait,
delivered counts reset per call, one summed arrival word in place of one
per neighbour, no ready event before the launch, no done event after
it) must break it under some interleaving: the model can see what it
checks.

Also: the copy table built from addresses, the launch arguments the
wrapper passes (counters included), the home card, the gate across
processes from card identities, and the CPU meshes' gate.
"""

import random
import re
from pathlib import Path

import pytest
import torch

from ia_spgemm_tpu_torch.parallel import rdma_ring as RR

CALLS = (3, 5, 3)        # chunks per block of each call (two layouts)
ARRAYS = 2               # the ring's column and value blocks
SEEDS = 40
SLOW = 0.02              # a slow stream's weight in the scheduler's choice


class _Violation(AssertionError):
    pass


class _Proc:
    def __init__(self, r, L, C):
        self.r = r
        self.card_of = [i % C for i in range(L)]      # shard i's card
        self.home = self.card_of[RR.home_slot(self.card_of, r)]
        self.words = [0, 0, 0, 0]
        self.counters = RR.HopCounters()
        self.sets = {}          # (layout, k) -> [array][entry] chunk tags
        self.unread = {}        # (layout, k, array, entry) -> its readers
        self.events = set()     # ("ready", call, step, card), ("done", ...)


def _tags(c, d, a, chunks):
    return [(d, c, a, j) for j in range(chunks)]


def _run(W, L, seed, mutation=None, C=1):
    """One shuffled run of the model, W processes x L shards on C cards
    each; raises _Violation on a fault."""
    rng = random.Random(seed)
    D = W * L
    procs = [_Proc(r, L, C) for r in range(W)]
    for p in procs:
        for chunks in set(CALLS):
            for k in (0, 1):
                p.sets[(chunks, k)] = [[None] * L for _ in range(ARRAYS)]

    def write(owner, key, a, i, value, readers, who):
        """A receiver's write: nobody may still have to read it."""
        if owner.unread.get((*key, a, i)):
            raise _Violation(f"{who} writes p{owner.r}'s receiver {i} of "
                             f"set {key} before "
                             f"{sorted(owner.unread[(*key, a, i)])} read it")
        owner.sets[key][a][i] = value
        owner.unread[(*key, a, i)] = set(readers)

    def gather(p, shards, c, s, read):
        for i in shards:
            d = p.r * L + i
            for a in range(ARRAYS):
                got = (_tags(c, d, a, CALLS[c]) if read is None
                       else p.sets[read][a][i])
                want = _tags(c, (d + s) % D, a, CALLS[c])
                if got != want:
                    raise _Violation(f"p{p.r} gather c{c} s{s} shard {d} "
                                     f"array {a}: {got} != {want}")
                if read is not None:
                    p.unread[(*read, a, i)].discard("gather")
            yield None

    def hop(p, c, s):
        left, right = procs[(p.r - 1) % W], procs[(p.r + 1) % W]
        chunks = CALLS[c]
        read = None if s == 0 else (chunks, (s - 1) % 2)
        dst = (chunks, s % 2)
        # what this hop writes is read by the next gather, and by the
        # next hop where there is one in the call
        readers = ("gather", "hop") if s + 1 < D - 1 else ("gather",)
        # the wrapper's numbers, on the host, in launch order
        incoming = ARRAYS * chunks
        arrivals, delivered = p.counters.next(incoming)
        if mutation == "reset_delivered":
            delivered -= p.counters.delivered - incoming * (s + 1)
        src = ([[_tags(c, p.r * L + i, a, chunks) for i in range(L)]
                for a in range(ARRAYS)] if read is None else p.sets[read])
        # barrier
        left.words[RR.FROM_RIGHT] += 1
        yield None
        right.words[RR.FROM_LEFT] += 1
        yield None
        if mutation == "summed_barrier":     # one word for both
            yield lambda: (p.words[RR.FROM_LEFT]
                           + p.words[RR.FROM_RIGHT] >= 2 * arrivals)
        elif mutation != "no_barrier":
            yield lambda: (p.words[RR.FROM_LEFT] >= arrivals
                           and p.words[RR.FROM_RIGHT] >= arrivals)
        # the copies, in any order (the kernel's blocks take its chunks
        # in parallel): block i + 1 into receiver i, on any two cards,
        # and block 0 chunk by chunk into the left neighbour's receiver
        # L - 1, each chunk followed by its delivery count
        copies = ([("local", a, i) for a in range(ARRAYS)
                   for i in range(L - 1)]
                  + [("push", a, j) for a in range(ARRAYS)
                     for j in range(chunks)])
        rng.shuffle(copies)
        pushed = [0] * ARRAYS
        for kind, a, x in copies:
            if kind == "local":
                write(p, dst, a, x, list(src[a][x + 1]), readers,
                      f"p{p.r} c{c} s{s}")
                if read is not None:
                    p.unread[(*read, a, x + 1)].discard("hop")
                yield None
                continue
            if not pushed[a]:
                write(left, dst, a, L - 1, [None] * chunks, readers,
                      f"p{p.r} c{c} s{s}")
            left.sets[dst][a][L - 1][x] = src[a][0][x]
            pushed[a] += 1
            if pushed[a] == chunks and read is not None:
                p.unread[(*read, a, 0)].discard("hop")
            yield None
            left.words[RR.DELIVERED] += 1
            yield None
        if mutation != "no_delivery_wait":
            yield lambda: p.words[RR.DELIVERED] >= delivered
        # after the hop: receiver i holds block (d + 1) of this step
        for i in range(L):
            d = p.r * L + i
            for a in range(ARRAYS):
                want = _tags(c, (d + s + 1) % D, a, chunks)
                if p.sets[dst][a][i] != want:
                    raise _Violation(f"p{p.r} c{c} s{s}: receiver {d} "
                                     "does not hold block d + 1")

    def card(p, k):
        """Card k's stream of process p over the calls."""
        shards = [i for i in range(L) if p.card_of[i] == k]
        others = sorted(set(p.card_of) - {p.home})
        for c, chunks in enumerate(CALLS):
            yield from gather(p, shards, c, 0, None)
            for s in range(D - 1):
                if k == p.home:
                    if mutation != "no_ready_event":
                        for o in others:
                            yield lambda: ("ready", c, s, o) in p.events
                    yield from hop(p, c, s)
                    p.events.add(("done", c, s))
                    yield None
                else:
                    p.events.add(("ready", c, s, k))
                    yield None
                    if mutation != "no_done_event":
                        yield lambda: ("done", c, s) in p.events
                yield from gather(p, shards, c, s + 1, (chunks, s % 2))

    gens = [card(p, k) for p in procs for k in sorted(set(p.card_of))]
    # some streams run slow in each run, so that one falls far behind
    # the others (a fair choice rarely lets it lag a whole hop)
    speed = [rng.choice((1.0, SLOW)) for _ in gens]
    waits = [None] * len(gens)
    live = set(range(len(gens)))
    while live:
        ready = sorted(g for g in live if waits[g] is None or waits[g]())
        if not ready:
            raise _Violation(f"deadlock: {[p.words for p in procs]}")
        g = rng.choices(ready, [speed[g] for g in ready])[0]
        try:
            waits[g] = next(gens[g])
        except StopIteration:
            live.discard(g)
    for p in procs:
        if p.words != [p.counters.arrivals, p.counters.arrivals,
                       p.counters.delivered, 0]:
            raise _Violation(f"p{p.r} words {p.words} against counters "
                             f"{p.counters.arrivals} / "
                             f"{p.counters.delivered}")
    return procs


def _check_counters(procs, D):
    hops = len(CALLS) * (D - 1)
    assert all(p.counters.arrivals == hops for p in procs)
    assert all(p.counters.delivered
               == sum(ARRAYS * c * (D - 1) for c in CALLS) for p in procs)


@pytest.mark.parametrize("W", [2, 3, 4, 8])
@pytest.mark.parametrize("L", [1, 2])
def test_protocol_holds_under_shuffled_interleavings(W, L):
    """D = W * L shards on one card a process, three calls over two
    layouts (the shared receivers are cached per layout, the counters
    never reset), SEEDS interleavings."""
    for seed in range(SEEDS):
        _check_counters(_run(W, L, seed), W * L)


@pytest.mark.parametrize("W", [2, 3, 4])
@pytest.mark.parametrize("C", [2, 3, 4])
def test_protocol_holds_across_cards(W, C):
    """W processes x C cards, a shard on each card: every card its own
    stream, the home card's launch ordered by the other cards' ready
    events and ordering their next gathers by its done event; SEEDS
    interleavings each."""
    for seed in range(SEEDS):
        _check_counters(_run(W, C, seed, C=C), W * C)


@pytest.mark.parametrize("mutation", ["no_barrier", "no_delivery_wait",
                                      "reset_delivered"])
@pytest.mark.parametrize("W", [2, 4])
def test_protocol_mutations_are_caught(mutation, W):
    """Each mutation breaks an invariant under some interleaving (the
    model is not blind to what it checks)."""
    caught = 0
    for seed in range(200):
        try:
            _run(W, 2, seed, mutation)
        except _Violation:
            caught += 1
    assert caught, f"{mutation} passed 200 interleavings"


@pytest.mark.parametrize("mutation", ["no_ready_event", "no_done_event"])
@pytest.mark.parametrize("W,C", [(2, 2), (3, 4)])
def test_dropped_cross_card_events_are_caught(mutation, W, C):
    """Without the ready events the home card's launch writes a receiver
    that another card's gather has not read yet; without the done event
    a card's gather reads its receiver before the launch wrote it."""
    caught = 0
    for seed in range(200):
        try:
            _run(W, C, seed, mutation, C=C)
        except _Violation:
            caught += 1
    assert caught, f"{mutation} passed 200 interleavings"


def test_summed_barrier_is_fooled():
    """Why the kernel keeps one arrival word per neighbour: one summed
    word (target 2 x arrivals) is filled by a neighbour a step ahead
    while the other has not arrived, and under some interleavings of 8
    processes a hop then writes a set its owner still reads (the same
    seeds pass with the two words)."""
    caught = []
    for seed in range(SEEDS):
        try:
            _run(8, 1, seed, "summed_barrier")
        except _Violation:
            caught.append(seed)
    assert caught, "a summed barrier passed every interleaving"
    for seed in caught:
        _run(8, 1, seed)


def test_chunk_bytes_matches_the_kernel():
    """CHUNK_BYTES is csrc/ring.cu's kChunkBytes (16 B x threads x
    unroll): sender and receiver count deliveries in it."""
    src = (Path(RR.__file__).parents[1] / "csrc" / "ring.cu").read_text()
    const = {name: int(v) for name, v in re.findall(
        r"constexpr int (kThreads|kUnroll) = (\d+);", src)}
    assert "kChunkBytes = 16LL * kThreads * kUnroll" in src
    assert RR.CHUNK_BYTES == 16 * const["kThreads"] * const["kUnroll"]
    assert [RR.chunks_of(n) for n in (0, 1, RR.CHUNK_BYTES,
                                      RR.CHUNK_BYTES + 1, 950272)] == [
        0, 1, 1, 2, 58]


@pytest.mark.parametrize("L", [1, 2, 3])
def test_xproc_copy_table_from_fake_addresses(L):
    """Local copies first (block i + 1 into receiver i, whichever of the
    process's C cards each lies on), then each array's block 0 into the
    left neighbour's receiver; a zero-byte array is left out. Addresses
    carry their card in the high bits, as unified addresses do."""
    for C in (1, 2, 3):
        card = lambda i: (i % C) << 40       # noqa: E731
        blocks = [[card(i) + 1000 * (a + 1) + i for i in range(L)]
                  for a in range(3)]
        recv = [[card(i) + 5000 + 1000 * a + i for i in range(L)]
                for a in range(3)]
        left = [(7 << 40) + 9000, (7 << 40) + 9100, (7 << 40) + 9200]
        nbytes = [64, 0, 12]
        flat, n_remote = RR.xproc_copy_table(blocks, recv, left, nbytes)
        triples = [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]
        local = [(blocks[a][i + 1], recv[a][i], nbytes[a])
                 for a in (0, 2) for i in range(L - 1)]
        assert triples == local + [(blocks[0][0], left[0], 64),
                                   (blocks[2][0], left[2], 12)]
        assert n_remote == 2
        assert {(s >> 40, d >> 40) for s, d, _ in local} == {
            ((i + 1) % C, i % C) for i in range(L - 1)}
        assert RR.xproc_copy_table(blocks, recv, left, [0, 0, 0]) == ([],
                                                                      0)


@pytest.mark.parametrize("cards,rank,slot", [
    (["A"], 0, 0), (["A"] * 4, 3, 0),
    (list("ABCD"), 0, 0), (list("ABCD"), 1, 1), (list("ABCD"), 5, 1),
    (list("AABB"), 1, 2), (list("CDCD"), 0, 0), (list("CDCD"), 1, 1),
    (list("CDCD"), 2, 0)])
def test_home_slot(cards, rank, slot):
    """The home card: the process's distinct cards in order of first use,
    at rank modulo their count, so that processes on the same cards
    launch on different ones."""
    assert RR.home_slot(cards, rank) == slot
    devs = [torch.device("cuda", "ABCD".index(c)) for c in cards]
    assert RR.home_slot(devs, rank) == slot


def test_xproc_launch_args_carry_the_counters():
    """The wrapper's arguments, on host tensors standing in for the
    card's: the table of xproc_copy_table, the three signal-word
    addresses, and targets that grow by one arrival and one block's
    chunks a hop, never reset."""
    L = 2
    cols = [torch.zeros(8192, 4, dtype=torch.int32) for _ in range(L)]
    vals = [torch.zeros(8192, 4) for _ in range(L)]
    sets = [RR.XReceivers(RR.alloc_receivers(cols, vals)) for _ in range(2)]
    peers = RR._Peers(torch.zeros(4, dtype=torch.int64),
                      torch.zeros(4, dtype=torch.int64),
                      torch.zeros(4, dtype=torch.int64), RR.HopCounters())
    nb = 8192 * 4 * 4
    for s in sets:
        s.left = (torch.zeros(8192, 4, dtype=torch.int32),
                  torch.zeros(8192, 4))
        s.peers, s.chunks = peers, 2 * RR.chunks_of(nb)
    x = (cols, vals)
    for hop in range(1, 4):
        out = sets[(hop - 1) % 2]
        table, n, n_remote, words, targets = RR.xproc_launch_args(x, out)
        assert (n, n_remote) == (4, 2)
        bc, bv = x
        assert list(table) == [
            bc[1].data_ptr(), out[0][0].data_ptr(), nb,
            bv[1].data_ptr(), out[1][0].data_ptr(), nb,
            bc[0].data_ptr(), out.left[0].data_ptr(), nb,
            bv[0].data_ptr(), out.left[1].data_ptr(), nb]
        assert list(words) == [peers.own.data_ptr(), peers.left.data_ptr(),
                               peers.right.data_ptr()]
        assert list(targets) == [hop, hop * 2 * RR.chunks_of(nb),
                                 int(RR.SPIN_LIMIT_S * 1e9)]
        x = tuple(out)


def _info(cards, visible, peer=()):
    return {"cards": cards, "visible": visible, "peer": list(peer)}


ALL4 = [(i, j) for i in range(4) for j in range(4) if i != j]
PAIRS = [(0, 1), (1, 0), (2, 3), (3, 2)]     # NVLink within two pairs only


@pytest.mark.parametrize("case,want", [
    # 2 and 4 processes sharing one card
    ([_info(["A", "A"], ["A"])] * 2, True),
    ([_info(["A"], ["A"])] * 4, True),
    # one card each, every card visible in every process, peer access
    ([_info([c], list("ABCD"), ALL4) for c in "ABCD"], True),
    # ... without peer access
    ([_info([c], list("ABCD")) for c in "ABCD"], False),
    # one card each, each process sees its own card only
    ([_info([c], [c]) for c in "ABCD"], False),
    # the same card under other indices (an IPC handle opens on its
    # maker's index)
    ([_info(["B"], ["A", "B"]), _info(["B"], ["B", "A"])], False),
    # a process's shards on two cards that cannot reach each other
    ([_info(["A", "B"], ["A", "B"])] * 2, False),
    # host shards
    ([_info([None, None], [])] * 2, False),
    # one process
    ([_info(["A"], ["A"])], False),
    # several cards a process: 2 processes x every card (homes A and B)
    ([_info(list("ABCD"), list("ABCD"), ALL4)] * 2, True),
    # ... 2 shards on each card, and 4 processes on the same 4 cards
    ([_info(list("AABBCCDD"), list("ABCD"), ALL4)] * 2, True),
    ([_info(list("ABCD"), list("ABCD"), ALL4)] * 4, True),
    # 2 processes x 2 cards each, and 4 x 2 over the same cards
    ([_info(["A", "B"], list("ABCD"), ALL4),
      _info(["C", "D"], list("ABCD"), ALL4)], True),
    ([_info(list(p), list("ABCD"), ALL4) for p in ("AB", "CD", "BA", "DC")],
     True),
    # 2 x 2 cards, NVLink within each process's pair only: the home card
    # cannot reach the neighbour's last card or its signal words
    ([_info(["A", "B"], list("ABCD"), PAIRS),
      _info(["C", "D"], list("ABCD"), PAIRS)], False),
    # 2 x 2 cards: the home card A reaches the neighbour's cards but not
    # its own card B
    ([_info(["A", "B"], list("ABCD"),
            [(0, 2), (0, 3), (2, 0), (3, 0), (2, 3), (3, 2), (3, 1)]),
      _info(["C", "D"], list("ABCD"),
            [(0, 2), (0, 3), (2, 0), (3, 0), (2, 3), (3, 2), (3, 1)])],
     False),
    # every card in each process, but each sees only its own two
    ([_info(["A", "B"], ["A", "B"], [(0, 1), (1, 0)]),
      _info(["C", "D"], ["C", "D"], [(0, 1), (1, 0)])], False),
    # several cards, one of them a host shard
    ([_info(["A", None], ["A", "B"], [(0, 1), (1, 0)])] * 2, False),
    # every card, listed in other orders by the two processes
    ([_info(list("ABCD"), list("ABCD"), ALL4),
      _info(list("ABCD"), list("DCBA"), ALL4)], False),
])
def test_card_gate(case, want):
    assert RR.card_gate(case) is want


def test_rdma_gate_false_on_cpu_meshes(monkeypatch):
    """No K13 on host shards, in one process or over a process group
    (the group's card identities name no card); the answer is cached."""
    from ia_spgemm_tpu_torch.parallel.mesh import Mesh, make_mesh
    assert RR.rdma_available(make_mesh(4, devices=["cpu"] * 4)) is False
    assert RR.rdma_available(None) is False
    mesh = Mesh((torch.device("cpu"),) * 2, num_shards=4, first_shard=0,
                group=object())
    calls = []

    def fake(m):
        calls.append(m)
        return [_info([None, None], [])] * 2

    monkeypatch.setattr(RR, "card_identities", fake)
    monkeypatch.setattr(RR, "_GATES", {})
    assert RR.rdma_available(mesh) is False
    assert RR.rdma_available(mesh) is False
    assert calls == [mesh]
