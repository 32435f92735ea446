"""PyTorch port, the protocol of K13 across processes
(parallel/rdma_ring.py ``ring_hop_xproc`` and ``check_hops``, csrc/ring.cu
``k13_ring_hop_xproc``), modelled in Python and run under shuffled
interleavings of the processes' streams.

Each process holds L shards on C cards (shard i on card i % C); each card
has its current stream (the ring's gathers) and a side stream (the
hops), and each process a host. Per ring call and step s the host
issues, in this order: the hop of step s (not after the last step), the
gather of step s, and the join of the hop; at the call's end it waits in
``check_hops``. The hop of step s, on the side streams: the home card's
(``rdma_ring.home_slot``) waits for every card's current stream as it
stood when the hop was issued (its gather of step s - 1); writes its
count into both neighbours' arrival words and waits until both of its
own reach it (the barrier); then on every card that holds a source
block the copy kernel (after the barrier, through an event where the
card is not the home card): block i + 1 into receiver i of set s % 2,
and from shard 0's card block 0 chunk by chunk into the left
neighbour's last receiver, each chunk after a read of the halt (error)
word; then, after every card's copies, the home card's stream writes
its count into the left's delivered word and waits until its own
reaches it (the delivery), and records the hop's end, which each card's
current stream waits for before its next gather (the join). Every word
has one writer and is written by value; the counts come from
``rdma_ring.HopCounters``, the class the wrapper uses. The host's
watchdog fires when nothing can run (a lost neighbour, or a protocol
that deadlocks), or at once when a neighbour alerted it: it sets its
error word (the halt), alerts both neighbours and releases its waits (a
value past every count in its words), and the host raises.

The scheduler runs one atomic step of a random runnable stream at a time
(a waiting stream is runnable once its condition holds), some streams of
each run picked far less often than the others. The model asserts that
no copy writes a receiver before its owner's gather and next hop have
read what it held; that no host passes its check after a gather of that
call read a block other than (d + s) % D of the call (no silent
corruption); that no watchdog fires unless a process was lost; that
every stream of every process that was not lost drains (the card takes
new work); and, without a lost process, that the words end at the
counters' values. Mutations of the protocol must break it under some
interleaving: no barrier, no delivery wait, the delivered count reset
per call, one arrival word written by both neighbours (the summed
barrier's counterpart), the side stream not waiting
for the other cards' gathers or for any gather of step s - 1, no join,
a write of count - 1, the delivered write before the copies, no release
at the watchdog's limit: the model can see what it checks.

Also: the copy tables built from addresses, the launch arguments the
wrapper passes (counters included), the stream operations' kinds against
the source, the home card, the gate across processes from card
identities, and the CPU meshes' gate.
"""

import ctypes
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
FL, FR, DLV, ERR, ALERT = (RR.FROM_LEFT, RR.FROM_RIGHT, RR.DELIVERED,
                           RR.ERROR, RR.ALERT)


class _Violation(AssertionError):
    pass


class _Proc:
    def __init__(self, r, L, C):
        self.r = r
        self.card_of = [i % C for i in range(L)]      # shard i's card
        self.home = self.card_of[RR.home_slot(self.card_of, r)]
        self.cards = sorted(set(self.card_of))
        self.words = [0] * 5
        self.counters = RR.HopCounters()
        self.sets = {}          # (layout, k) -> [array][entry] chunk tags
        self.unread = {}        # (layout, k, array, entry) -> its readers
        self.events = set()
        self.wrong = set()      # calls in which a gather read a wrong block
        self.releasing = False  # the watchdog writes RELEASE into its words
        self.failed = None      # the host raised (its watchdog or an alert)
        self.fired = False


def _tags(c, d, a, chunks):
    return [(d, c, a, j) for j in range(chunks)]


def _run(W, L, seed, mutation=None, C=1, lost=None):
    """One shuffled run of the model, W processes x L shards on C cards
    each; ``lost`` = (process, call, step): that process's host issues
    nothing from the hop of that step on. Raises _Violation on a fault;
    returns the processes."""
    rng = random.Random(seed)
    D = W * L
    procs = [_Proc(r, L, C) for r in range(W)]
    for p in procs:
        for chunks in set(CALLS):
            for k in (0, 1):
                p.sets[(chunks, k)] = [[None] * L for _ in range(ARRAYS)]

    def stopped(p, c, s):
        return lost is not None and lost[0] == p.r and (c, s) >= lost[1:]

    def put(owner, idx, value):
        """A by-value write of a signal word (the watchdog's release
        wins over a neighbour's later write)."""
        if not (owner.releasing and idx in (FL, FR, DLV)):
            owner.words[idx] = value

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
                if got != _tags(c, (d + s) % D, a, CALLS[c]):
                    p.wrong.add(c)
                if read is not None:
                    p.unread.setdefault((*read, a, i), set()).discard("gather")
            yield None

    def copies(p, k, c, s):
        """Card k's copy kernel of hop s: its local copies, and on shard
        0's card the push chunk by chunk, each block of the kernel after
        a read of the halt word."""
        left = procs[(p.r - 1) % W]
        chunks = CALLS[c]
        read = None if s == 0 else (chunks, (s - 1) % 2)
        dst = (chunks, s % 2)
        # what this hop writes is read by the next gather, and by the
        # next hop where there is one in the call
        readers = ("gather", "hop") if s + 1 < D - 1 else ("gather",)
        src = ([[_tags(c, p.r * L + i, a, chunks) for i in range(L)]
                for a in range(ARRAYS)] if read is None else p.sets[read])
        todo = [("local", a, i) for a in range(ARRAYS)
                for i in range(L - 1) if p.card_of[i + 1] == k]
        if p.card_of[0] == k:
            todo += [("push", a, j) for a in range(ARRAYS)
                     for j in range(chunks)]
        rng.shuffle(todo)
        pushed, started = [0] * ARRAYS, [False] * ARRAYS
        for kind, a, x in todo:
            # a block of the kernel on shard 0's card reads the halt word
            # first; halted, it neither reads nor writes
            halted = p.card_of[0] == k and p.words[ERR]
            if kind == "local":
                if not halted:
                    write(p, dst, a, x, list(src[a][x + 1] or [None] * chunks),
                          readers, f"p{p.r} c{c} s{s}")
                if read is not None:
                    p.unread.setdefault((*read, a, x + 1), set()).discard(
                        "hop")
            else:
                if not halted:
                    if not started[a]:
                        write(left, dst, a, L - 1, [None] * chunks, readers,
                              f"p{p.r} c{c} s{s}")
                        started[a] = True
                    left.sets[dst][a][L - 1][x] = (src[a][0]
                                                   or [None] * chunks)[x]
                pushed[a] += 1
                if pushed[a] == chunks and read is not None:
                    p.unread.setdefault((*read, a, 0), set()).discard("hop")
            yield None

    def side(p, k):
        """Card k's side stream of process p over the calls."""
        left, right = procs[(p.r - 1) % W], procs[(p.r + 1) % W]
        for c in range(len(CALLS)):
            if c:       # the host issues the next call once it checked
                yield lambda c=c: ("checked", c - 1) in p.events or p.failed
                if p.failed:
                    return
            for s in range(D - 1):
                if stopped(p, c, s):
                    return
                if k != p.home:
                    yield lambda c=c, s=s: ("barrier", c, s) in p.events
                    yield from copies(p, k, c, s)
                    p.events.add(("copied", c, s, k))
                    yield None
                    continue
                # the host's numbers, in issue order
                hops = p.counters.next()
                value = hops - 1 if mutation == "count_minus_one" else hops
                # the delivered count restarted at each call
                dlv = (hops - c * (D - 1) if mutation == "reset_delivered"
                       else value)
                if mutation != "no_gather_wait":
                    for o in (p.cards if mutation != "no_ready_event"
                              else [k]):
                        yield lambda c=c, s=s, o=o: (
                            ("ready", c, s, o) in p.events)
                # barrier
                put(left, FL if mutation == "shared_arrival_word" else FR,
                    value)
                yield None
                put(right, FL, value)
                yield None
                if mutation == "shared_arrival_word":
                    yield lambda h=hops: p.words[FL] >= h or p.releasing
                elif mutation != "no_barrier":
                    yield lambda h=hops: (min(p.words[FL], p.words[FR]) >= h
                                          or p.releasing)
                p.events.add(("barrier", c, s))
                if mutation == "delivered_before_copies":
                    put(left, DLV, dlv)
                    yield None
                yield from copies(p, k, c, s)
                for o in p.cards:
                    if o != k and (o == p.card_of[0] or o in [
                            p.card_of[i + 1] for i in range(L - 1)]):
                        yield lambda c=c, s=s, o=o: (
                            ("copied", c, s, o) in p.events)
                if mutation != "delivered_before_copies":
                    put(left, DLV, dlv)
                    yield None
                if mutation != "no_delivery_wait":
                    yield lambda h=(dlv if mutation == "reset_delivered"
                                    else hops): (p.words[DLV] >= h
                                                 or p.releasing)
                p.events.add(("done", c, s))
                yield None

    def current(p, k):
        """Card k's current stream of process p over the calls."""
        shards = [i for i in range(L) if p.card_of[i] == k]
        for c, chunks in enumerate(CALLS):
            if c:
                yield lambda c=c: ("checked", c - 1) in p.events or p.failed
                if p.failed:
                    return
            for s in range(D):
                if s < D - 1 and stopped(p, c, s):
                    return
                if s < D - 1:   # the hop of step s is issued here
                    p.events.add(("ready", c, s, k))
                yield from gather(p, shards, c, s,
                                  None if s == 0 else (chunks, (s - 1) % 2))
                if s < D - 1 and mutation != "no_done_event":
                    yield lambda c=c, s=s: ("done", c, s) in p.events

    def host(p):
        """Process p's host: its check at each call's end."""
        for c in range(len(CALLS)):
            if stopped(p, c, D - 2):
                return
            yield ("check", lambda c=c: (("done", c, D - 2) in p.events
                                         or p.words[ALERT]))
            if ("done", c, D - 2) not in p.events and not p.fired:
                give_up(p)                          # alerted while held
            if p.words[ALERT] or p.failed:
                p.failed = p.failed or "alerted"
                return
            if c in p.wrong:
                raise _Violation(f"p{p.r} passed its check of call {c} "
                                 "after reading a wrong block")
            p.events.add(("checked", c))
            yield None

    def give_up(p):
        """The watchdog's limit (or an alert): halt, alert, release."""
        p.fired = True
        p.words[ERR] = 1
        procs[(p.r - 1) % W].words[ALERT] = 1
        procs[(p.r + 1) % W].words[ALERT] = 1
        if mutation != "no_release":
            p.releasing = True
            for idx in (FL, FR, DLV):
                p.words[idx] = RR.RELEASE
        p.failed = "watchdog"

    gens, owner = [], []
    for p in procs:
        for k in p.cards:
            gens += [current(p, k), side(p, k)]
            owner += [p, p]
        gens.append(host(p))
        owner.append(p)
    # some streams run slow in each run, so that one falls far behind
    # the others (a fair choice rarely lets it lag a whole hop)
    speed = [rng.choice((1.0, SLOW)) for _ in gens]
    waits = [None] * len(gens)
    live = set(range(len(gens)))
    while live:
        ready = sorted(g for g in live if waits[g] is None or (
            waits[g][1]() if isinstance(waits[g], tuple) else waits[g]()))
        if not ready:
            held = [g for g in live if isinstance(waits[g], tuple)
                    and not owner[g].fired]
            if not held:
                break
            g = rng.choice(held)
            if lost is None:
                raise _Violation(f"p{owner[g].r}'s watchdog fired with no "
                                 f"process lost: {[p.words for p in procs]}")
            give_up(owner[g])
            waits[g] = None
            continue
        g = rng.choices(ready, [speed[g] for g in ready])[0]
        try:
            waits[g] = next(gens[g])
        except StopIteration:
            live.discard(g)
    stuck = sorted({owner[g].r for g in live
                    if lost is None or owner[g].r != lost[0]})
    if stuck:
        raise _Violation(f"the streams of {stuck} never drain: "
                         f"{[p.words for p in procs]}")
    if lost is None:
        for p in procs:
            h = p.counters.hops
            if p.words != [h, h, h, 0, 0]:
                raise _Violation(f"p{p.r} words {p.words} against the "
                                 f"count {h}")
    return procs


def _check_counters(procs, D):
    hops = len(CALLS) * (D - 1)
    assert all(p.counters.hops == hops and not p.failed for p in procs)


@pytest.mark.parametrize("W", [2, 3, 4, 8])
@pytest.mark.parametrize("L", [1, 2])
def test_protocol_holds_under_shuffled_interleavings(W, L):
    """D = W * L shards on one card a process, three calls over two
    layouts (the shared receivers are cached per layout, the counts
    never reset), SEEDS interleavings."""
    for seed in range(SEEDS):
        _check_counters(_run(W, L, seed), W * L)


@pytest.mark.parametrize("W", [2, 3, 4])
@pytest.mark.parametrize("C", [2, 3, 4])
def test_protocol_holds_across_cards(W, C):
    """W processes x C cards, a shard on each card: every card its own
    current and side stream, each card's copies after the home card's
    barrier and before its delivery; SEEDS interleavings each."""
    for seed in range(SEEDS):
        _check_counters(_run(W, C, seed, C=C), W * C)


def _caught(W, L, mutation, C=1, lost=None, seeds=200):
    """Whether some of the first `seeds` interleavings break the model."""
    for seed in range(seeds):
        try:
            _run(W, L, seed, mutation, C=C, lost=lost)
        except _Violation:
            return True
    return False


@pytest.mark.parametrize("mutation", [
    "no_barrier", "no_delivery_wait", "reset_delivered", "count_minus_one",
    "delivered_before_copies", "no_gather_wait"])
@pytest.mark.parametrize("W", [2, 4])
def test_protocol_mutations_are_caught(mutation, W):
    """Each mutation breaks an invariant under some interleaving (the
    model is not blind to what it checks)."""
    assert _caught(W, 2, mutation), f"{mutation} passed 200 interleavings"


@pytest.mark.parametrize("mutation", ["no_ready_event", "no_done_event",
                                      "no_gather_wait",
                                      "delivered_before_copies"])
@pytest.mark.parametrize("W,C", [(2, 2), (3, 4)])
def test_dropped_cross_card_events_are_caught(mutation, W, C):
    """Across cards: without waiting for the other cards' gathers the
    side stream writes a receiver that another card's gather has not
    read yet; without the join a card's gather reads its receiver
    before the hop wrote it; a delivered write before another card's
    copies lets the left read its receiver early."""
    assert _caught(W, C, mutation, C=C), (
        f"{mutation} passed 200 interleavings")


def test_summed_barrier_is_fooled():
    """Why each process keeps one arrival word per neighbour: with words
    written by value, a summed barrier becomes one word that both
    neighbours write, and it is filled by a neighbour a step ahead
    while the other has not arrived (or lowered by the other's later
    write), and under some interleavings of 8 processes a hop then writes
    a set its owner still reads, or the ring stalls (the same seeds pass
    with the two words)."""
    caught = []
    for seed in range(SEEDS):
        try:
            _run(8, 1, seed, "shared_arrival_word")
        except _Violation:
            caught.append(seed)
    assert caught, "a shared arrival word passed every interleaving"
    for seed in caught:
        _run(8, 1, seed)


@pytest.mark.parametrize("W,L,C", [(2, 2, 1), (3, 1, 1), (4, 1, 1),
                                   (3, 2, 2)])
@pytest.mark.parametrize("call,step", [(0, 0), (1, 1)])
def test_lost_process_fails_its_neighbours_cleanly(W, L, C, call, step):
    """A process that stops issuing at a hop: its neighbours' watchdogs
    fire, every other process either passes its checks with the right
    blocks or raises, nobody passes a check after reading a wrong block,
    and every stream of every live process drains (the card takes new
    work), under SEEDS interleavings."""
    for seed in range(SEEDS):
        procs = _run(W, L, seed, C=C, lost=(1, call, step))
        for r in (0, 2 % W):
            assert procs[r].failed, (seed, r)


@pytest.mark.parametrize("W", [2, 3])
def test_no_release_is_caught(W):
    """Without the release at the watchdog's limit a stream of the
    process that gave up stays held on its own words: its card never
    takes new work."""
    assert _caught(W, 2, "no_release", lost=(1, 0, 0), seeds=SEEDS)


def test_stream_op_kinds_match_the_source():
    """WRITE and WAIT are csrc/ring.cu's kinds of ia_k13_stream_ops
    (kWrite, kWait), and its kernel reads no signal word but the halt."""
    src = (Path(RR.__file__).parents[1] / "csrc" / "ring.cu").read_text()
    kinds = dict(re.findall(r"(kWrite|kWait) = (\d+)", src))
    assert (int(kinds["kWrite"]), int(kinds["kWait"])) == (RR.WRITE,
                                                           RR.WAIT)
    assert "CU_STREAM_WAIT_VALUE_GEQ" in src
    for spin in ("globaltimer", "__nanosleep", "ld.acquire", "red.release"):
        assert spin not in src, spin


@pytest.mark.parametrize("L", [1, 2, 3])
def test_xproc_copy_table_from_fake_addresses(L):
    """Per source card, in shard order: block i + 1 into receiver i on
    block i + 1's card, then on shard 0's card each array's block 0 into
    the left neighbour's receiver (that card pushes); a zero-byte array
    is left out. Addresses carry their card in the high bits, as unified
    addresses do: every copy loads from its own card."""
    for C in (1, 2, 3):
        cards = [i % C for i in range(L)]
        card = lambda i: (i % C) << 40       # noqa: E731
        blocks = [[card(i) + 1000 * (a + 1) + i for i in range(L)]
                  for a in range(3)]
        recv = [[card(i) + 5000 + 1000 * a + i for i in range(L)]
                for a in range(3)]
        left = [(7 << 40) + 9000, (7 << 40) + 9100, (7 << 40) + 9200]
        nbytes = [64, 0, 12]
        got = RR.xproc_copy_tables(blocks, recv, left, nbytes, cards)
        want = {}
        for k in dict.fromkeys(cards):
            local = [(blocks[a][i + 1], recv[a][i], nbytes[a])
                     for a in (0, 2) for i in range(L - 1)
                     if cards[i + 1] == k]
            push = ([(blocks[0][0], left[0], 64), (blocks[2][0], left[2], 12)]
                    if k == cards[0] else [])
            if local or push:
                want[k] = (local + push, bool(push))
        assert {k: ([tuple(f[i:i + 3]) for i in range(0, len(f), 3)], p)
                for k, (f, p) in got.items()} == want
        assert list(got) == list(want)
        for k, (flat, _) in got.items():
            assert all(src >> 40 == k for src in flat[0::3])
        assert RR.xproc_copy_tables(blocks, recv, left, [0, 0, 0],
                                    cards) == {}


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
    card's: the copy table of xproc_copy_tables (one card here, which
    pushes and so copies the halt word, this process's error word, into
    its memory first), the barrier's two writes of the
    count into the neighbours' arrival words and two waits on its own,
    the delivery's write into the left's delivered word and wait on its
    own; the count grows by one a hop, never reset."""
    L = 2
    cols = [torch.zeros(8192, 4, dtype=torch.int32) for _ in range(L)]
    vals = [torch.zeros(8192, 4) for _ in range(L)]
    sets = [RR.XReceivers(RR.alloc_receivers(cols, vals)) for _ in range(2)]
    own, left, right = 1 << 44, 2 << 44, 3 << 44
    dev = cols[0].device
    words = (ctypes.c_int64 * 8)()
    peers = RR._Signals(words, [0] * 8, [0] * 8, own, left, right,
                        RR.HopCounters(), [],
                        {dev: torch.zeros(1, dtype=torch.int64)})
    nb = 8192 * 4 * 4
    for s in sets:
        s.left = (torch.zeros(8192, 4, dtype=torch.int32),
                  torch.zeros(8192, 4))
        s.peers, s.layout = peers, ((dev,) * L, ())
    x = (cols, vals)
    for hop in range(1, 4):
        out = sets[(hop - 1) % 2]
        tables, barrier, delivery = RR.xproc_launch_args(x, out)
        assert list(tables) == [dev]
        table, n, halt, halt_copy = tables[dev]
        assert (n, halt, halt_copy) == (
            4, ctypes.addressof(words) + 8 * RR.ERROR,
            peers.halts[dev].data_ptr())
        bc, bv = x
        assert list(table) == [
            bc[1].data_ptr(), out[0][0].data_ptr(), nb,
            bv[1].data_ptr(), out[1][0].data_ptr(), nb,
            bc[0].data_ptr(), out.left[0].data_ptr(), nb,
            bv[0].data_ptr(), out.left[1].data_ptr(), nb]
        W, T = RR.WRITE, RR.WAIT
        assert list(barrier) == [W, left + 8 * RR.FROM_RIGHT, hop,
                                 W, right + 8 * RR.FROM_LEFT, hop,
                                 T, own + 8 * RR.FROM_LEFT, hop,
                                 T, own + 8 * RR.FROM_RIGHT, hop]
        assert list(delivery) == [W, left + 8 * RR.DELIVERED, hop,
                                  T, own + 8 * RR.DELIVERED, hop]
        x = tuple(out)
    assert peers.counters.hops == 3


class _Done:
    """A hop's last event, standing in for the card's: reached once the
    words are released (the side stream's waits pass) or once `ended`."""

    def __init__(self, words, ended=False):
        self.words, self.ended = words, ended

    def query(self):
        return self.ended or self.words[RR.DELIVERED] >= RR.RELEASE


def _fake_signals(own_words, ended=False):
    """_Signals on plain lists: own words as given, neighbours' zero, the
    last hop's event a _Done."""
    words = list(own_words) + [0] * (8 - len(own_words))
    sig = RR._Signals(words, [0] * 8, [0] * 8, 0, 0, 0, RR.HopCounters(), [])
    sig.done = _Done(words, ended)
    return sig


def _raised(sig) -> str:
    recv = RR.XReceivers()
    recv.peers = sig
    with pytest.raises(RuntimeError) as e:
        RR.check_hops(recv)
    return str(e.value)


@pytest.mark.parametrize("code", [1, 2])
def test_watchdog_gives_up_on_a_neighbours_alert(code):
    """A neighbour's watchdog alerted this process (its ALERT word) while
    a hop is pending: the next look gives up at once, passes the same
    code on to both neighbours, sets the error word, releases its own
    waits, and check_hops raises the neighbour's verdict (not its own:
    the words say nothing of who was lost)."""
    sig = _fake_signals([3, 3, 2, 0, code])
    assert RR._tick(sig, None, None, 0.0) == (None, None)
    assert sig.words[RR.ERROR] == code
    assert sig.left_words[RR.ALERT] == sig.right_words[RR.ALERT] == code
    assert sig.words[:3] == [RR.RELEASE] * 3
    msg = _raised(sig)
    assert "a neighbour's watchdog gave up" in msg and RR.ERRORS[code] in msg
    assert "within the watchdog's limit" not in msg


def test_check_hops_reports_an_alert_after_its_hops_ended():
    """Its hops ended, but a neighbour's watchdog alerted it since: the
    failure is the neighbour's, it stays, and the next hop raises it."""
    sig = _fake_signals([3, 3, 3, 0, 1], ended=True)
    assert "a neighbour's watchdog gave up" in _raised(sig)
    assert sig.failed and sig.words[RR.ERROR] == 0
    assert _raised(sig) == sig.failed


@pytest.mark.parametrize("words,why", [
    ([2, 3, 2], "did not arrive"),           # held at the barrier
    ([3, 3, 2], "was not delivered")])       # held at the delivery
def test_watchdog_gives_up_once_the_words_stall(words, why):
    """A pending hop whose own words do not move for SPIN_LIMIT_S: the
    watchdog waits while they move, then gives up with what the words
    say held it (the barrier or the delivery); an ended hop resets it."""
    sig = _fake_signals(words)
    lim = RR.SPIN_LIMIT_S
    since, seen = RR._tick(sig, None, None, 100.0)
    assert (since, seen) == (100.0, tuple(words))
    since, seen = RR._tick(sig, since, seen, 100.0 + lim)
    assert not sig.failed
    sig.words[RR.FROM_LEFT] += 1            # a word moved: the limit restarts
    since, seen = RR._tick(sig, since, seen, 100.0 + lim + 1)
    assert since == 100.0 + lim + 1 and not sig.failed
    sig.words[RR.FROM_LEFT] -= 1
    since, seen = RR._tick(sig, since, seen, 100.0 + lim + 2)
    RR._tick(sig, since, seen, 100.0 + 2 * lim + 2.5)
    assert sig.words[RR.ERROR] and sig.words[:3] == [RR.RELEASE] * 3
    assert why in _raised(sig)
    idle = _fake_signals(words, ended=True)
    assert RR._tick(idle, 5.0, tuple(words), 1e9) == (None, None)
    assert not idle.failed


def test_watchdog_thread_bounds_a_wait_that_nothing_checks(monkeypatch):
    """The watchdog is a thread: a pending hop that nobody checks is
    given up at the limit all the same (a synchronisation behind it
    returns), and check_hops, called after, raises its verdict; a hop
    that ended passes check_hops."""
    import threading
    import time
    monkeypatch.setattr(RR, "SPIN_LIMIT_S", 0.2)
    monkeypatch.setattr(RR, "WATCH_TICK_S", 0.01)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    sig = _fake_signals([1, 0, 0])
    t = threading.Thread(target=RR._watch, args=(sig, None), daemon=True)
    t0 = time.monotonic()
    t.start()
    t.join(timeout=5.0)
    assert not t.is_alive() and sig.done.query()
    assert time.monotonic() - t0 < 2.0
    assert "did not arrive" in _raised(sig)
    ok = _fake_signals([1, 1, 1], ended=True)
    recv = RR.XReceivers()
    recv.peers = ok
    RR.check_hops(recv)
    ok.stop.set()
    RR._watch(ok, None)         # stopped: returns at once
    assert not ok.failed


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
    # several cards a process: 2 processes x every card
    ([_info(list("ABCD"), list("ABCD"), ALL4)] * 2, True),
    # ... 2 shards on each card, and 4 processes on the same 4 cards
    ([_info(list("AABBCCDD"), list("ABCD"), ALL4)] * 2, True),
    ([_info(list("ABCD"), list("ABCD"), ALL4)] * 4, True),
    # 2 processes x 2 cards each, and 4 x 2 over the same cards
    ([_info(["A", "B"], list("ABCD"), ALL4),
      _info(["C", "D"], list("ABCD"), ALL4)], True),
    ([_info(list(p), list("ABCD"), ALL4) for p in ("AB", "CD", "BA", "DC")],
     True),
    # 2 x 2 cards, NVLink within each process's pair only: shard 0's
    # card cannot reach the left neighbour's last card
    ([_info(["A", "B"], list("ABCD"), PAIRS),
      _info(["C", "D"], list("ABCD"), PAIRS)], False),
    # 2 x 2 cards: B (shard 1's card) cannot store into A (shard 0's),
    # nor C into B (the left neighbour's last)
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
    # 2 x 2 cards with only the links the copies use: B -> A and D -> C
    # (the local copies), A -> D and C -> B (each shard 0's push); no
    # home card needs more
    ([_info(["A", "B"], list("ABCD"), [(1, 0), (3, 2), (0, 3), (2, 1)]),
      _info(["C", "D"], list("ABCD"), [(1, 0), (3, 2), (0, 3), (2, 1)])],
     True),
    # ... every link but C -> B: the card of process 1's shard 0 cannot
    # push into process 0's last receiver (its home card D could)
    ([_info(["A", "B"], list("ABCD"), [p for p in ALL4 if p != (2, 1)]),
      _info(["C", "D"], list("ABCD"), [p for p in ALL4 if p != (2, 1)])],
     False),
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
