"""PyTorch port, the protocol of K13 across processes
(csrc/ring.cu ``k13_ring_hop_xproc``, parallel/rdma_ring.py), modelled
in Python and run under shuffled interleavings of the processes.

Each process is one CUDA stream: per ring call, the gather of step 0,
then per step s the K13 launch (arrive at both neighbours, wait until
both of its own arrival words reach ``arrivals``, copy its local blocks,
copy block 0 chunk by chunk into the left neighbour's receiver of set
s % 2, each chunk followed by one add to the left's delivered word, then
wait until its own delivered word reaches ``delivered``) and the gather
of step s + 1 from set s % 2. The targets come from
``rdma_ring.HopCounters``, the class the wrapper uses. The scheduler
runs one atomic step of a random runnable process at a time (a waiting
process is runnable once its condition holds). The model asserts that no
step writes a receiver set its owner has not finished reading, that
every gather reads block (d + s) % D of the current call, that every
receiver holds block (d + 1) % D after a hop, and that the signal words
end at the counters' values. Mutations of the protocol (no barrier, no
delivery wait, delivered counts reset per call, one summed arrival word
in place of one per neighbour) must break it under some interleaving:
the model can see what it checks.

Also: the copy table built from addresses, the launch arguments the
wrapper passes (counters included), the gate across processes from
card identities, and the CPU meshes' gate.
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


class _Violation(AssertionError):
    pass


class _Proc:
    def __init__(self, r, L, W):
        self.r, self.L, self.W = r, L, W
        self.words = [0, 0, 0, 0]
        self.counters = RR.HopCounters()
        self.sets = {}          # (layout, k) -> [array][entry] chunk tags
        self.done = 0           # ops of the program completed, in order
        self.program = []       # (kind, call, step, set read or None)


def _program(L, W):
    D = W * L
    ops = []
    for c, chunks in enumerate(CALLS):
        ops.append(("gather", c, 0, None))
        for s in range(D - 1):
            ops.append(("hop", c, s, None if s == 0 else (chunks,
                                                         (s - 1) % 2)))
            ops.append(("gather", c, s + 1, (chunks, s % 2)))
    return ops


def _tags(c, d, a, chunks):
    return [(d, c, a, j) for j in range(chunks)]


def _run(W, L, seed, mutation=None):
    """One shuffled run of the model; raises _Violation on a fault."""
    rng = random.Random(seed)
    D = W * L
    procs = [_Proc(r, L, W) for r in range(W)]
    for p in procs:
        p.program = _program(L, W)
        for chunks in set(CALLS):
            for k in (0, 1):
                p.sets[(chunks, k)] = [[None] * L for _ in range(ARRAYS)]

    # per (call, step) of a hop: the program index of the left's last
    # read, before the gather that consumes this hop's write, of the set
    # the hop writes (every process runs the same program)
    program = procs[0].program
    need_of = {}
    for kind, c, s, _ in program:
        if kind == "hop":
            setkey = (CALLS[c], s % 2)
            consumer = program.index(("gather", c, s + 1, setkey))
            need_of[(c, s)] = max(
                [i for i, op in enumerate(program[:consumer])
                 if op[3] == setkey], default=-1)

    def stream(p):
        left, right = procs[(p.r - 1) % W], procs[(p.r + 1) % W]
        delivered_base = 0
        for idx, (kind, c, s, read) in enumerate(p.program):
            chunks = CALLS[c]
            if kind == "gather":
                for i in range(L):
                    d = p.r * L + i
                    for a in range(ARRAYS):
                        got = (_tags(c, d, a, chunks) if read is None
                               else p.sets[read][a][i])
                        want = _tags(c, (d + s) % D, a, chunks)
                        if got != want:
                            raise _Violation(
                                f"p{p.r} gather c{c} s{s} shard {d} "
                                f"array {a}: {got} != {want}")
                p.done = idx + 1
                yield None
                continue
            # the wrapper's numbers, on the host, in launch order
            incoming = ARRAYS * chunks
            arrivals, delivered = p.counters.next(incoming)
            if mutation == "reset_delivered":
                if s == 0:
                    delivered_base = p.counters.delivered - incoming
                delivered -= delivered_base
            src = ([[_tags(c, p.r * L + i, a, chunks) for i in range(L)]
                    for a in range(ARRAYS)] if read is None
                   else p.sets[read])
            dst_key = (chunks, s % 2)
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
            # local copies: block i + 1 into receiver i
            for a in range(ARRAYS):
                for i in range(L - 1):
                    p.sets[dst_key][a][i] = list(src[a][i + 1])
                    yield None
            # block 0 into the left neighbour's receiver L - 1, chunk by
            # chunk, each followed by its delivery count
            need = need_of[(c, s)]
            for a in range(ARRAYS):
                for j in range(chunks):
                    if left.done <= need:
                        raise _Violation(
                            f"p{p.r} c{c} s{s} writes p{left.r}'s set "
                            f"{dst_key} before p{left.r} read it (op "
                            f"{need}, done {left.done})")
                    recv = left.sets[dst_key][a]
                    if recv[L - 1] is None or len(recv[L - 1]) != chunks:
                        recv[L - 1] = [None] * chunks
                    recv[L - 1][j] = src[a][0][j]
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
                    if p.sets[dst_key][a][i] != want:
                        raise _Violation(f"p{p.r} c{c} s{s}: receiver {d} "
                                         "does not hold block d + 1")
            p.done = idx + 1
            yield None

    gens = [stream(p) for p in procs]
    waits = [None] * W
    live = set(range(W))
    while live:
        ready = [r for r in live if waits[r] is None or waits[r]()]
        if not ready:
            raise _Violation(f"deadlock: {[procs[r].words for r in live]}")
        r = rng.choice(ready)
        try:
            waits[r] = next(gens[r])
        except StopIteration:
            live.discard(r)
    for p in procs:
        if p.words != [p.counters.arrivals, p.counters.arrivals,
                       p.counters.delivered, 0]:
            raise _Violation(f"p{p.r} words {p.words} against counters "
                             f"{p.counters.arrivals} / "
                             f"{p.counters.delivered}")
    return procs


@pytest.mark.parametrize("W", [2, 3, 4, 8])
@pytest.mark.parametrize("L", [1, 2])
def test_protocol_holds_under_shuffled_interleavings(W, L):
    """D = W * L shards, three calls over two layouts (the shared
    receivers are cached per layout, the counters never reset), SEEDS
    interleavings."""
    for seed in range(SEEDS):
        procs = _run(W, L, seed)
        hops = len(CALLS) * (W * L - 1)
        assert all(p.counters.arrivals == hops for p in procs)
        assert all(p.counters.delivered
                   == sum(ARRAYS * c * (W * L - 1) for c in CALLS)
                   for p in procs)


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
    """Local copies first (block i + 1 into receiver i), then each
    array's block 0 into the left neighbour's receiver; a zero-byte
    array is left out."""
    blocks = [[1000 * (a + 1) + i for i in range(L)] for a in range(3)]
    recv = [[5000 + 1000 * a + i for i in range(L)] for a in range(3)]
    left = [9000, 9100, 9200]
    nbytes = [64, 0, 12]
    flat, n_remote = RR.xproc_copy_table(blocks, recv, left, nbytes)
    triples = [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]
    local = [(blocks[a][i + 1], recv[a][i], nbytes[a])
             for a in (0, 2) for i in range(L - 1)]
    assert triples == local + [(blocks[0][0], 9000, 64),
                               (blocks[2][0], 9200, 12)]
    assert n_remote == 2
    assert RR.xproc_copy_table(blocks, recv, left, [0, 0, 0]) == ([], 0)


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


@pytest.mark.parametrize("case,want", [
    # 2 and 4 processes sharing one card
    ([_info(["A", "A"], ["A"])] * 2, True),
    ([_info(["A"], ["A"])] * 4, True),
    # one card each, every card visible in every process, peer access
    ([_info([c], list("ABCD"), [(i, j) for i in range(4) for j in range(4)
                                if i != j]) for c in "ABCD"], True),
    # ... without peer access
    ([_info([c], list("ABCD")) for c in "ABCD"], False),
    # one card each, each process sees its own card only
    ([_info([c], [c]) for c in "ABCD"], False),
    # the same card under other indices (an IPC handle opens on its
    # maker's index)
    ([_info(["B"], ["A", "B"]), _info(["B"], ["B", "A"])], False),
    # a process's shards on two cards
    ([_info(["A", "B"], ["A", "B"], [(0, 1), (1, 0)])] * 2, False),
    # host shards
    ([_info([None, None], [])] * 2, False),
    # one process
    ([_info(["A"], ["A"])], False),
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
