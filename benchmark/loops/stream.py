"""One caller that dispatches the planned product ahead of its results.

At most ``in_flight`` products are outstanding: before issuing another,
the caller waits on the oldest one's CUDA event and drops its result.
Once the window's seconds have passed it issues no more and waits for
the outstanding ones, so the window holds every product issued in it,
and all the time they took.
"""

from collections import deque


def run(call, seconds, traffic, rt, keep=()):
    depth = int(traffic["in_flight"])
    keep = set(keep)
    kept = {}
    pending = deque()
    issued = completed = 0

    def retire(last):
        nonlocal completed
        idx, ev, res = pending.popleft()
        with rt.span("bench.wait"):
            rt.wait(ev)
        completed += 1
        if idx in keep or last:
            kept[idx] = res

    t0 = rt.clock()
    deadline = t0 + seconds
    while rt.clock() < deadline:
        if len(pending) == depth:
            retire(False)
        with rt.span("bench.issue"):
            res = call()
        pending.append((issued, rt.record(), res))
        del res
        issued += 1
    while pending:
        retire(len(pending) == 1)
    return {"issued": issued, "completed": completed,
            "window_s": rt.clock() - t0, "kept": kept}
