"""One caller that waits for each product: it issues the planned call,
reads C's nnz to the host (as a caller sizing its next step does), and
only then issues the next. Each call is timed on the host from its issue
to the nnz on the host."""


def run(call, seconds, traffic, rt, keep=()):
    keep = set(keep)
    kept = {}
    latencies = []
    t0 = rt.clock()
    deadline = t0 + seconds
    done = False
    while not done:
        t = rt.clock()
        with rt.span("bench.issue"):
            res = call()
        with rt.span("bench.nnz"):
            int(res.nnz)
        now = rt.clock()
        latencies.append(now - t)
        done = now >= deadline
        if len(latencies) - 1 in keep or done:
            kept[len(latencies) - 1] = res
        del res
    return {"issued": len(latencies), "completed": len(latencies),
            "window_s": rt.clock() - t0, "latencies_s": latencies,
            "kept": kept}
