"""call_ms: the window's ms / the products it completed, for a caller
that waits for each result."""


def read(run):
    loop = run.loop
    if not loop or "latencies_s" not in loop or not loop["completed"]:
        return None
    return loop["window_s"] * 1e3 / loop["completed"]
