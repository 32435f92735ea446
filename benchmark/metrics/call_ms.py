"""call_ms: the median, over every call in the window, of the host ms
from a call's issue to its C's nnz on the host, for a caller that waits
for each result."""

import statistics


def read(run):
    loop = run.loop
    if not loop or not loop.get("latencies_s"):
        return None
    return statistics.median(loop["latencies_s"]) * 1e3
