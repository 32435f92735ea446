"""call_ms_p95: the 95th percentile, over every call in the window, of
the host ms from a call's issue to its C's nnz on the host."""

import numpy as np


def read(run):
    loop = run.loop
    if not loop or not loop.get("latencies_s"):
        return None
    return float(np.percentile(np.asarray(loop["latencies_s"]) * 1e3, 95))
