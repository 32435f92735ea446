"""kernel_ms: device ms per product of the hand-written kernels (K1-K13,
by name) in the traced window."""


def read(run):
    t = run.trace
    if not t or not t["kernel_us"]:
        return None
    return t["kernel_us"] / t["products"] / 1e3
