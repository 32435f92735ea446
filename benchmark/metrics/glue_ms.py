"""glue_ms: device ms per product of every other device activity in the
traced window (gathers, cat, the BlockCSR assembly, the plain-torch
engines' scans, sorts and scatters, copies, sets)."""


def read(run):
    t = run.trace
    if not t or not t["other_us"]:
        return None
    return t["other_us"] / t["products"] / 1e3
