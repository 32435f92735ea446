"""roofline_pct: the product's least time at the card's declared peaks
(the inputs' and the output's CSR bytes once, 2 flops a product;
benchlib/peaks.py) / the device's busy time per product in the traced
window, in %. None on a card without declared peaks."""


def read(run):
    t = run.trace
    if not t or run.least_s is None or not t["busy_us"]:
        return None
    return 100.0 * run.least_s / (t["busy_us"] * 1e-6 / t["products"])
