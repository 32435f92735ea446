"""out_slots_per_product: the slots of the tiled route's result per
intermediate product of the inputs (the program's counters
``tiled.out_slots`` / ``tiled.calls``, a plan constant: the BlockCSR's
blocks times 128; over the inputs' products). Read beside the traced
window's device breakdown: None off the card, and where the program has
no ``tiled.call`` span."""


def read(run):
    if not run.trace:
        return None
    try:
        from ia_spgemm_tpu_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    calls = snap["counters"].get("tiled.calls")
    if "tiled.call" not in snap["spans"] or not calls or not run.products:
        return None
    return snap["counters"]["tiled.out_slots"] / calls / run.products
