"""light_slots_per_product: the slots the hybrid route's slab engine
sorts per intermediate product of its light rows (the program's counters
``slab.padded_slots`` / ``hybrid.light_products``, plan constants added
once a call: slabs times their width, over the light rows' products).
It is the run-32 fragments' padding on short rows, and the slabs' own.
Read beside the traced window's device breakdown: None off the card, and
where the program has no ``hybrid.call`` span."""


def read(run):
    if not run.trace:
        return None
    try:
        from ia_spgemm_tpu_torch import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    products = snap["counters"].get("hybrid.light_products")
    if "hybrid.call" not in snap["spans"] or not products:
        return None
    return snap["counters"].get("slab.padded_slots", 0) / products
