"""The import guard: no module of JAX or of the JAX package may be
loaded in a run. Names are compared by their top-level part, whole:
``ia_spgemm_tpu_torch`` (the port) passes, ``ia_spgemm_tpu`` (the JAX
package it was ported from) does not."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ia_spgemm_tpu"})


def forbidden(modules=None):
    """Sorted top-level names of the loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
