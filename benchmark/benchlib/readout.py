"""The program's result read as it stored it, before anything tidies it.

A result's own ``to_scipy()`` may build a COO and convert it, which
sorts every row and sums repeated entries, so columns out of order or
repeated would never reach the comparison. Here a result is read from
its raw arrays, by the fields its format documents, into (indptr,
indices, data) in storage order: a row's entries are exactly the slots
the format calls valid. Beside them, ``format_gap`` counts what breaks
the format's own promises (a row claiming more slots than it holds, a
column outside [0, n), a padding slot that is not padding).

Each result type has its reader, ``readers/<type name>.py`` with
``read(result)`` returning a Raw; a route whose type has none cannot be
judged, and the run stops.
"""

import numpy as np

from benchlib import spec


class Raw:
    """A result in storage order: a CSR that may be unsorted, hold
    repeats or cross its bounds, and the count of format faults."""

    def __init__(self, shape, indptr, indices, data, format_gap=0):
        self.shape = tuple(int(s) for s in shape)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)
        self.data = np.asarray(data, dtype=np.float64)
        self.format_gap = int(format_gap)


def read(result, here=spec.HERE):
    """The result's Raw, by the reader of its type."""
    kind = type(result).__name__
    path = here / "readers" / f"{kind}.py"
    if not path.is_file():
        raise TypeError(f"no reader for a result of type {kind} "
                        f"(readers/{kind}.py)")
    return spec.load_module(path, "bench_reader").read(result)
