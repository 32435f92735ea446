"""heavy_ms: stream ms per planned hybrid call of the program's own
``hybrid.heavy`` span (the global ESC engine over the heavy rows: the
expansion, the key sort, the segmented sums and the compaction, its
leaves ``esc.expand``, ``esc.sort`` and ``esc.compress``), timed by CUDA
events on the stream (``ia_spgemm_tpu_torch.tracing``; spans record
while the traced windows' profiler is open, and a card times one call in
50 ms of them: the mean over the timed calls). None off the card, where
the run has no device trace, and where the program has no
``hybrid.call`` span."""


def read(run):
    if not run.trace:
        return None
    try:
        from ia_spgemm_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    call, s = spans.get("hybrid.call"), spans.get("hybrid.heavy")
    if not call or not s or not s["timed"]:
        return None
    return s["stream_ms"] / s["timed"] * s["calls"] / call["calls"]
