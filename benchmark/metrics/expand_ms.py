"""expand_ms: stream ms per planned tiled call of the program's own
``tiled.expand.w<W>`` spans (the torch work that builds each width
class's products or fragment rows), timed by CUDA events on the stream
(``ia_spgemm_tpu_torch.tracing``; spans record while the traced windows'
profiler is open, and a card times one call in 50 ms of them: the mean
over the timed calls). None off the card, where the run has no device
trace, and where the program has no such spans."""


def read(run):
    if not run.trace:
        return None
    try:
        from ia_spgemm_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    call = spans.get("tiled.call")
    if not call:
        return None
    ms = sum(s["stream_ms"] / s["timed"] * s["calls"]
             for name, s in spans.items()
             if name.startswith("tiled.expand.") and s["timed"])
    return ms / call["calls"]
