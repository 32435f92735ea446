"""assemble_ms: stream ms per planned tiled call of the program's own
``tiled.assemble`` span (the BlockCSR assembly: the nnz scatter, ``cat``
and the block gather through the plan's map), timed by CUDA events on
the stream (``ia_spgemm_tpu_torch.tracing``; spans record while the
traced windows' profiler is open, and a card times one call in 50 ms of
them: the mean over the timed calls). None off the card, where the run
has no device trace, and where the program has no such spans."""


def read(run):
    if not run.trace:
        return None
    try:
        from ia_spgemm_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    call, s = spans.get("tiled.call"), spans.get("tiled.assemble")
    if not call or not s or not s["timed"]:
        return None
    return s["stream_ms"] / s["timed"] * s["calls"] / call["calls"]
