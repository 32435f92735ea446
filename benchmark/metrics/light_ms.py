"""light_ms: stream ms per planned hybrid call of the program's own
``hybrid.light`` span (the slab engine over the light rows: K8, then K3
and the nnz fold, its leaves ``slab.sort`` and ``slab.compress``), timed
by CUDA events on the stream (``ia_spgemm_tpu_torch.tracing``; spans
record while the traced windows' profiler is open, and a card times one
call in 50 ms of them: the mean over the timed calls). None off the
card, where the run has no device trace, and where the program has no
``hybrid.call`` span."""


def read(run):
    if not run.trace:
        return None
    try:
        from ia_spgemm_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    call, s = spans.get("hybrid.call"), spans.get("hybrid.light")
    if not call or not s or not s["timed"]:
        return None
    return s["stream_ms"] / s["timed"] * s["calls"] / call["calls"]
