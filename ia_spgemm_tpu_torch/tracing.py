"""The port's spans and counters: the one place either lives.

Counters are always on: ``count(name, n)`` adds to a dict. Among them
are each kernel wrapper's launches (``launch.K1`` ... ``launch.K13``,
read through the kernel modules' ``launch_counts()``) and the tiled
plan cache's ``plan_cache.hits`` / ``plan_cache.misses`` (read through
``ops/bitonic.plan_cache_stats()``).

Spans record only while tracing is active: inside ``enable()``, or while
a ``torch.profiler`` window is open. An active span

1. while a profiler window is open, opens a
   ``torch.profiler.record_function`` range of its name, so it lies on
   the profiler's timeline and the launches it issues nest under it
   (with no window nothing would record the range, and it costs ~10 us);
2. adds its calls, host ns and self host ns (its duration less its
   children's) to a table keyed by name;
3. on a card, when it is timed, marks its ends by CUDA events on the
   device's current stream; ``snapshot()`` resolves them into the
   span's stream ms. Elsewhere stream ms is host ms.

A hot call opens its spans through ``tracer(device)``: None when tracing
is off, so the call checks once and opens nothing. Its spans are a top
span and a run of leaves that follow one another inside it (``leaf``),
so one event marks each boundary. Inside ``enable()`` every call is
timed. Under a profiler window alone, a card times one call in
``TIME_EVERY_NS`` of host time at most: each event is a command on the
stream of its own, and a window that measures the device would count
them. At most ``MAX_PENDING`` events wait unresolved; past that a span
is not timed. A span's ``timed`` counts its timed calls, over which
``stream_ms`` is summed.

    with tracing.enable():
        C = call()
    tracing.snapshot()["spans"]["tiled.assemble"]["stream_ms"]
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import _profiler_enabled

MAX_PENDING = 1 << 16
TIME_EVERY_NS = 50_000_000

_counters: dict = {}
# name -> [calls, host ns, self host ns, stream ms, calls timed]
_spans: dict = {}
# (row, device index, start event, end event) not yet resolved
_pending: list = []
_pool: dict = {}          # device index -> free timing events
_local = threading.local()
_enabled = 0
_last_timed = -TIME_EVERY_NS   # host ns of the last call timed on a card
_NULL = contextlib.nullcontext()    # what an inactive span is


# ----------------------------------------------------------------- counters

def count(name: str, n: int = 1) -> int:
    """Add n to a counter; returns its new value."""
    v = _counters.get(name, 0) + n
    _counters[name] = v
    return v


def count_all(pairs) -> None:
    """count(name, n) for each (name, n) of pairs, in one call."""
    for name, n in pairs:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def reset_counters(names) -> None:
    for name in names:
        _counters.pop(name, None)


def launches(kernels) -> dict:
    """{kernel: launches} of the named kernels (counters launch.<name>)."""
    return {k: _counters.get("launch." + k, 0) for k in kernels}


def reset_launches(kernels) -> None:
    reset_counters("launch." + k for k in kernels)


# -------------------------------------------------------------------- spans

def active() -> bool:
    """Inside ``enable()``, or a torch.profiler window is open."""
    return _enabled > 0 or _profiler_enabled()


@contextlib.contextmanager
def enable():
    """Spans record inside this block, with or without a profiler."""
    global _enabled
    _enabled += 1
    try:
        yield
    finally:
        _enabled -= 1


def span(name: str, args: str | None = None, device=None):
    """A span of ``name`` when tracing is active, else a no-op context.
    ``device``: a CUDA device times the span on its current stream."""
    if not active():
        return _NULL
    return _Span(name, args, _Clock(device, True, _profiler_enabled()))


def tracer(device=None):
    """The spans of one hot call (``Tracer``), timed on ``device``'s
    current stream when the module docstring's rule times the call; None
    when tracing is off."""
    global _last_timed
    ranges = _profiler_enabled()
    if _enabled:
        timed = True
    elif ranges:
        now = time.perf_counter_ns()
        timed = now - _last_timed >= TIME_EVERY_NS
        if timed:
            _last_timed = now
    else:
        return None
    return Tracer(_Clock(device, timed, ranges))


class _Clock:
    """How a span is timed: off a card (``index`` None) by the host's
    clock; on a card by events on ``stream``, or not at all. ``ranges``:
    a profiler window is open, so spans open ranges."""
    __slots__ = ("index", "stream", "timed", "ranges")

    def __init__(self, device, timed: bool, ranges: bool):
        index = None
        if device is not None:
            device = torch.device(device)
            if device.type == "cuda":
                index = device.index
                if index is None:
                    index = torch.cuda.current_device()
        self.index = index
        self.stream = (None if index is None
                       else torch.cuda.current_stream(index))
        self.timed = timed
        self.ranges = ranges

    def range(self, name: str, args=None):
        """The entered record_function range of a span; None without a
        profiler window."""
        if not self.ranges:
            return None
        rf = torch.profiler.record_function(name, args)
        rf.__enter__()
        return rf

    def mark(self):
        """An event recorded on the stream now; None when not timed."""
        if (self.index is None or not self.timed
                or len(_pending) >= MAX_PENDING):
            return None
        free = _pool.get(self.index)
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def add(self, row, t_ns: int, start, end) -> None:
        """Time one call of ``row``: t_ns on the host's clock, or the
        stream between two events."""
        if self.index is None:
            row[3] += t_ns * 1e-6
            row[4] += 1
        elif start is not None and end is not None:
            _pending.append((row, self.index, start, end))


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _record(name: str, t_ns: int, children_ns: int):
    """Add one call of t_ns (children_ns of it in child spans)."""
    row = _spans.get(name)
    if row is None:
        row = _spans[name] = [0, 0, 0, 0.0, 0]
    row[0] += 1
    row[1] += t_ns
    row[2] += t_ns - children_ns
    return row


class _Span:
    __slots__ = ("name", "args", "clock", "rf", "ev", "t0")

    def __init__(self, name, args, clock):
        self.name = name
        self.args = args
        self.clock = clock

    def __enter__(self):
        self.rf = self.clock.range(self.name, self.args)
        self.ev = self.clock.mark()
        _stack().append(0)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter_ns() - self.t0
        stack = _stack()
        children = stack.pop()
        if stack:
            stack[-1] += t
        row = _record(self.name, t, children)
        end = None if self.ev is None else self.clock.mark()
        self.clock.add(row, t, self.ev, end)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Tracer:
    """The spans of one hot call: ``top(name, args)``, a context manager
    around the call, and inside it ``leaf(name)``, which ends the leaf
    open (if any) and opens the next; the top's end ends the last."""
    __slots__ = ("clock", "span", "name", "rf", "ev", "t0")

    def __init__(self, clock):
        self.clock = clock
        self.name = None

    def top(self, name: str, args: str | None = None):
        self.span = _Span(name, args, self.clock)
        return self

    def __enter__(self):
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.name is not None:
            self._end(time.perf_counter_ns(), self.clock.mark(), exc)
        return self.span.__exit__(*exc)

    def leaf(self, name: str) -> None:
        t, ev = time.perf_counter_ns(), self.clock.mark()
        if self.name is not None:
            self._end(t, ev, (None, None, None))
        self.name, self.t0, self.ev = name, t, ev
        self.rf = self.clock.range(name)
        _stack().append(0)

    def _end(self, t: int, ev, exc) -> None:
        """End the open leaf at host ns t and stream event ev."""
        if self.rf is not None:
            self.rf.__exit__(*exc)
        d = t - self.t0
        stack = _stack()
        children = stack.pop()
        stack[-1] += d
        self.clock.add(_record(self.name, d, children), d, self.ev, ev)
        self.name = None


def _resolve() -> None:
    """Stream ms of every span timed on a card (waits for its events)."""
    free = {}
    for row, index, start, end in _pending:
        end.synchronize()
        row[3] += start.elapsed_time(end)
        row[4] += 1
        free.setdefault(index, {})[id(start)] = start
        free[index][id(end)] = end
    _pending.clear()
    for index, events in free.items():
        _pool.setdefault(index, []).extend(events.values())


def snapshot() -> dict:
    """{"spans": {name: {calls, host_ns, self_ns, stream_ms, timed}},
    "counters": {name: value}}; stream ms summed over the ``timed``
    calls."""
    _resolve()
    keys = ("calls", "host_ns", "self_ns", "stream_ms", "timed")
    return {"spans": {name: dict(zip(keys, row))
                      for name, row in _spans.items()},
            "counters": dict(_counters)}


def reset() -> None:
    """Clears every span and counter."""
    _spans.clear()
    _pending.clear()
    _counters.clear()
