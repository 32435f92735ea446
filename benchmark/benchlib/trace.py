"""Device time from a torch.profiler window (the arithmetic of the port's
``bench/profile.py``: device activity by name, busy against window, the
hand kernels by their names).

The reductions work on plain tuples, so they are tested without a card:
a device activity is ``(name, start_us, end_us)``; a host event is
``(name, start_us, end_us)`` on the thread that ran the benchmark's
loop, where events nest.
"""

import re
from collections import defaultdict

# the hand-written kernels, K1-K13 (csrc/*.cu), by their names
KERNEL = re.compile(r"\bk(?:[1-6]|7[ab]|8|9|1[0-3])_[a-z_]+")
SPAN_PREFIX = "bench."
TOP = 10


def merged(intervals):
    """Sorted, merged (start, end) of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(device_events):
    """busy and window (us), hand-kernel and other device us, and us by
    operation name, of one window's device activity."""
    if not device_events:
        return None
    spans = merged((s, e) for _, s, e in device_events)
    busy = sum(e - s for s, e in spans)
    window = spans[-1][1] - spans[0][0]
    by_name = defaultdict(float)
    kernel = other = 0.0
    for name, s, e in device_events:
        by_name[name[:120]] += e - s
        if KERNEL.search(name):
            kernel += e - s
        else:
            other += e - s
    return {"busy_us": busy, "window_us": window, "kernel_us": kernel,
            "other_us": other, "by_name": dict(by_name)}


def top(by_name, scale, n=TOP):
    """The n largest entries as [name, value * scale], largest first."""
    return [[k, v * scale] for k, v in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(device_events, host_events):
    """us of device idle time by what the host was doing: for each gap
    between device activities, the innermost benchmark span and the
    innermost host event open at the gap's middle."""
    spans = merged((s, e) for _, s, e in device_events)
    gaps = [(s1 + (s2 - s1) / 2, s2 - s1)
            for (_, s1), (s2, _) in zip(spans, spans[1:]) if s2 > s1]
    events = sorted(host_events, key=lambda ev: (ev[1], -ev[2]))
    out = defaultdict(float)
    stack, i = [], 0
    for mid, length in sorted(gaps):
        while i < len(events) and events[i][1] <= mid:
            while stack and stack[-1][2] <= events[i][1]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][2] <= mid:
            stack.pop()
        span = next((ev[0] for ev in reversed(stack)
                     if ev[0].startswith(SPAN_PREFIX)), "outside the loop")
        inner = stack[-1][0] if stack else span
        label = span if inner == span else f"{span} / {inner}"
        out[label[:120]] += length
    return dict(out)


def profiler_events(prof):
    """(device activities, host events of the loop's thread) of a
    finished torch.profiler window, as tuples in us."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.events():
        item = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            device.append(item)
        else:
            host.append((item, e.thread))
    loop_threads = {t for (name, _, _), t in host
                    if name.startswith(SPAN_PREFIX)}
    return device, [item for item, t in host if t in loop_threads]
