"""Tracing and timing helpers (PyTorch port of
``ia_spgemm_tpu.bench.profiling``).

The reference's only tracing is wall-clock timers (detail/utime.h); here
``trace`` is a ``torch.profiler`` window whose trace lands in a
directory, ``annotate`` a named span inside it, and the timers keep the
JAX package's return keys.

Where the time is taken: a function's result says which device it ran
on (a card when a tensor in it lies on one, else the CPU). On the card,
``time_op`` and ``device_time_ms`` time with CUDA events, and
``device_time_ms`` puts one event before the first call of a chain and
one after the last, then synchronises once, so no host round trip
enters it. ``dispatch_ms``,
``pipelined_wall_ms`` and ``sync_rtt_ms`` measure the host's side and
use the host clock. On the CPU, which runs each call to its end before
returning, every timer is ``time.perf_counter`` around calls.

The JAX package's ``force`` barrier (a one-element host readback, for a
remote TPU whose ``block_until_ready`` could return early) has no
counterpart: ``torch.cuda.synchronize`` waits for the card's work.

    with trace("/tmp/spgemm_trace"):
        with annotate("multiply"):
            C = spgemm_bitonic(A, B)
    # open the trace (chrome://tracing, Perfetto or TensorBoard)
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler window (host, and the card when there is one);
    its trace is written under log_dir when the window closes."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield log_dir


def annotate(name: str):
    """Named span that shows up inside profiler traces."""
    return torch.profiler.record_function(name)


def _result_device(out) -> torch.device:
    """The device of the first tensor on a card in a result (tensors,
    sequences, dicts and dataclasses of them); else the CPU."""
    if isinstance(out, torch.Tensor):
        return out.device
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    elif isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            d = _result_device(x)
            if d.type != "cpu":
                return d
    return torch.device("cpu")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _events_ms(fn: Callable, n: int, device: torch.device) -> float:
    """CUDA-event ms of n back-to-back calls, one synchronisation."""
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end)


def _host_ms(fn: Callable, n: int, device: torch.device) -> float:
    """Host-clock ms of n back-to-back calls and one synchronisation."""
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3


def time_op(fn: Callable, *args, iters: int = 5, warmup: int = 1,
            **kwargs) -> Dict:
    """Median ms of fn(*args, **kwargs), with its spread (CUDA events on
    the card, the host clock on the CPU), after at least one warm-up
    call (its result names the device). The reference times with
    gettimeofday around each kernel (main.cpp:715-749)."""
    call = lambda: fn(*args, **kwargs)  # noqa: E731
    dev = _result_device(call())
    for _ in range(warmup - 1):
        call()
    _sync(dev)
    timer = _events_ms if dev.type == "cuda" else _host_ms
    arr = np.asarray([timer(call, 1, dev) for _ in range(iters)])
    return {"median_ms": float(np.median(arr)),
            "min_ms": float(arr.min()), "max_ms": float(arr.max()),
            "iters": iters}


def sync_rtt_ms(reps: int = 7, device=None) -> float:
    """Host cost of one synchronisation with nothing queued
    (``torch.cuda.synchronize``): the floor under every per-call wall
    time that waits for its result. ``device``: the card by default
    (raises without one); on the CPU there is nothing to wait for."""
    from ia_spgemm_tpu_torch.formats.types import (DEFAULT_DEVICE,
                                                   checked_device)
    dev = checked_device(DEFAULT_DEVICE if device is None else device)
    _sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def dispatch_ms(fn: Callable, *args, reps: int = 5, **kwargs) -> float:
    """Host ms to issue one call without waiting for it (Python glue,
    argument checks, every launch it enqueues); each sample drains the
    queue afterwards so calls do not back up."""
    dev = _result_device(fn(*args, **kwargs))
    _sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        ts.append((time.perf_counter() - t0) * 1e3)
        _sync(dev)
    return float(np.median(ts))


def pipelined_wall_ms(fn: Callable, *args, n: int = 16, reps: int = 3,
                      **kwargs) -> Dict:
    """Host ms per call of n back-to-back calls and one synchronisation:
    the wall a caller pays per call when it does not wait for each
    result (device time, dispatch overlap and 1/n of a sync)."""
    call = lambda: fn(*args, **kwargs)  # noqa: E731
    dev = _result_device(call())
    _sync(dev)
    ts = [_host_ms(call, n, dev) / n for _ in range(reps)]
    return {"pipelined_wall_ms": float(np.median(ts)), "n": n}


def wall_decomposition(fn: Callable, *args, n: int = 16, chain: int = 8,
                       **kwargs) -> Dict:
    """A single call's synchronised wall split into device time
    (device_time_ms), host dispatch (dispatch_ms), one synchronisation
    (sync_rtt_ms) and the residual; the pipelined wall beside it."""
    call = lambda: fn(*args, **kwargs)  # noqa: E731
    dev = device_time_ms(call, chain=chain)
    disp = dispatch_ms(call)
    rtt = sync_rtt_ms(device=_result_device(call()))
    pipe = pipelined_wall_ms(call, n=n)
    single = dev["single_ms"]
    return {
        "single_wall_ms": single,
        "device_ms": dev["device_ms"],
        "dispatch_ms": disp,
        "sync_rtt_ms": rtt,
        "residual_ms": single - dev["device_ms"] - disp - rtt,
        "pipelined_wall_ms": pipe["pipelined_wall_ms"],
        "pipeline_n": pipe["n"],
    }


def device_time_ms(fn: Callable, *args, chain: int = 8, reps: int = 3,
                   **kwargs) -> Dict:
    """Device ms per call of fn: `chain` calls back to back between two
    CUDA events, one synchronisation after the last (on the CPU, the
    host clock around them); the median over `reps` chains.

    ``single_ms`` is one call's synchronised host wall, ``chain_ms`` the
    chain's whole time. The chain's events include any time the card
    waits on the host between calls, as the JAX package's chained
    estimate does."""
    call = lambda: fn(*args, **kwargs)  # noqa: E731
    dev = _result_device(call())
    _sync(dev)
    timer = _events_ms if dev.type == "cuda" else _host_ms
    t1, tn = [], []
    for _ in range(reps):
        t1.append(_host_ms(call, 1, dev))
        tn.append(timer(call, chain, dev))
    tn_m = float(np.median(tn))
    return {"device_ms": tn_m / chain, "single_ms": float(np.median(t1)),
            "chain_ms": tn_m, "chain": chain}
