"""What a loop needs of the device: a clock, completion events, spans.

On a card an event is a CUDA event recorded on the current stream; on
the CPU (the tests' tiny cells) a call has finished when it returns, so
there is nothing to record or wait for. Spans are
``torch.profiler.record_function`` ranges in a traced run and cost
nothing otherwise.
"""

import contextlib
import statistics
import time


class Runtime:
    clock = staticmethod(time.perf_counter)

    def __init__(self, device, spans=False):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.spans = spans

    def span(self, name):
        if self.spans:
            return self.torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def record(self):
        if not self.cuda:
            return None
        ev = self.torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def wait(ev):
        if ev is not None:
            ev.synchronize()

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def dispatch_ms(self, call, reps):
        """Median host ms to issue one call without waiting for it, the
        queue drained after each sample (the port's
        ``bench/profiling.py`` ``dispatch_ms``)."""
        self.sync()
        ts = []
        for _ in range(reps):
            t0 = self.clock()
            out = call()
            ts.append((self.clock() - t0) * 1e3)
            del out
            self.sync()
        return statistics.median(ts)
