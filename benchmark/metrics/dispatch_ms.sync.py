"""dispatch_ms.sync: median host ms to issue one planned call without
waiting for it, each sample drained afterwards, taken before the
profiler starts (the cells whose caller waits, as BENCHMARK.json lists
them)."""


def read(run):
    return run.dispatch_ms
