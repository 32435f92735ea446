"""idle_pct.sync: 1 - device busy / window over the traced window, in
% (the cells whose caller waits, as BENCHMARK.json lists them)."""


def read(run):
    t = run.trace
    if not t:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])
