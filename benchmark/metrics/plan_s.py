"""plan_s: host seconds of plan_csr_auto(A, A) in set-up (the router's
cost model, then the chosen engine's planner and its conversions)."""


def read(run):
    return run.plan_s
