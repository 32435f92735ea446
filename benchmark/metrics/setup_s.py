"""setup_s: seconds from the process's start to the first timed call
(imports, the kernel libraries' load or build, the inputs, the plan,
the warm-up calls)."""


def read(run):
    return run.setup_s
