"""gflops: 2 x the inputs' intermediate products x the products completed
in the window / the window's seconds (the reference's GFLOPS,
main.cpp:989). The products are counted from the inputs, not a plan."""


def read(run):
    loop = run.loop
    if not loop or not loop["completed"]:
        return None
    return 2.0 * run.products * loop["completed"] / loop["window_s"] / 1e9
