"""first_calc_s: the driver, s: the wall of the set-up's calculation, the
first `run_calculation` of the process, with the kernel libraries
already built: cuBLAS and cuSOLVER start-up, the allocator's growth and
the kernels' first loads on top of a calculation.  Every user who runs
one input a process pays it; it is a part of `setup_s`.  One sample a
run, so it spreads too widely for a bound of its own."""


def read(run):
    return run.first_calc_s
