"""device_idle_pct: the device, %: 1 - (the union of the intervals in
which a kernel, copy or set ran) / the wall of one calculation run under
torch.profiler with CUDA activity only."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
