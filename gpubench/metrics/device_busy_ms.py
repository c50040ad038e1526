"""device_busy_ms: the device, ms a calculation: the union of the
intervals in which a kernel, copy or set ran during one calculation run
under torch.profiler with CUDA activity only.  The device's work, without
the host's pacing: steadier than the walls where the host paces the
launches."""


def read(run):
    p = run.profile
    if p is None or p.busy_s <= 0:
        return None
    return p.busy_s * 1e3
