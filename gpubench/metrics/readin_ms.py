"""readin_ms: the integral read-in (`io/dat.py`, `io/fastparse.py`), ms a
calculation: the benchmark's synchronised span around `driver._run`'s call
of `dat.read_integrals`, summed over the traced window over its
calculations."""

SPANS = {"readin": ("afesp_tpu_torch.driver:dat.read_integrals",)}


def read(run):
    return run.span_ms("readin")
