"""ccsd_wait_ms: the CCSD (`ops/cc_step.py`), ms an iteration: the
program's span `ccsd.readback` (the iteration's one readback: the host
blocked until the device has finished the iteration), summed over the
traced window, over its CCSD iterations (`ccsd.iter` spans).  Read from
the program's recorder (`afesp_tpu_torch.trace`), on a card only."""

from gpubench.harness import program_trace as pt
from gpubench.harness.program_trace import Probe  # noqa: F401


def read(run):
    return pt.per_iteration(pt.window(run, "ccsd_wait_ms"),
                            lambda r: pt.seconds(pt.spans(r, "ccsd.readback")) * 1e3)
