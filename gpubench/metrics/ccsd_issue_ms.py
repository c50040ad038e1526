"""ccsd_issue_ms: the CCSD (`ops/cc_step.py`), ms an iteration: the
program's span `ccsd.issue` (from an iteration's start until `cc_step`
returns: the host issuing the iteration's launches), summed over the
traced window, over its CCSD iterations (`ccsd.iter` spans).  Read from
the program's recorder (`afesp_tpu_torch.trace`), on a card only."""

from gpubench.harness import program_trace as pt
from gpubench.harness.program_trace import Probe  # noqa: F401


def read(run):
    return pt.per_iteration(pt.window(run, "ccsd_issue_ms"),
                            lambda r: pt.seconds(pt.spans(r, "ccsd.issue")) * 1e3)
