"""ccsd_syncs_per_iter: the CCSD (`ops/cc_step.py`), host-device
synchronisations an iteration: the program's counter `syncs` (on a card
every sync torch's sync debug mode reports, implicit ones included)
over the `ccsd.iter` spans of the traced window, over their number.
Read from the program's recorder (`afesp_tpu_torch.trace`), on a card
only."""

from gpubench.harness import program_trace as pt
from gpubench.harness.program_trace import Probe  # noqa: F401


def read(run):
    return pt.per_iteration(pt.window(run, "ccsd_syncs_per_iter"), lambda r: sum(
        s.counts.get("syncs", 0) for s in pt.spans(r, "ccsd.iter")))
