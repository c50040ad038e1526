"""mo_slices_ms: the sliced AO->MO transform (`methods/mo_slices.py`), ms
a calculation: the program's spans `mo.slices` (the transform from the
ERI store to the CCSD slices, on either sliced tier), summed over the
traced window, over its calculations.  Read from the program's recorder
(`afesp_tpu_torch.trace`), on a card only; None where the program has
no such span or ran the dense tier."""

from gpubench.harness import program_trace as pt
from gpubench.harness.program_trace import Probe  # noqa: F401


def read(run):
    return pt.per_calc_ms(pt.window(run, "mo_slices_ms"), "mo.slices")
