"""eri_upload_ms: the read-in's ERI store (`io/dat.py`), ms a
calculation: the program's span `eri.upload` (`IntStore._upload_packed`,
the one host-to-device copy of the packed store, made inside the RHF
stage where the Fock build first asks for it), summed over the traced
window, over its calculations.  Read from the program's recorder
(`afesp_tpu_torch.trace`), on a card only."""

from gpubench.harness import program_trace as pt
from gpubench.harness.program_trace import Probe  # noqa: F401


def read(run):
    return pt.per_calc_ms(pt.window(run, "eri_upload_ms"), "eri.upload")
