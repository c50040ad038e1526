"""rhf_host_ms: restricted Hartree-Fock (`methods/hf.py`), ms a
calculation: the program's spans `rhf.host` (each SCF iteration's numpy
work: the DIIS step of the last Fock build, X^T F X, eigh, density,
energy), summed over the traced window, over its calculations; the rest
of `rhf_ms` is the ERI upload (`eri_upload_ms`), the device Fock builds
and their readbacks.  Read from the program's recorder
(`afesp_tpu_torch.trace`), on a card only."""

from gpubench.harness import program_trace as pt
from gpubench.harness.program_trace import Probe  # noqa: F401


def read(run):
    return pt.per_calc_ms(pt.window(run, "rhf_host_ms"), "rhf.host")
