"""fock_build_ms: restricted Hartree-Fock's device Fock builds
(`methods/hf.py`), ms a calculation: the program's spans `rhf.fock`
(each Fock build on the device with its readback, on every tier),
summed over the traced window, over its calculations.  Read from the
program's recorder (`afesp_tpu_torch.trace`), on a card only; None where
the program has no such span."""

from gpubench.harness import program_trace as pt
from gpubench.harness.program_trace import Probe  # noqa: F401


def read(run):
    return pt.per_calc_ms(pt.window(run, "fock_build_ms"), "rhf.fock")
