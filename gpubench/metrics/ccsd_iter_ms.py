"""ccsd_iter_ms: the CCSD (`methods/ccsd_spatial.py`, `ops/cc_step.py`),
ms an iteration: the synchronised span around `driver._run`'s call of the
CCSD stage (slices, the hybrid constants, the iterations), summed over
the traced window, over the CC iterations the program reported there."""

SPANS = {"ccsd": ("afesp_tpu_torch.driver:do_ccsd_spatial",
                  "afesp_tpu_torch.driver:do_ccsd_spinorb")}


def read(run):
    iterations = run.total("cc_iterations")
    if "ccsd" not in run.span_s or not iterations:
        return None
    return run.span_s["ccsd"] / iterations * 1e3
