"""digit_gemms_per_iter: the digit GEMM (`ops/exact_gemm.py`), int8 GEMM
launches a CCSD iteration: the program's counter `_int_mm.launches` (one
a `torch._int_mm` call, after the K and tile splits) over the
`ccsd.iter` spans of the traced window, over their number.  Read from the
program's recorder (`afesp_tpu_torch.trace`), on a card only."""

from gpubench.harness import program_trace as pt
from gpubench.harness.program_trace import Probe  # noqa: F401


def read(run):
    return pt.per_iteration(pt.window(run, "digit_gemms_per_iter"), lambda r: sum(
        s.counts.get("_int_mm.launches", 0) for s in pt.spans(r, "ccsd.iter")))
