"""digit_gemm_issue_ms: the digit GEMM (`ops/exact_gemm.py`), ms a CCSD
iteration: the program's spans `digit_gemm` (each outermost call of
`exact_gemm`, `exact_einsum`, `gemm_B_pre_streamed`: the host issuing its
digit-pair GEMMs, pads, casts and adds) inside a `ccsd.issue` span,
summed over the traced window, over its CCSD iterations.  The share of
`ccsd_issue_ms` that a batched digit GEMM could remove.  Read from the
program's recorder (`afesp_tpu_torch.trace`), on a card only."""

from gpubench.harness import program_trace as pt
from gpubench.harness.program_trace import Probe  # noqa: F401


def _issued_ms(records) -> float:
    return sum(pt.seconds([s for s in record if s.name == "digit_gemm"
                           and pt.inside(record, s, "ccsd.issue")])
               for record in records) * 1e3


def read(run):
    return pt.per_iteration(pt.window(run, "digit_gemm_issue_ms"), _issued_ms)
