"""digit_graph_hit_pct: the digit GEMM (`ops/exact_gemm.py`), the share
of the outermost digit-GEMM calls on the card inside CCSD iterations that
replayed a CUDA graph: 100 times the change of the program's counter
`digit_graph.replays` over the `ccsd.iter` spans of the traced window,
over that of `digit_graph.calls`.  Read from the program's recorder
(`afesp_tpu_torch.trace`), on a card only; None where no such call was
made or the program has no such counter."""

from gpubench.harness import program_trace as pt
from gpubench.harness.program_trace import Probe  # noqa: F401


def _total(records, counter: str) -> int:
    return sum(s.counts.get(counter, 0) for s in pt.spans(records, "ccsd.iter"))


def read(run):
    records = pt.window(run, "digit_graph_hit_pct")
    calls = _total(records, "digit_graph.calls") if records else 0
    return 100.0 * _total(records, "digit_graph.replays") / calls if calls else None
