"""The program's own spans and counters (`afesp_tpu_torch.trace`), for the
per-layer metrics that read them.

A metric that reads them defines `Probe = program_trace.Probe`.  On a card
under `--trace 1` the probe turns the program's recorder on before the
traced window and notes how many calculations the program has recorded
so far; `window` hands back the next `run.calcs` records, the window's
calculations, and so leaves out the profiled calculation that follows.
A span is (name, parent index in its record, start_ns, end_ns, counts:
the change of each counter over the span), in `time.time_ns`, the clock
`trace.profile_calc` maps the device trace onto.  Where the program has
no recorder (an older commit), or off a card, there is no probe or it
finds nothing, and the metric reads None.
"""

from __future__ import annotations


class Probe:
    """The program's recorder, on for the traced window."""

    def __init__(self):
        self.tracer = None
        self.start = 0

    def install(self, patches) -> None:
        try:
            from afesp_tpu_torch import trace
        except ImportError:
            return
        trace.enable()
        self.tracer, self.start = trace, len(trace.records())

    def window(self, calcs: int) -> list | None:
        """The window's records, one a calculation, or None."""
        if self.tracer is None or not calcs:
            return None
        records = self.tracer.records()[self.start:self.start + calcs]
        return records if len(records) == calcs else None


def window(run, metric: str) -> list | None:
    """The records of the traced window, as metric `metric`'s probe saw them."""
    probe = run.probes.get(metric)
    return probe.window(run.calcs) if probe is not None else None


def spans(records, name: str) -> list:
    return [s for record in records for s in record if s.name == name]


def seconds(spans_) -> float:
    return sum(s.end_ns - s.start_ns for s in spans_) * 1e-9


def inside(record, span, name: str) -> bool:
    """Whether `span` lies inside an open span `name` of its record."""
    while span.parent is not None:
        span = record[span.parent]
        if span.name == name:
            return True
    return False


def per_iteration(records, value) -> float | None:
    """value(records) over the CCSD iterations (`ccsd.iter` spans), or
    None without any."""
    n = len(spans(records, "ccsd.iter")) if records else 0
    return value(records) / n if n else None


def per_calc_ms(records, name: str) -> float | None:
    """Span `name`'s ms summed over the records, over the calculations,
    or None where it never ran."""
    if not records or not spans(records, name):
        return None
    return seconds(spans(records, name)) / len(records) * 1e3
