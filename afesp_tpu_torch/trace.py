"""Spans and counters inside the program: one small recorder.

`span(name)` is a context manager around a piece of the program's host
work.  With recording off and no profiler range wanted it hands back one
shared no-op context: one module-level flag test, no clock read, no
allocation, no device synchronisation.

With recording on (`enable()`), each span appends an entry (`Span`) to
the record of the calculation it belongs to: the calculation's id, its
name, its parent (the index of the enclosing span in the same record),
its start and end in `time.time_ns()`, and the change of every
registered counter between its opening and its closing (a child's
counts are in its parents' too).  A span opened with none open starts a
new record: `driver.run_calculation`'s root span `calc` makes one record
a calculation.  Records stay in memory (`records()`); whoever reads them
writes them out.  A span opened inside an open span of the same name is
not recorded (the outer one holds it), so a function that calls itself
through another entry point is timed once.

Spans do not synchronise the device: they say what the host was doing.
While the driver runs under AFESP_TORCH_PROFILE (`ranges()`), each span
is also the `torch.profiler.record_function` range of its name, so the
Chrome trace shows the program's spans on the kernels' timeline.

Counters stay where the work happens, as attributes of the function that
does it (`digit_pair_gemm.launches`); `register` names them to the
recorder, which reads them only while recording.  The recorder's own
counter is `syncs` (`synced.count`): the host-device synchronisations
the program makes.  On a card, while recording, torch's sync debug mode
("warn") reports every one, implicit ones included, and each report is
counted; elsewhere the explicit readback sites (`.tolist()`, `.item()`,
`float(tensor)`, `.cpu()`), which call `synced()`, are the count.

The spans (each read by a benchmark metric or emitted as a profiler
range): `calc` and the stage spans "Integral read-in", "Restricted
Hartree-Fock", "MP2", "CCSD", "CCSD(T)" (driver.py); `ccsd.iter`,
`ccsd.issue`, `ccsd.readback` (ops/cc_step.py); `digit_gemm`
(ops/exact_gemm.py); `rhf.host` and `rhf.fock` (methods/hf.py: each
device Fock build, with its readback, on every tier); `mo.slices`
(methods/mo_slices.py: the sliced transform, on both sliced tiers);
`eri.upload` (io/dat.py).  The counters: `syncs`, `_int_mm.launches`,
`digit_pair_gemm.launches` (ops/exact_gemm.py: what the device runs,
a graph replay adding what its capture issued), `digit_graph.calls`,
`digit_graph.captures`, `digit_graph.replays` (ops/exact_gemm.py: the
outermost digit-GEMM calls on a card inside a graph scope, the graphs
captured, the calls served by replaying one), `mo_slices.vvvv_chunks`
(methods/mo_slices.py: the v_vvvv chunks a sliced transform computed;
0 on the dense tier), `spatial_gemm.launches`, `spatial_gemm.issued_macs`,
`spatial_gemm.useful_macs` (ops/triples_spatial_cuda.py: K3's and K4's
group GEMM launches on a card, the multiply-adds their tiles issue and
those of the true shapes; their ratio is the GEMM's padding).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings

import torch

_NOOP = contextlib.nullcontext()
_SYNC_WARNING = "called a synchronizing CUDA operation"

_recording = False  # enable() / disable()
_ranges = False  # ranges(): each span is also a profiler range
_active = False  # _recording or _ranges: the one flag span() tests
_records: list[list[Span]] = []
_open: list[_Open] = []  # the open spans, innermost last
_counters: dict[str, tuple[object, str]] = {}  # name -> (holder, attribute)
_card_syncs = None  # (previous sync debug mode, warnings state) while counted


@dataclasses.dataclass(eq=False)
class Span:
    """One recorded span of one calculation (equal only to itself)."""

    calc: int  # the calculation's id: its record's index in records()
    name: str
    parent: int | None  # the enclosing span's index in the record
    start_ns: int
    end_ns: int | None = None  # None while open
    counts: dict = dataclasses.field(default_factory=dict)  # counter -> change


class _Open:
    """An open span: its entry (while recording) and its profiler range."""

    __slots__ = ("name", "index", "entry", "before", "range")

    def __init__(self, name: str):
        self.name = name
        self.index = self.entry = self.before = self.range = None

    def __enter__(self):
        if _ranges:
            from torch.profiler import record_function

            self.range = record_function(self.name)
            self.range.__enter__()
        if _recording:
            parent = next((s for s in reversed(_open) if s.entry is not None), None)
            if parent is None:
                _records.append([])
            calc = len(_records) - 1 if parent is None else parent.entry.calc
            record = _records[calc]
            self.index = len(record)
            self.before = _snapshot()
            self.entry = Span(calc, self.name, None if parent is None else parent.index,
                              time.time_ns())
            record.append(self.entry)
        _open.append(self)
        return self

    def __exit__(self, *exc):
        _open.remove(self)
        if self.entry is not None:
            self.entry.end_ns = time.time_ns()
            self.entry.counts = {k: v - self.before[k] for k, v in _snapshot().items()}
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """The context of the span `name` (module docstring)."""
    if not _active:
        return _NOOP
    if any(s.name == name for s in _open):
        return _NOOP
    return _Open(name)


def _snapshot() -> dict:
    return {name: getattr(holder, attr) for name, (holder, attr) in _counters.items()}


def _set_active() -> None:
    global _active
    _active = _recording or _ranges


def register(name: str, holder, attr: str = "launches") -> None:
    """Name the counter `holder.<attr>` to the recorder as `name`."""
    _counters[name] = (holder, attr)


def synced(n: int = 1) -> None:
    """Count `n` host-device synchronisations at an explicit readback
    site.  While the card's syncs are counted (enable() on a card) the
    sync debug mode counts these, so they are not counted twice."""
    if _card_syncs is None:
        synced.count += n


synced.count = 0
register("syncs", synced, "count")


def _count_card_syncs() -> None:
    """Put torch's sync debug mode to "warn" and count its warnings (not
    shown) in `synced.count`; other warnings are shown as before."""
    global _card_syncs
    state = warnings.catch_warnings()
    state.__enter__()
    warnings.filterwarnings("always", message=_SYNC_WARNING)
    show = warnings.showwarning

    def counted(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(_SYNC_WARNING):
            synced.count += 1
        else:
            show(message, category, filename, lineno, file, line)

    warnings.showwarning = counted
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    _card_syncs = (previous, state)


def enable() -> None:
    """Start recording (again); the records made so far are kept."""
    global _recording
    if _recording:
        return
    _recording = True
    _set_active()
    if torch.cuda.is_available():
        _count_card_syncs()


def disable() -> None:
    """Stop recording; on a card the sync debug mode and the warnings'
    state are put back as enable() found them."""
    global _recording, _card_syncs
    if not _recording:
        return
    _recording = False
    _set_active()
    if _card_syncs is not None:
        previous, state = _card_syncs
        _card_syncs = None
        torch.cuda.set_sync_debug_mode(previous)
        state.__exit__(None, None, None)


def records() -> list[list[Span]]:
    """Every calculation's record, oldest first (the list itself)."""
    return _records


@contextlib.contextmanager
def ranges():
    """While open, each span is also a profiler range of its name (the
    driver opens it under AFESP_TORCH_PROFILE)."""
    global _ranges
    before = _ranges
    _ranges = True
    _set_active()
    try:
        yield
    finally:
        _ranges = before
        _set_active()
