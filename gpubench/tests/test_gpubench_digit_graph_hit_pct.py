"""The per-layer metric digit_graph_hit_pct on fake records: the window's
CCSD iterations alone, and None where the program has no such counter or
made no such call."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from gpubench import run
from gpubench.harness import program_trace

BENCH = Path(__file__).resolve().parents[1]
NAME = "digit_graph_hit_pct"


def fake_record(replays: list[int], calls: int = 40, outside: int = 7) -> list:
    """One calculation: a digit-GEMM call outside the CC iterations
    (counted as a call, never a replay), then one `ccsd.iter` span per
    entry of `replays`, each with `calls` calls."""
    out = []

    def add(name, parent, **counts):
        out.append(SimpleNamespace(name=name, parent=parent, start_ns=0, end_ns=1,
                                   counts=counts))
        return len(out) - 1

    calc = add("calc", None)
    ccsd = add("CCSD", calc)
    add("digit_gemm", ccsd, **{"digit_graph.calls": outside})
    for r in replays:
        add("ccsd.iter", ccsd, **{"digit_graph.calls": calls, "digit_graph.replays": r})
    return out


def traced_run(records: list, start: int = 1, calcs: int = 2):
    probe = program_trace.Probe()
    probe.tracer, probe.start = SimpleNamespace(records=lambda: records), start
    return SimpleNamespace(calcs=calcs, probes={NAME: probe})


def test_reads_the_window_iterations_alone():
    """Two window calculations of 13 iterations (first eager, second
    capturing, eleven replaying: 11 of 13) between an earlier and a
    later calculation that replayed every call."""
    window = [fake_record([0, 0] + [40] * 11) for _ in range(2)]
    records = [fake_record([40] * 13)] + window + [fake_record([40] * 13)]
    mod = run.load_metric(BENCH, NAME)
    assert mod.Probe is program_trace.Probe
    assert mod.read(traced_run(records)) == pytest.approx(100.0 * 11 / 13)


def test_reads_none_without_the_counter_or_a_call():
    mod = run.load_metric(BENCH, NAME)
    bare = fake_record([0] * 13)
    for s in bare:
        s.counts = {}  # a program without the counters
    assert mod.read(traced_run([bare, bare, bare])) is None
    assert mod.read(traced_run([fake_record([0] * 13, calls=0, outside=0)] * 3)) is None
    assert mod.read(traced_run([fake_record([40] * 13)] * 2)) is None  # too few records
    assert mod.read(SimpleNamespace(calcs=2, probes={})) is None  # off a card
    assert mod.read(traced_run([], calcs=0)) is None
