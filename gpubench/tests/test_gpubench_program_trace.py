"""The per-layer metrics that read the program's own spans and counters
(`harness/program_trace.py`), on fake records: each reads the traced
window's records alone, and None where there is no recorder."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from gpubench import run
from gpubench.harness import program_trace

BENCH = Path(__file__).resolve().parents[1]
MS = 1_000_000  # ns


def fake_record(scale: float = 1.0) -> list:
    """One calculation: two CC iterations (issue 8 ms with a 2 ms digit
    GEMM inside, readback 1 ms, 1 sync and 10 int8 GEMMs each), a 5 ms
    digit GEMM outside the iterations, two SCF iterations of 3 ms host
    work and a 4 ms ERI upload; every time times `scale`."""
    out = []

    def add(name, parent, t0, t1, **counts):
        out.append(SimpleNamespace(name=name, parent=parent, start_ns=int(t0 * scale * MS),
                                   end_ns=int(t1 * scale * MS), counts=counts))
        return len(out) - 1

    calc = add("calc", None, 0, 100)
    rhf = add("Restricted Hartree-Fock", calc, 0, 20)
    add("eri.upload", rhf, 0, 4)
    add("rhf.host", rhf, 5, 8)
    add("rhf.host", rhf, 10, 13)
    ccsd = add("CCSD", calc, 20, 60)
    add("digit_gemm", ccsd, 20, 25)
    for t in (30, 40):
        it = add("ccsd.iter", ccsd, t, t + 10, syncs=1, **{"_int_mm.launches": 10})
        issue = add("ccsd.issue", it, t, t + 8, **{"_int_mm.launches": 10})
        add("digit_gemm", issue, t + 1, t + 3, **{"_int_mm.launches": 10})
        add("ccsd.readback", it, t + 8, t + 9, syncs=1)
    return out


# the window's value of each metric on fake_record (scale 1)
WANT = {"ccsd_issue_ms": 8.0, "ccsd_wait_ms": 1.0, "ccsd_syncs_per_iter": 1.0,
        "digit_gemms_per_iter": 10.0, "digit_gemm_issue_ms": 2.0, "rhf_host_ms": 6.0,
        "eri_upload_ms": 4.0}


def traced_run(probe_of):
    """A traced run of two calculations whose probes all see `probe_of()`."""
    return SimpleNamespace(calcs=2, probes={name: probe_of() for name in WANT})


def window_probe():
    """A probe over a recorder holding one calculation before the window,
    the window's two and the profiled one after it, the outer ones with
    other times and counts."""
    records = [fake_record(7.0), fake_record(), fake_record(), fake_record(3.0)]
    for s in records[0] + records[3]:
        s.counts = {k: 5 * v for k, v in s.counts.items()}
    probe = program_trace.Probe()
    probe.tracer, probe.start = SimpleNamespace(records=lambda: records), 1
    return probe


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_reads_the_window_alone(name):
    mod = run.load_metric(BENCH, name)
    assert mod.Probe is program_trace.Probe
    assert mod.read(traced_run(window_probe)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_no_recorder_reads_none(name):
    mod = run.load_metric(BENCH, name)
    assert mod.read(traced_run(program_trace.Probe)) is None  # never installed
    assert mod.read(SimpleNamespace(calcs=2, probes={})) is None  # off a card
    short = window_probe()
    short.start = 3  # the recorder holds fewer calculations than the window
    assert mod.read(traced_run(lambda: short)) is None


def test_a_program_without_the_recorder_leaves_the_probe_empty(monkeypatch):
    import afesp_tpu_torch

    monkeypatch.delattr(afesp_tpu_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "afesp_tpu_torch.trace", None)
    probe = program_trace.Probe()
    probe.install(None)
    assert probe.tracer is None and probe.window(2) is None


def test_install_turns_the_program_recorder_on():
    from afesp_tpu_torch import trace

    probe = program_trace.Probe()
    try:
        probe.install(None)
        assert probe.tracer is trace and probe.start == len(trace.records())
        with trace.span("calc"):
            with trace.span("ccsd.iter"):
                pass
        (record,) = probe.window(1)
        assert [s.name for s in record] == ["calc", "ccsd.iter"]
    finally:
        trace.disable()
