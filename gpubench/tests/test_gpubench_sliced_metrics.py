"""The sliced f64 tier's yardstick (`harness/counts_sliced.py`) against
counts by hand, and its four per-layer metrics (fock_build_ms,
mo_slices_ms, fock_roofline_pct, mo_slices_roofline_pct) on fake runs:
the window's records alone, the profiled calculation's device time,
and None where the program has no such span or build."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from gpubench import run
from gpubench.harness import counts, counts_sliced, program_trace

BENCH = Path(__file__).resolve().parents[1]


def test_counts_by_hand_at_small_n():
    # n = 3, o = 1, v = 2: 6 AO pairs, 21 unique integrals, 3 virtual pairs
    assert counts_sliced.fock_build_bytes(3) == 8 * 21
    # first half 6 (27 + 9 + 12), occupied columns 3 * 2 * 27, virtual
    # pairs 3 (2 * 9 + 4 * 3): 540 multiply-accumulates
    assert counts_sliced.sliced_transform_flops(3, 1) == 2 * 540
    # the store, then vvvv 16, vvov 8, oovv + ovov 8, oovo 2, oooo 1
    assert counts_sliced.sliced_transform_bytes(3, 1) == 8 * (21 + 16 + 8 + 8 + 2 + 1)


def test_the_pentamer_bounds():
    # 7.12 GB of unique integrals a Fock build: 2.126 ms at 3.35 TB/s
    assert round(counts_sliced.fock_build_bytes(290) / counts.HBM_BYTES_S * 1e3, 3) == 2.126
    # the transform is compute-bound: 7.67 TFLOP at 67 TFLOP/s, 114 ms
    flops = counts_sliced.sliced_transform_flops(290, 25)
    nbytes = counts_sliced.sliced_transform_bytes(290, 25)
    assert round(flops / 1e12, 2) == 7.67
    assert counts.bound_s(flops, nbytes, counts.PEAK_F64) == pytest.approx(flops / 67e12)


def fake_record(focks: int, fock_ns: int, slices_ns: int | None) -> list:
    out = []

    def add(name, parent, ns):
        out.append(SimpleNamespace(name=name, parent=parent, start_ns=0, end_ns=ns, counts={}))
        return len(out) - 1

    calc = add("calc", None, 10**10)
    rhf = add("Restricted Hartree-Fock", calc, 10**9)
    for _ in range(focks):
        add("rhf.fock", rhf, fock_ns)
    if slices_ns is not None:
        add("mo.slices", add("MP2", calc, 10**9), slices_ns)
    return out


def traced(name, records, start=1, calcs=2, **kw):
    probe = program_trace.Probe()
    probe.tracer, probe.start = SimpleNamespace(records=lambda: records), start
    return SimpleNamespace(calcs=calcs, probes={name: probe}, **kw)


@pytest.mark.parametrize("name,want", [("fock_build_ms", 24 * 30.0), ("mo_slices_ms", 600.0)])
def test_the_span_readers_read_the_window_alone(name, want):
    window = [fake_record(24, 30_000_000, 600_000_000) for _ in range(2)]
    records = [fake_record(50, 10**9, 10**9)] + window + [fake_record(50, 10**9, 10**9)]
    mod = run.load_metric(BENCH, name)
    assert mod.Probe is program_trace.Probe
    assert mod.read(traced(name, records)) == pytest.approx(want)
    # a dense run has Fock builds and no transform; an older program neither
    dense = [fake_record(24, 30_000_000, None)] * 3
    assert (mod.read(traced(name, dense)) is None) == (name == "mo_slices_ms")
    assert mod.read(traced(name, [fake_record(0, 0, None)] * 3)) is None
    assert mod.read(SimpleNamespace(calcs=2, probes={})) is None  # off a card


def profiled_run(span_busy: dict, scf_iterations: int = 25):
    return SimpleNamespace(profile=SimpleNamespace(span_busy_s=span_busy),
                           profiled={"scf_iterations": scf_iterations},
                           sizes={"nbasis": 290, "nocc": 25, "nvirt": 265})


def test_the_rooflines_read_the_profiled_device_time():
    fock = run.load_metric(BENCH, "fock_roofline_pct")
    slices = run.load_metric(BENCH, "mo_slices_roofline_pct")
    assert fock.SPANS == {"fock": ("afesp_tpu_torch.methods.hf:fock_build_rows",)}
    assert slices.SPANS == {
        "mo_slices": ("afesp_tpu_torch.methods.mo_slices:ao_to_mo_slices_f64",)}
    # 24 builds at 4x their 2.126 ms bound: 25%
    bound = counts_sliced.fock_build_bytes(290) / counts.HBM_BYTES_S
    assert fock.read(profiled_run({"fock": 24 * 4 * bound})) == pytest.approx(25.0)
    # the transform at twice its 114 ms bound: 50%
    t = counts_sliced.sliced_transform_flops(290, 25) / counts.PEAK_F64
    assert slices.read(profiled_run({"mo_slices": 2 * t})) == pytest.approx(50.0)
    # nothing wrapped ran (the parent, the dense tier), or no card
    for mod in (fock, slices):
        assert mod.read(profiled_run({"ccsd": 1.0})) is None
        assert mod.read(SimpleNamespace(profile=None, profiled=None, sizes={})) is None
