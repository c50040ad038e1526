"""The port's span-and-counter recorder (`afesp_tpu_torch/trace.py`), on
the CPU: the off path, the records' nesting, times and counter deltas,
the spans a driver run records on the generated 24-bf H2O (f64 and the
digit-GEMM "hybrid" CCSD), the report unchanged with recording on, and
the inner spans in the AFESP_TORCH_PROFILE trace.  The card's sync
count is held in tests/test_torch_gpu.py."""

import io
import json
import time

import numpy as np
import pytest
import torch
from torch_fixtures import breakdown_block, masked_report, write_h2o

from afesp_tpu_torch import driver as tdriver
from afesp_tpu_torch import trace
from afesp_tpu_torch.io.dat import IntStore
from afesp_tpu_torch.io.report import Reporter

STAGES = ("Integral read-in", "Restricted Hartree-Fock", "MP2", "CCSD", "CCSD(T)")
CRCC = "CRCCSD(T)_spatial"


@pytest.fixture
def recording():
    """Recording on for one test, off after it."""
    trace.enable()
    try:
        yield
    finally:
        trace.disable()


def _run(wd, record: bool):
    """One run_calculation on the CPU: (result, report, its record or None)."""
    n = len(trace.records())
    rep = Reporter(stream=io.StringIO())
    if record:
        trace.enable()
    try:
        res = tdriver.run_calculation(wd, rep, device="cpu")
    finally:
        trace.disable()
    new = trace.records()[n:]
    assert len(new) == (1 if record else 0)
    return res, rep.stream.getvalue(), new[0] if new else None


@pytest.fixture(scope="module")
def f64_runs(tmp_path_factory):
    """The f64 restricted chain, once with recording off and once on."""
    wd = write_h2o(tmp_path_factory.mktemp("h2o"), CRCC)
    return wd, _run(wd, False), _run(wd, True)


@pytest.fixture(scope="module")
def hybrid_run(tmp_path_factory):
    wd = write_h2o(tmp_path_factory.mktemp("h2o_hybrid"), CRCC, 'ccsd_precision = "hybrid",\n')
    return _run(wd, True)


def named(record, name):
    return [s for s in record if s.name == name]


def children(record, parent, name):
    i = record.index(parent)
    return [s for s in record if s.parent == i and s.name == name]


def test_off_a_span_is_the_shared_no_op_and_records_nothing(monkeypatch):
    """Recording off and no profiler: every span is one shared no-op
    context; no clock is read, no range opened, nothing recorded."""
    assert not trace._recording and not trace._ranges
    assert trace.span("a") is trace.span("b") is trace._NOOP

    def refuse(*a, **k):
        raise AssertionError("read or opened with recording off")

    monkeypatch.setattr(trace.time, "time_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    n = len(trace.records())
    with trace.span("calc"):
        with trace.span("ccsd.iter"):
            pass
    assert len(trace.records()) == n and trace._open == []


def test_spans_nest_with_their_parent_calculation_and_times(recording):
    """Each root span starts a record; children name their parent's
    index, share its calculation id, and lie inside it in time, between
    time.time_ns() read before and after.  A span inside an open span of
    the same name is not recorded."""
    t0 = time.time_ns()
    with trace.span("calc"):
        with trace.span("a"):
            with trace.span("b"):
                with trace.span("a"):  # re-entered: the outer "a" holds it
                    pass
        with trace.span("c"):
            pass
    t1 = time.time_ns()
    with trace.span("calc"):
        pass
    first, second = trace.records()[-2:]
    assert [(s.name, s.parent) for s in first] == [("calc", None), ("a", 0), ("b", 1), ("c", 0)]
    calc = len(trace.records()) - 2
    assert {s.calc for s in first} == {calc} and second[0].calc == calc + 1
    for s in first:
        assert t0 <= s.start_ns <= s.end_ns <= t1
        if s.parent is not None:
            p = first[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_a_counter_lands_in_the_innermost_open_span(recording, monkeypatch):
    """A registered counter's change is in the span open around it and in
    that span's parents, and not in a sibling; `synced()` counts the
    explicit readbacks off a card."""
    monkeypatch.setattr(trace, "_counters", dict(trace._counters))

    def work():
        pass

    work.launches = 0
    trace.register("work.launches", work)
    with trace.span("calc"):
        with trace.span("inner"):
            work.launches += 3
            trace.synced()
        with trace.span("sibling"):
            pass
        work.launches += 1
    calc, inner, sibling = trace.records()[-1]
    assert inner.counts["work.launches"] == 3 and inner.counts["syncs"] == 1
    assert calc.counts["work.launches"] == 4 and calc.counts["syncs"] == 1
    assert sibling.counts["work.launches"] == 0 and sibling.counts["syncs"] == 0
    assert set(calc.counts) == {"syncs", "_int_mm.launches", "digit_pair_gemm.launches",
                                "digit_graph.calls", "digit_graph.captures",
                                "digit_graph.replays", "mo_slices.vvvv_chunks",
                                "spatial_gemm.launches", "spatial_gemm.issued_macs",
                                "spatial_gemm.useful_macs", "triples_fused.issued_macs",
                                "triples_fused.cube_macs", "work.launches"}


def test_the_group_gemm_counters_are_registered():
    """K3's and K4's group GEMM launches and the multiply-adds they issue
    and need (ops/triples_spatial_cuda.py `spatial_gemm`) are registered
    counters, at 0 off the card."""
    from afesp_tpu_torch.ops import triples_spatial_cuda as S

    for attr in ("launches", "issued_macs", "useful_macs"):
        assert trace._counters[f"spatial_gemm.{attr}"] == (S.spatial_gemm, attr)
        assert getattr(S.spatial_gemm, attr) == 0


def test_the_k1_counters_are_registered():
    """The multiply-adds K1's spin-block tiles issue and those the dense
    design issued (ops/triples_cuda.py `triples_fused`) are registered
    counters, at 0 off the card."""
    from afesp_tpu_torch.ops import triples_cuda as K

    for attr in ("issued_macs", "cube_macs"):
        assert trace._counters[f"triples_fused.{attr}"] == (K.triples_fused, attr)
        assert getattr(K.triples_fused, attr) == 0


def test_enable_and_disable_are_idempotent():
    trace.enable()
    trace.enable()
    assert trace.span("x") is not trace._NOOP
    trace.disable()
    trace.disable()
    assert trace.span("x") is trace._NOOP


def test_a_driver_run_records_its_stages_and_one_triple_per_cc_iteration(f64_runs):
    """The root `calc`, the five stage spans under it, one `ccsd.iter`
    with its `ccsd.issue` and `ccsd.readback` per reported CC iteration
    (one readback each), and one `rhf.host` per SCF iteration."""
    _, _, (res, _, record) = f64_runs
    assert record[0].name == "calc" and record[0].parent is None
    for name in STAGES:
        (stage,) = named(record, name)
        assert stage.parent == 0
    (ccsd,) = named(record, "CCSD")
    iters = children(record, ccsd, "ccsd.iter")
    assert len(iters) == len(named(record, "ccsd.iter")) == res.cc.iterations > 1
    for it in iters:
        (issue,) = children(record, it, "ccsd.issue")
        (readback,) = children(record, it, "ccsd.readback")
        assert issue.end_ns <= readback.start_ns
        assert it.counts["syncs"] == readback.counts["syncs"] == 1
    (rhf,) = named(record, "Restricted Hartree-Fock")
    assert len(children(record, rhf, "rhf.host")) == len(named(record, "rhf.host")) \
        == res.hf.iterations
    assert all(s.end_ns is not None for s in record)
    # a CPU run keeps the dense ERIs on the host: no upload
    assert named(record, "eri.upload") == [] and named(record, "digit_gemm") == []


def test_the_report_is_unchanged_with_recording_on(f64_runs):
    _, (_, off, _), (_, on, _) = f64_runs
    assert breakdown_block(on) == breakdown_block(off)
    assert masked_report(on) == masked_report(off)


def test_hybrid_int8_gemms_all_land_in_the_cc_iterations(hybrid_run):
    """At "hybrid" every int8 GEMM of the run is in a CC iteration: the
    iterations' `_int_mm.launches` add up to the run's, which is at
    least its digit-pair products; the digit GEMMs are spans inside the
    iterations' issue phase, none inside another."""
    res, _, record = hybrid_run
    total = record[0].counts["_int_mm.launches"]
    iters = named(record, "ccsd.iter")
    assert len(iters) == res.cc.iterations
    assert sum(s.counts["_int_mm.launches"] for s in iters) == total
    assert total >= record[0].counts["digit_pair_gemm.launches"] > 0
    issues = {record.index(s) for s in named(record, "ccsd.issue")}
    gemms = named(record, "digit_gemm")
    assert gemms and all(s.parent in issues for s in gemms)


def test_no_digit_graph_counter_moves_off_the_card(hybrid_run):
    """The hybrid CCSD solve opens its digit-graph scope on the CPU too,
    where no call engages it: the run's digit_graph counters stay 0."""
    _, _, record = hybrid_run
    assert record[0].counts["digit_pair_gemm.launches"] > 0
    for name in ("calls", "captures", "replays"):
        assert record[0].counts[f"digit_graph.{name}"] == 0


def test_the_eri_upload_is_a_span(recording):
    """`IntStore`'s one copy of the packed store to a device is the span
    `eri.upload`; the cached copy makes none."""
    n = 4
    npair = n * (n + 1) // 2
    ints = IntStore(nbasis=n, eri_packed=np.arange(npair * (npair + 1) // 2, dtype=float))
    with trace.span("calc"):
        first = ints.packed_on_device("cpu")
        assert ints.packed_on_device("cpu") is first
    record = trace.records()[-1]
    assert [(s.name, s.parent) for s in record] == [("calc", None), ("eri.upload", 0)]
    assert torch.equal(first, torch.as_tensor(ints.eri_packed))


def test_the_profile_trace_carries_the_inner_spans(f64_runs, tmp_path, monkeypatch):
    """Under AFESP_TORCH_PROFILE each span is a range of the Chrome
    trace: the stages and the spans inside them."""
    wd = f64_runs[0]
    monkeypatch.setenv(tdriver.PROFILE_ENV, str(tmp_path))
    tdriver.run_calculation(wd, Reporter(stream=io.StringIO()), device="cpu")
    (path,) = tmp_path.glob("*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert set(STAGES) | {"calc", "ccsd.iter", "ccsd.issue", "ccsd.readback", "rhf.host"} <= names
