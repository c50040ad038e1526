"""The harness on the CPU: the yardstick's counts and trace arithmetic,
the window rule, the import rules, the values read from the program's
results, tiny cells (restricted and spin-orbital) driven end to end
through `run.main` with the card-only steps skipped, each added by files
alone, and faults planted in the program that `correct` has to catch."""

from __future__ import annotations

import ast
import functools
import hashlib
import itertools
import json
import re
import shutil
import sys
from pathlib import Path

import pytest
import torch

from gpubench import run
from gpubench.harness import answers, counts, spec, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gpubench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


# ---- the yardstick ---------------------------------------------------------

def test_triples_bounds_are_the_kernel_tables():
    trimer = counts.spatial_triples_flops(15, 159, doing_CR=True, strict=True) / counts.PEAK_F64
    dimer = counts.spatial_triples_flops(10, 106, doing_CR=True, strict=True) / counts.PEAK_F64
    assert round(trimer * 1e3) == 171
    assert round(dimer * 1e3, 1) == 11.0


def test_trimer_ccsd_iteration_counts():
    flops = counts.spatial_ccsd_iteration_flops(15, 159, "f64")
    assert round(flops / 1e11, 1) == 4.6
    # the hybrid iteration counts each digit pair: 21 for the L=6 products
    assert counts.digit_pairs(6) == 21 and counts.digit_pairs(5, 6) == 15
    assert counts.spatial_ccsd_iteration_flops(10, 106, "hybrid") > \
        20 * counts.spatial_ccsd_iteration_flops(10, 106, "f64")


def test_spinorb_bounds_are_the_kernel_table_and_the_iteration_bound():
    # K1 at the spin-orbital dimer (o=20, v=212: twice the spatial sizes):
    # the Sz-allowed blocks, 14.6% of the dense cube's 228.3 ms
    k1 = counts.spinorb_triples_flops(20, 212, strict=True) / counts.PEAK_F64
    assert round(k1 * 1e3, 1) == 33.4
    # the spin-orbital f64 iteration, Sz-blocked (ROADMAP: 6.0 ms)
    it = counts.spinorb_ccsd_iteration_flops(20, 212, "f64") / counts.PEAK_F64
    assert round(it * 1e3, 1) == 6.0
    # compute bounds both: the bytes take less
    assert counts.spinorb_triples_bytes(20, 212) / counts.HBM_BYTES_S < k1 / 100
    assert counts.spinorb_ccsd_iteration_bytes(20, 212) / counts.HBM_BYTES_S < it
    # Sz sparsity: of the 64 spin assignments of m, n, e, f, i, j, the 10
    # with m+n = e+f = i+j survive; the hybrid iteration counts 15 digit
    # pairs a contraction
    assert counts.sz_fraction("mnef,ijef->mnij") == 10 / 64
    assert counts.sz_fraction("mf,mafe->ae") == 16 / 64
    assert counts.spinorb_ccsd_iteration_flops(20, 212, "hybrid") > \
        10 * counts.spinorb_ccsd_iteration_flops(20, 212, "f64")


def test_spinorb_triples_count_is_the_work_of_the_allowed_spin_blocks():
    # the full cube carries `sz_fraction`'s shares: f-sums 18/128, m-sums
    # 18/128, outer products 6/32, and t3's allowed blocks 20/64
    o, v = 20, 212
    share = (3 * counts.sz_fraction("jkae,eibc->ijkabc") * v**4
             + 3 * counts.sz_fraction("imbc,majk->ijkabc") * o * v**3
             + 3 * counts.sz_fraction("ia,jkbc->ijkabc") * v**3)
    cube = o**3 * (2.0 * share + 10 * 20 / 64 * v**3)
    assert counts.spinorb_triples_flops(o, v) == pytest.approx(cube, rel=1e-12)
    # the strict triples, counted index by index (spins interleaved: the
    # count does not depend on the order of the spin-orbitals)
    o, v = 6, 4
    spin = [p % 2 for p in range(max(o, v))]
    mac = elementwise = 0
    for trip in itertools.combinations(range(o), 3):
        st = [spin[p] for p in trip]
        for r in range(3):
            sx, s1, s2 = st[r], st[(r + 1) % 3], st[(r + 2) % 3]
            for a, b, c in itertools.product(range(v), repeat=3):
                sa, sb, sc = spin[a], spin[b], spin[c]
                mac += sum(s1 + s2 == sa + spin[e] and spin[e] + sx == sb + sc
                           for e in range(v))
                mac += sum(sx + spin[m] == sb + sc and spin[m] + sa == s1 + s2
                           for m in range(o))
                mac += sx == sa and s1 + s2 == sb + sc
        elementwise += 10 * sum(spin[a] + spin[b] + spin[c] == sum(st)
                                for a, b, c in itertools.product(range(v), repeat=3))
    assert counts.spinorb_triples_flops(o, v, strict=True) == pytest.approx(
        2.0 * mac + elementwise, rel=1e-12)


def test_bound_is_the_longer_of_compute_and_memory():
    assert counts.bound_s(67e12, 0.0, counts.PEAK_F64) == pytest.approx(1.0)
    assert counts.bound_s(0.0, 3.35e12, counts.PEAK_F64) == pytest.approx(1.0)


def test_idle_share_is_one_minus_the_union_of_device_intervals():
    # window 0-100 ns: 10-20 and 15-30 overlap (busy 20), 50-60 (10), and
    # 90-120 ends after the window (10 inside it)
    events = [("gemm", 10, 20), ("gemm", 15, 30), ("copy", 50, 60), ("late", 90, 120)]
    spans = [("rhf", 0, 40), ("ccsd", 40, 100)]
    p = trace.summarise(events, spans, 0, 100)
    assert p.busy_s == pytest.approx(40e-9)
    assert p.window_s == pytest.approx(100e-9)
    # idle a span (rhf 10 + 20, ccsd 30), then the longest gaps
    assert dict(p.idle_gaps[:2]) == {"rhf (all gaps)": pytest.approx(30e-9),
                                     "ccsd (all gaps)": pytest.approx(30e-9)}
    assert [g[1] for g in p.idle_gaps[2:]] == pytest.approx([30e-9, 20e-9, 10e-9])
    assert [g[0].split(" @")[0] for g in p.idle_gaps[2:]] == ["ccsd", "rhf", "rhf"]
    assert p.device_ops[0] == ["late", pytest.approx(30e-9)]
    # device busy inside each span: rhf 10-30, ccsd 50-60 and 90-100
    assert p.span_busy_s == {"rhf": pytest.approx(20e-9), "ccsd": pytest.approx(20e-9)}


def test_every_seed_cycles_through_the_same_geometries():
    draws = [1, 2, 3]
    orders = {tuple(run.window_order(draws, seed)) for seed in (0, 7, 2**31 + 11, -5)}
    assert all(sorted(o) == draws for o in orders) and len(orders) > 1
    assert run.window_order(draws, 2**31 + 11) == run.window_order(draws, 2**31 + 11)


def test_the_window_is_whole_calculations():
    now = itertools.count()  # each clock reading advances by 1
    clock = lambda: next(now)
    calls = []
    window_s, walls = run.run_window(lambda: calls.append(1), 10, clock)
    # every call takes 1 tick between its two readings; the window closes
    # at the end of the first call that ends 10 ticks or more after it opened
    assert window_s >= 10 and len(walls) == len(calls) == 5
    assert all(w == 1 for w in walls)


# ---- the import rules ------------------------------------------------------

def imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    roots = imported_roots(path)
    assert not roots & set(run.FORBIDDEN), roots
    if path.relative_to(BENCH).parts[0] in ("reference", "inputs"):
        assert "afesp_tpu_torch" not in roots


def test_forbidden_modules_are_matched_by_whole_top_level_name(monkeypatch):
    assert "afesp_tpu_torch" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "afesp_tpu_torch_extra", sys)
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert run.forbidden_loaded() == ["jaxlib"]


# ---- BENCHMARK.json and the files it names ---------------------------------

def test_benchmark_names_its_files_and_keeps_the_contracts_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert len(w["why"]) <= 200
        cell = spec.load_cell(ROOT, w["name"])  # its traffic and limits files exist
        assert cell.end_to_end and cell.per_layer and cell.limits
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert run.metric_file(BENCH, m["name"]).exists()
        assert hasattr(run.load_metric(BENCH, m["name"]), "read")


def test_els_in_takes_the_mix_and_turns_restarts_off():
    cell = spec.load_cell(ROOT, "trimer-crccsdt-f64")
    s = cell.settings()
    assert s["calc_type"] == "CRCCSD(T)_spatial" and s["ccsd_precision"] == "f64"
    assert s["ccsd_diis_n_errmat"] == 6 and s["ccsd_t_tol"] == 1e-7
    assert not s["scf_write_guess"] and not s["ccsd_write_amplitudes"]
    assert spec.load_cell(ROOT, "dimer-crccsdt-hybrid").settings()["ccsd_precision"] == "hybrid"


# ---- a tiny cell end to end on the CPU -------------------------------------

TINY_CONFIG = {
    "name": "h2o-ccpvdz", "source": "test", "assumed": {}, "reduced": [],
    "basis": "cc-pvdz", "charges": [8, 1, 1],
    "coords_bohr": [[0.0, 0.0, -0.259099671344208], [0.0, -2.987363610796803, 2.056050018444942],
                    [0.0, 2.987363610796803, 2.056050018444942]],
    "nbasis": 24, "nocc": 5, "nvirt": 19,
}


def add_cell(root: Path, name: str, precision: str, limits: dict,
             calc_type: str = "CRCCSD(T)_spatial", reference: str = "rccsd_t") -> None:
    """A new configuration, mix and cell, by new files and new entries."""
    b = root / "gpubench"
    config = dict(TINY_CONFIG, els_in=json.loads(
        (BENCH / "configs" / "h2o-dimer-ccpvtz.json").read_text())["els_in"])
    (b / "configs" / "h2o-ccpvdz.json").write_text(json.dumps(config))
    traffic = f"tiny-{reference}-{precision}"
    (b / "traffic" / f"{traffic}.json").write_text(json.dumps(
        {"calc_type": calc_type, "ccsd_precision": precision,
         "displacement_bohr": 0.01, "geometry_draws": [1, 2],
         "loop": {"kind": "closed", "clients": 1}, "env": {},
         "reference": reference}))
    (b / "limits" / f"{name}.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if not any(c["name"] == "h2o-ccpvdz" for c in bench["configs"]):
        bench["configs"].append({"name": "h2o-ccpvdz", "source": "test",
                                 "file": "gpubench/configs/h2o-ccpvdz.json", "reduced": [],
                                 "why": "a tiny cell for the CPU tests"})
    bench["workloads"].append({"name": name, "config": "h2o-ccpvdz",
                               "traffic": traffic, "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + [name]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "gpubench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture
def root(tmp_path):
    """A copy of the benchmark's files (BENCHMARK.json and gpubench/)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def run_cell(root, name, capsys, trace_flag=0, seed=3000000000):
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace_flag)], root=root, device="cpu")
    out, err = capsys.readouterr()
    return rc, (json.loads(out.strip().split("\n")[-1]) if rc == 0 else None), err


LIMITS = {"e_hf": 1e-9, "e_corr": 1e-9, "e_triples": 1e-9, "e_cr": 1e-9}


def test_a_cell_is_added_by_files_alone_and_runs_end_to_end(root, capsys):
    before = digest(root)
    add_cell(root, "tiny-f64", "f64", LIMITS)
    after = digest(root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    rc, res, err = run_cell(root, "tiny-f64", capsys)
    assert rc == 0, err
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert "inputs: geometry 2" in err  # the mix's whole set is made
    assert set(res["metrics"]) == {"calc_s", "setup_s"}  # peak_gb: a card's
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(LIMITS)
    assert err.strip().split("\n")[-1].startswith("check ")


def test_a_traced_run_reports_the_per_layer_metrics(root, capsys):
    add_cell(root, "tiny-f64", "f64", LIMITS)
    rc, res, err = run_cell(root, "tiny-f64", capsys, trace_flag=1)
    assert rc == 0, err
    assert res["correct"]
    # spans on the CPU; the device's metrics and the rooflines need a card
    assert {"first_calc_s", "readin_ms", "rhf_ms", "mp2_ms", "ccsd_iter_ms",
            "triples_ms"} == set(res["metrics"])
    assert all(0 < m["value"] < 100 for k, m in res["metrics"].items() if k.endswith("_pct"))


# an E(T) of ~0.027 Ha scaled by 1 + 1e-8 moves 2.7e-10
SPINORB_LIMITS = {"e_hf": 1e-9, "e_corr": 1e-9, "e_triples": 1e-10}


def add_spinorb_cell(root: Path, monkeypatch) -> None:
    """The tiny spin-orbital cell, its (T) run at "f64" as K1 runs it on
    a card: the CPU's default tier is the f32 one, whose gap (1e-11 to
    5e-10 here) no limit that a 1e-8 fault would cross can hold."""
    from afesp_tpu_torch import driver

    add_cell(root, "tiny-spinorb", "f64", SPINORB_LIMITS, calc_type="CCSD(T)_spinorb",
             reference="ccsd_t_spinorb")
    monkeypatch.setattr(driver, "do_ccsd_t_spinorb",
                        functools.partial(driver.do_ccsd_t_spinorb, precision="f64"))


def test_a_spinorb_cell_is_added_by_files_alone_and_judged_on_its_ccsd_t(root, capsys,
                                                                          monkeypatch):
    before = digest(root)
    add_spinorb_cell(root, monkeypatch)
    after = digest(root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    rc, res, err = run_cell(root, "tiny-spinorb", capsys)
    assert rc == 0, err
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["checks"]) == set(SPINORB_LIMITS)
    # the (T) check reads the spin-orbital CCSD(T), not an empty group
    assert 0 < res["checks"]["e_triples"]["value"] <= SPINORB_LIMITS["e_triples"]
    # the program's and the reference's SCF/CC counts, side by side
    counts_line = next(line for line in err.split("\n") if line.startswith("iterations:"))
    prog, ref = counts_line.split("; reference ")
    assert set(re.findall(r"\d+/\d+", prog)) == set(re.findall(r"\d+/\d+", ref))


def test_program_values_are_unchanged_for_restricted_results_and_read_the_spinorb_ccsd_t():
    from types import SimpleNamespace

    from afesp_tpu_torch.config import parse_els_in

    def result(calc_type, triples=None):
        return SimpleNamespace(
            cfg=parse_els_in(f'&elsinput\ncalc_type="{calc_type}",\n/\n'), e_hf=-1.0,
            e_nuc=0.25, e_mp2=-0.125, e_ccsd=-0.1875, e_ccsd_t=-0.21875, triples=triples,
            hf=SimpleNamespace(iterations=7), cc=SimpleNamespace(iterations=5))

    base = {"e_hf": -0.75, "e_mp2": -0.125, "e_ccsd": -0.1875,
            "scf_iterations": 7, "cc_iterations": 5}
    tr = SimpleNamespace(**{k: -0.2 - i / 100 for i, k in enumerate(answers.TRIPLES)})
    assert answers.program_values(result("CRCCSD(T)_spatial", tr)) == base | {
        k: getattr(tr, k) for k in answers.TRIPLES}
    for calc in ("CCSD_spatial", "MP2_spatial", "CCSD_spinorb", "MP2_spinorb"):
        assert answers.program_values(result(calc)) == base, calc
    assert answers.program_values(result("CCSD(T)_spinorb")) == base | {"e_ccsd_tt": -0.21875}


def test_no_card_means_no_result(root, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "dimer-crccsdt-hybrid", "--seed", "1", "--seconds", "1"],
                  root=root)
    assert rc == 2 and capsys.readouterr().out == ""


# ---- faults the comparison has to catch --------------------------------------

def fault_unchanged_cc_state(monkeypatch):
    """A CC step that returns its state unchanged."""
    from afesp_tpu_torch.ops import cc_step

    def frozen(state, iteration_fn, energy_fn, nerr):
        e, rms2 = energy_fn(state.t1, state.t2, state.t2)
        return state, torch.stack([e, rms2])
    monkeypatch.setattr(cc_step, "cc_step", frozen)


def fault_half_the_triples(monkeypatch):
    """The (T) sums over half of the (i, j-slab) grid."""
    from afesp_tpu_torch.methods import triples_spatial as ts

    whole = ts._triples_total_spatial

    def half(*args, nocc, jlen, **kw):
        cells = [(i, j) for i in range(nocc) for j in range(0, nocc, jlen)]
        return whole(*args, nocc=nocc, jlen=jlen, **dict(kw, cells=cells[: len(cells) // 2]))
    monkeypatch.setattr(ts, "_triples_total_spatial", half)


def fault_altered_answer(monkeypatch):
    """One answer altered where it is produced: CR-CCSD(T) moved by ten
    times the limit."""
    from afesp_tpu_torch import driver

    real = driver.do_ccsd_t_spatial

    def altered(*a, **k):
        tr = real(*a, **k)
        tr.e_crccsd_tt += 10 * LIMITS["e_cr"]
        return tr
    monkeypatch.setattr(driver, "do_ccsd_t_spatial", altered)


@pytest.mark.parametrize("fault", [fault_unchanged_cc_state, fault_half_the_triples,
                                   fault_altered_answer])
def test_correct_is_false_under_a_planted_fault(root, capsys, monkeypatch, fault):
    add_cell(root, "tiny-f64", "f64", LIMITS)
    fault(monkeypatch)
    rc, res, err = run_cell(root, "tiny-f64", capsys)
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] == res["attempted"]


def fault_half_the_spinorb_triples(monkeypatch):
    """The spin-orbital (T) sums over half of its triples i<j<k."""
    from afesp_tpu_torch.methods import triples_spinorb as ts

    whole = ts._triples_total_strict

    def half(*args, **kw):
        *operands, ii, jj, kk = args
        n = len(ii) // 2
        return whole(*operands, ii[:n], jj[:n], kk[:n], **kw)
    monkeypatch.setattr(ts, "_triples_total_strict", half)


def fault_scaled_spinorb_triples(monkeypatch):
    """The spin-orbital E(T) scaled by 1 + 1e-8 where it is produced."""
    from afesp_tpu_torch import driver

    real = driver.do_ccsd_t_spinorb

    def scaled(sys_, cc, *a, **k):
        return cc.e_ccsd + (real(sys_, cc, *a, **k) - cc.e_ccsd) * (1 + 1e-8)
    monkeypatch.setattr(driver, "do_ccsd_t_spinorb", scaled)


@pytest.mark.parametrize("fault", [fault_unchanged_cc_state, fault_half_the_spinorb_triples,
                                   fault_scaled_spinorb_triples])
def test_a_spinorb_cell_is_not_correct_under_a_planted_fault(root, capsys, monkeypatch, fault):
    add_spinorb_cell(root, monkeypatch)
    fault(monkeypatch)
    rc, res, err = run_cell(root, "tiny-spinorb", capsys)
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] == res["attempted"]
