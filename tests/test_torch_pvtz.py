"""The headline workloads through the port on the CPU: H2O/cc-pVTZ
(58 bf) CCSD(T)_spinorb and restricted CRCCSD(T)_spatial from the
committed fixture, against the JAX package's own CPU runs of the same
inputs (expected_jax_cpu.json, written by tools/make_torch_pvtz_fixture.py;
expected_jax_cpu_crccsd_t_spatial.json, written by
tools/make_torch_spatial_fixture.py).  ~25 s and ~5 s on 4 CPU threads;
slow.
"""

import io
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"


@pytest.mark.slow
def test_h2o_ccpvtz_spinorb_matches_jax(tmp_path):
    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter

    expected = json.loads((FIXTURE / "expected_jax_cpu.json").read_text())
    for f in ("s.dat", "t.dat", "v.dat", "geom.dat", "els.in"):
        shutil.copy(FIXTURE / f, tmp_path / f)
    (tmp_path / "eri.dat").symlink_to(REPO / "data" / "h2o-cc-pvtz" / "eri.dat")
    rep = Reporter(stream=io.StringIO())
    res = run_calculation(tmp_path, rep, device="cpu")
    e0 = res.e_hf + res.e_nuc
    assert abs(e0 - expected["e_hf_total"]) < 1e-8
    assert abs(e0 + res.e_mp2 - expected["e_mp2_total"]) < 1e-8
    assert abs(e0 + res.e_ccsd - expected["e_ccsd_total"]) < 1e-8
    assert abs(e0 + res.e_ccsd_t - expected["e_ccsd_t_total"]) < 1e-8
    assert abs(res.e_ccsd_t - res.e_ccsd - expected["e_t_f64"]) < 1e-9
    assert res.hf.iterations == expected["scf_iterations"]
    assert res.cc.iterations == expected["cc_iterations"]
    text = rep.stream.getvalue()
    lines = text[text.index(" Final energy breakdown") :].split("\n")
    # the JAX driver's triples ran at "hybrid" (f32 panels), ~6e-10 Ha off
    # f64: every breakdown line but the three that carry E(T) is identical
    for got, want in zip(lines, expected["breakdown"][1:]):
        if "CCSD(T)" not in want and "Total" not in want:
            assert got == want


@pytest.mark.slow
def test_h2o_ccpvtz_crccsd_t_spatial_matches_jax(tmp_path):
    """The restricted slice: every line of the breakdown block equals the
    JAX run's (both f64 throughout), its unrounded values agree to 1e-8,
    and the SCF and CC iteration counts are equal."""
    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter

    expected = json.loads((FIXTURE / "expected_jax_cpu_crccsd_t_spatial.json").read_text())
    for f in ("s.dat", "t.dat", "v.dat", "geom.dat"):
        shutil.copy(FIXTURE / f, tmp_path / f)
    (tmp_path / "els.in").write_text(expected["els_in"])
    (tmp_path / "eri.dat").symlink_to(REPO / "data" / "h2o-cc-pvtz" / "eri.dat")
    rep = Reporter(stream=io.StringIO())
    res = run_calculation(tmp_path, rep, device="cpu")
    assert abs(res.e_hf + res.e_nuc - expected["e_hf_total"]) < 1e-8
    assert abs(res.e_mp2 - expected["e_mp2_corr"]) < 1e-8
    assert abs(res.e_ccsd - expected["e_ccsd_corr"]) < 1e-8
    assert abs(res.t1_diagnostic - expected["t1_diagnostic"]) < 1e-8
    for key, val in expected["triples"].items():
        assert abs(getattr(res.triples, key) - val) < 1e-8, key
    assert res.hf.iterations == expected["scf_iterations"]
    assert res.cc.iterations == expected["cc_iterations"]
    text = rep.stream.getvalue()
    lines = text[text.index(" Final energy breakdown") :].split("\n")
    assert lines[: len(expected["breakdown"]) - 1] == expected["breakdown"][1:]
