"""The plain reference (`gpubench/reference/`) against the JAX package's
committed values, and each cell's controls (one layer in a lower
precision, `readings.py`) against the cells' limits.

CPU: H2O/cc-pVTZ (58 bf) from the committed inputs
(`data/h2o-cc-pvtz-2.00_104.45/`, ERIs `data/h2o-cc-pvtz/eri.dat`)
against `expected_jax_cpu_crccsd_t_spatial.json`.  Card (marked `gpu`,
run with `-m gpu`): the benchmark's own inputs at seed 0, the committed
geometries, for the dimer and the trimer against their committed JSON.

    python -m pytest gpubench/tests -q [-m gpu]
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from gpubench.harness import answers, spec
from gpubench.reference import rccsd_t

ROOT = Path(__file__).resolve().parents[2]
PVTZ = ROOT / "data" / "h2o-cc-pvtz-2.00_104.45"
PVTZ_ERI = ROOT / "data" / "h2o-cc-pvtz" / "eri.dat"
CELLS = ("dimer-crccsdt-hybrid", "trimer-crccsdt-f64")
# the f64 contract of the port against JAX (PERF.md §2); the reference
# reads the same files as JAX did and reaches ~1e-14
F64_TOL = 1e-10


def expected(path: Path) -> tuple[dict, dict]:
    want = json.loads(path.read_text())
    values = {"e_hf": want["e_hf_total"], "e_mp2": want["e_mp2_corr"],
              "e_ccsd": want["e_ccsd_corr"], **want["triples"]}
    return values, spec.parse_namelist(want["els_in"]) | {
        "scf_iterations": want["scf_iterations"], "cc_iterations": want["cc_iterations"]}


@pytest.fixture(scope="module")
def pvtz_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pvtz")
    for f in ("s.dat", "t.dat", "v.dat", "geom.dat"):
        shutil.copy(PVTZ / f, d / f)
    (d / "eri.dat").symlink_to(PVTZ_ERI)
    return d


@pytest.fixture(scope="module")
def pvtz_f64(pvtz_dir):
    values, els = expected(PVTZ / "expected_jax_cpu_crccsd_t_spatial.json")
    return values, els, rccsd_t.run(pvtz_dir, els, "cpu", torch.float64)


def test_reference_matches_jax_at_pvtz(pvtz_f64):
    want, els, got = pvtz_f64
    for key, value in want.items():
        assert abs(got[key] - value) <= F64_TOL, (key, got[key], value)
    assert got["scf_iterations"] == els["scf_iterations"]
    assert got["cc_iterations"] == els["cc_iterations"]


# each cell's controls, as `readings.py --controls` names them (PERF.md,
# Findings, gives their readings at the cells' own sizes on the card)
CONTROLS = {
    "dimer-crccsdt-hybrid": ("reference:fock=float32", "reference:corr=float32",
                             "program:triples=hybrid", "reference:cr=bfloat16"),
    "trimer-crccsdt-f64": ("reference:fock=float32", "reference:corr=float32",
                           "program:ccsd_precision=hybrid", "program:triples=hybrid"),
}


class PvtzSession:
    """What `readings.run_control` asks of a run's session, at pVTZ on
    the CPU: the cell's mix on the committed pVTZ inputs."""

    def __init__(self, cell: str, pvtz_dir: Path, els_text: str):
        self.cell = spec.load_cell(ROOT, cell)
        self.cell.config = dict(self.cell.config, els_in=els_text)
        self.dir = pvtz_dir

    def reference(self, draw, dtype=None, lower=None):
        return rccsd_t.run(self.dir, self.cell.settings(), "cpu", dtype or torch.float64, lower)

    def calc(self, draw, els_in=None):
        from afesp_tpu_torch import driver

        wd = self.dir / "program"
        shutil.rmtree(wd, ignore_errors=True)
        wd.mkdir()
        for f in ("s.dat", "t.dat", "v.dat", "geom.dat", "eri.dat"):
            (wd / f).symlink_to(self.dir / f)
        (wd / "els.in").write_text(els_in or self.cell.els_in())
        return answers.program_values(driver.run_calculation(wd, device="cpu"))


@pytest.mark.parametrize("cell,control", [(c, k) for c in CELLS for k in CONTROLS[c]])
def test_each_control_fails_the_cells_limits(pvtz_dir, cell, control):
    """A control put in the program's place reads at least one compared
    number above the cell's limit (at pVTZ here)."""
    from gpubench import readings

    els_text = json.loads((PVTZ / "expected_jax_cpu_crccsd_t_spatial.json").read_text())["els_in"]
    s = PvtzSession(cell, pvtz_dir, els_text)
    ref = s.reference(0)
    failed, worst = answers.judge([(readings.run_control(s, 0, control), ref)], s.cell.limits)
    assert failed == 1, worst


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell,data", [
    ("dimer-crccsdt-hybrid", "h2o-dimer-cc-pvtz"),
    ("trimer-crccsdt-f64", "h2o-trimer-cc-pvtz"),
])
def test_reference_matches_jax_at_seed_0_on_the_card(card, tmp_path, cell, data):
    from gpubench import inputs

    c = spec.load_cell(ROOT, cell)
    inputs.make_inputs(tmp_path, c.config["charges"], c.config["coords_bohr"],
                       c.config["basis"], seed=0, amplitude=0.01, device=card)
    assert (tmp_path / "geom.dat").read_bytes() == (ROOT / "data" / data / "geom.dat").read_bytes()
    want, els = expected(ROOT / "data" / data / "expected_jax_cpu_crccsd_t_spatial.json")
    got = rccsd_t.run(tmp_path, els, card, torch.float64)
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-8, (key, got[key], value)
    assert got["scf_iterations"] == els["scf_iterations"]
    assert got["cc_iterations"] == els["cc_iterations"]
