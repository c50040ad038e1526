"""The plain reference (`gpubench/reference/`) against the JAX package's
committed values, and each cell's controls (one layer in a lower
precision, `readings.py`) against the cells' limits.

CPU: H2O/cc-pVTZ (58 bf) from the committed inputs
(`data/h2o-cc-pvtz-2.00_104.45/`, ERIs `data/h2o-cc-pvtz/eri.dat`)
against `expected_jax_cpu_crccsd_t_spatial.json` (`rccsd_t`) and
`expected_jax_cpu.json` (`ccsd_t_spinorb`); the spin-orbital reference's
"paper" CCSD against the exact energy of two electrons, and its
strict-triangle (T) against the full cube.  Card (marked `gpu`, run with
`-m gpu`): the benchmark's own inputs at seed 0, the committed
geometries, for the dimer and the trimer against their committed JSON.

    python -m pytest gpubench/tests -q [-m gpu]
"""

from __future__ import annotations

import functools
import json
import shutil
from pathlib import Path

import pytest
import torch

from gpubench.harness import answers, spec
from gpubench.reference import ccsd_t_spinorb, cc, files, rccsd_t, scf

ROOT = Path(__file__).resolve().parents[2]
PVTZ = ROOT / "data" / "h2o-cc-pvtz-2.00_104.45"
PVTZ_ERI = ROOT / "data" / "h2o-cc-pvtz" / "eri.dat"
CELLS = ("dimer-crccsdt-hybrid", "trimer-crccsdt-f64", "dimer-ccsdt-spinorb-f64")
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


def spinorb_expected(path: Path) -> tuple[dict, dict]:
    """A committed spin-orbital JSON's values: its CCSD(T) is the CCSD
    and JAX's f64 (T) (`e_t_f64`; `e_ccsd_t_corr` holds the f32 tier's)."""
    want = json.loads(path.read_text())
    e_t = want["spinorb_triples"]["e_t_f64"] if "spinorb_triples" in want else want["e_t_f64"]
    values = {"e_hf": want["e_hf_total"], "e_mp2": want["e_mp2_corr"],
              "e_ccsd": want["e_ccsd_corr"], "e_ccsd_tt": want["e_ccsd_corr"] + e_t}
    return values, spec.parse_namelist(want.get("els_in") or (PVTZ / "els.in").read_text()) | {
        "scf_iterations": want["scf_iterations"], "cc_iterations": want["cc_iterations"]}


def test_spinorb_reference_matches_jax_at_pvtz(pvtz_dir):
    want, els = spinorb_expected(PVTZ / "expected_jax_cpu.json")
    assert els["calc_type"] == "CCSD(T)_spinorb"
    got = ccsd_t_spinorb.run(pvtz_dir, els, "cpu", torch.float64)
    for key, value in want.items():
        assert abs(got[key] - value) <= F64_TOL, (key, got[key], value)
    assert got["scf_iterations"] == els["scf_iterations"]
    assert got["cc_iterations"] == els["cc_iterations"]


# H2O/cc-pVDZ, 24 basis functions
TINY_CHARGES = [8, 1, 1]
TINY_COORDS = [[0.0, 0.0, -0.259099671344208], [0.0, -2.987363610796803, 2.056050018444942],
               [0.0, 2.987363610796803, 2.056050018444942]]


TIGHT = {"scf_e_tol": 1e-12, "scf_d_tol": 1e-10, "scf_diis_n_errmat": 6, "scf_maxiter": 150,
         "ccsd_e_tol": 1e-13, "ccsd_t_tol": 1e-12, "ccsd_diis_n_errmat": 8,
         "ccsd_maxiter": 300}


def make_inputs(directory: Path, charges, coords) -> Path:
    from gpubench import inputs

    inputs.make_inputs(directory, charges, coords, "cc-pvdz", seed=0, amplitude=0.01,
                       device="cpu")
    return directory


def two_electron_energy(directory: Path) -> float:
    """The exact (full CI) correlation energy of a two-electron closed
    shell: the lowest eigenvalue of H in the symmetric products of the
    RHF orbitals, less the RHF energy."""
    S = torch.as_tensor(files.read_matrix(directory / "s.dat"))
    n = S.shape[0]
    H = torch.as_tensor(files.read_matrix(directory / "t.dat")
                        + files.read_matrix(directory / "v.dat"))
    eri = files.dense_eri(files.packed_eri(directory, n), n, "cpu", torch.float64)
    hf = scf.rhf(S, H, eri, 1, e_tol=1e-12, d_tol=1e-10, n_errmat=6, maxiter=150)
    h = hf.coeff.T @ H @ hf.coeff
    one = torch.eye(n, dtype=torch.float64)
    Hm = (torch.einsum("pr,qs->pqrs", h, one) + torch.einsum("pr,qs->pqrs", one, h)
          + cc.ao_to_mo(eri, hf.coeff).permute(0, 2, 1, 3)).reshape(n * n, n * n)
    swap = torch.arange(n * n).reshape(n, n).T.reshape(-1)
    P = 0.5 * (torch.eye(n * n, dtype=torch.float64) + torch.eye(n * n, dtype=torch.float64)[swap])
    w, U = torch.linalg.eigh(P)
    B = U[:, w > 0.5]
    return float(torch.linalg.eigvalsh(B.T @ Hm @ B)[0]) - hf.energy


def test_spinorb_paper_ccsd_is_exact_for_two_electrons(tmp_path):
    """CCSD is exact for two electrons: H2/cc-pVDZ (10 bf).  (`rccsd_t`,
    the reference code's spin-free CCSD, is 1e-8 Ha off it here, and
    1.1e-4 Ha from the spin-orbital CCSD at H2O/cc-pVDZ.)"""
    d = make_inputs(tmp_path, [1, 1], [[0.0, 0.0, 0.0], [0.0, 0.0, 1.6]])
    els = TIGHT | {"calc_type": "CCSD_spinorb", "ccsd_spinorb_equations": "paper"}
    got = ccsd_t_spinorb.run(d, els, "cpu", torch.float64)
    assert abs(got["e_ccsd"] - two_electron_energy(d)) <= 1e-9


def test_spinorb_strict_triples_equal_the_full_cube(tmp_path):
    """The (T) summed over i<j<k with weight 6 is the full cube's, on
    H2O/cc-pVDZ's CCSD amplitudes."""
    d = make_inputs(tmp_path, TINY_CHARGES, TINY_COORDS)
    S = torch.as_tensor(files.read_matrix(d / "s.dat"))
    n = S.shape[0]
    H = torch.as_tensor(files.read_matrix(d / "t.dat") + files.read_matrix(d / "v.dat"))
    eri = files.dense_eri(files.packed_eri(d, n), n, "cpu", torch.float64)
    hf = scf.rhf(S, H, eri, 5, e_tol=1e-10, d_tol=1e-9, n_errmat=6, maxiter=150)
    g = ccsd_t_spinorb.spin_slices(cc.ao_to_mo(eri, hf.coeff), 5)
    levels = hf.levels.repeat_interleave(2)
    e_o, e_v = levels[:10], levels[10:]
    res = ccsd_t_spinorb.ccsd(g, e_o, e_v, paper=False, e_tol=1e-9, t_tol=1e-8, n_errmat=8,
                              maxiter=100)
    args = (res.t1, res.t2, g.vovv, g.ovoo, g.oovv, e_o, e_v)
    strict = ccsd_t_spinorb.triples(*args, strict=True, budget=1e8)
    cube = ccsd_t_spinorb.triples(*args, strict=False, budget=1e8)
    assert strict < -1e-3 and abs(strict - cube) <= 1e-14


# each cell's controls, as `readings.py --controls` names them (PERF.md,
# Findings, gives their readings at the cells' own sizes on the card)
CONTROLS = {
    "dimer-crccsdt-hybrid": ("reference:fock=float32", "reference:corr=float32",
                             "program:triples=hybrid", "reference:cr=bfloat16"),
    "trimer-crccsdt-f64": ("reference:fock=float32", "reference:corr=float32",
                           "program:ccsd_precision=hybrid", "program:triples=hybrid"),
    "dimer-ccsdt-spinorb-f64": ("reference:fock=float32", "reference:corr=float32",
                                "reference:triples=float32", "program:triples=hybrid",
                                "program:ccsd_precision=hybrid"),
}
# the committed pVTZ input of each formulation, and the reference module
PVTZ_ELS = {"rccsd_t": lambda: json.loads(
    (PVTZ / "expected_jax_cpu_crccsd_t_spatial.json").read_text())["els_in"],
    "ccsd_t_spinorb": lambda: (PVTZ / "els.in").read_text()}


class PvtzSession:
    """What `readings.run_control` asks of a run's session, at pVTZ on
    the CPU: the cell's mix on the committed pVTZ inputs."""

    def __init__(self, cell: str, pvtz_dir: Path, els_text: str):
        self.cell = spec.load_cell(ROOT, cell)
        self.cell.config = dict(self.cell.config, els_in=els_text)
        self.dir = pvtz_dir

    def reference(self, draw, dtype=None, lower=None):
        mod = {"rccsd_t": rccsd_t, "ccsd_t_spinorb": ccsd_t_spinorb}[
            self.cell.traffic["reference"]]
        return mod.run(self.dir, self.cell.settings(), "cpu", dtype or torch.float64, lower)

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
def test_each_control_fails_the_cells_limits(pvtz_dir, cell, control, monkeypatch):
    """A control put in the program's place reads at least one compared
    number above the cell's limit (at pVTZ here).  The spin-orbital (T)
    runs at "f64", as K1 on a card, unless the control sets its tier: the
    CPU's default is the f32 tier, itself a control."""
    from afesp_tpu_torch import driver

    from gpubench import readings

    monkeypatch.setattr(driver, "do_ccsd_t_spinorb",
                        functools.partial(driver.do_ccsd_t_spinorb, precision="f64"))
    reference = spec.load_cell(ROOT, cell).traffic["reference"]
    s = PvtzSession(cell, pvtz_dir, PVTZ_ELS[reference]())
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


@pytest.mark.gpu
def test_spinorb_reference_matches_jax_at_seed_0_on_the_card(card, tmp_path):
    from gpubench import inputs

    c = spec.load_cell(ROOT, "dimer-ccsdt-spinorb-f64")
    data = ROOT / "data" / "h2o-dimer-cc-pvtz"
    inputs.make_inputs(tmp_path, c.config["charges"], c.config["coords_bohr"],
                       c.config["basis"], seed=0, amplitude=0.01, device=card)
    assert (tmp_path / "geom.dat").read_bytes() == (data / "geom.dat").read_bytes()
    want, els = spinorb_expected(data / "expected_jax_cpu_ccsd_t_spinorb.json")
    got = ccsd_t_spinorb.run(tmp_path, els, card, torch.float64)
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-8, (key, got[key], value)
    assert got["scf_iterations"] == els["scf_iterations"] == 21
    assert got["cc_iterations"] == els["cc_iterations"] == 14
