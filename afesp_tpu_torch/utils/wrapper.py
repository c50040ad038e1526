"""Binding-curve harness — the els_wrapper.py equivalent.

Port of `afesp_tpu/utils/wrapper.py` (`water_geometry` :41, `scrape`
:59, `run_point` :68, `binding_curve` :94).  Scans a bond length range
for H2O, writes the integral files with the port's engine, runs the
port's pipeline at each point with SCF-guess chaining
(els_wrapper.py:92-98), and writes `els_energy.dat` per point plus a
`binding_data_els.dat` table, scraping the same stdout labels
(els_wrapper.py:104-127).  Both the integrals and the pipeline run on
`device`.
"""

from __future__ import annotations

import io
import math
import shutil
from pathlib import Path

import numpy as np
import torch

from ..device import default_device
from ..driver import run_calculation
from ..integrals.generate import write_dat_files
from ..io.report import Reporter

SCRAPE_LABELS = [
    "RHF energy:",
    "MP2 energy:",
    " CCSD energy:",
    " CCSD[T] energy:",
    " CCSD(T) energy:",
    " R-CCSD[T] energy:",
    " R-CCSD(T) energy:",
    " CR-CCSD[T] energy:",
    " CR-CCSD(T) energy:",
    " T1 diagnostic:",
    " D[T]:",
    " D(T):",
]

ENERGY_NAMES = [
    "HF",
    "MP2",
    "CCSD",
    "CCSD[T]",
    "CCSD(T)",
    "R-CCSD[T]",
    "R-CCSD(T)",
    "CR-CCSD[T]",
    "CR-CCSD(T)",
    "T1 diagnostic",
    "D[T]",
    "D(T)",
]


def water_geometry(bond_angstrom: float, angle_deg: float):
    """Z-matrix H2O -> charges + cartesian bohr coordinates, centre of
    mass at the origin (standard atomic masses), C2v axis along z."""
    ang2bohr = 1.0 / 0.52917720859
    r = bond_angstrom * ang2bohr
    half = math.radians(angle_deg) / 2.0
    y = r * math.sin(half)
    z = r * math.cos(half)
    charges = np.array([8, 1, 1])
    coords = np.array([[0.0, 0.0, 0.0], [0.0, -y, z], [0.0, y, z]])
    masses = np.array([15.994915, 1.007825, 1.007825])
    com = (masses[:, None] * coords).sum(0) / masses.sum()
    return charges, coords - com


def scrape(text: str) -> np.ndarray:
    energy = np.zeros(12)
    for line in text.split("\n"):
        for i, label in enumerate(SCRAPE_LABELS):
            if label in line:
                energy[i] = float(line.split(" ")[-1])
    return energy


def run_point(workdir: Path, device: str | torch.device | None = None) -> np.ndarray:
    buf = io.StringIO()
    run_calculation(workdir, Reporter(stream=buf), device=device)
    text = buf.getvalue()
    (workdir / "els.out").write_text(text)
    e = scrape(text)
    with open(workdir / "els_energy.dat", "w") as f:
        for n, v in zip(ENERGY_NAMES, e):
            f.write(f"{n}: {v}\n")
    return e


def binding_curve(
    molname: str,
    basis: str,
    bl_lower: float,
    bl_upper: float,
    bl_step: float,
    ang: float,
    els_in_template: str,
    outdir: str | Path = ".",
    read_in: bool = True,
    device: str | torch.device | None = None,
):
    """Scan bond lengths, chaining SCF guesses (els_wrapper.py:92-98)."""
    dev = default_device(device)
    outdir = Path(outdir) / f"{molname}-{basis}"
    outdir.mkdir(parents=True, exist_ok=True)
    num_points = round((bl_upper - bl_lower) / bl_step + 1)
    rows = []
    prev_dir = None
    for bl in np.linspace(bl_lower, bl_upper, num_points):
        d = outdir / f"{bl:.2f}_{ang:.2f}"
        d.mkdir(exist_ok=True)
        charges, coords = water_geometry(bl, ang)
        write_dat_files(d, charges, coords, basis, device=dev)
        text = els_in_template
        if prev_dir is None or not read_in:
            text = text.replace("scf_read_guess = .true.", "scf_read_guess = .false.")
        (d / "els.in").write_text(text)
        if prev_dir is not None and read_in:
            guess = prev_dir / "guess_out.dat"
            if guess.exists():
                shutil.copy(guess, d / "guess_in.dat")
        e = run_point(d, dev)
        rows.append([bl, ang, *e])
        prev_dir = d
    table = np.array(rows)
    fmt = ["%5.3f", "%6.3f"] + ["%17.15f"] * 12
    np.savetxt(outdir / "binding_data_els.dat", table, fmt)
    return table
