"""GAMESS comparator — the run_gamess.py equivalent (utils/run_gamess.py).

Port of `afesp_tpu/utils/gamess.py:1-73`, the port's own copy (numpy
only; `SCRAPE`, `generate_input`, `scrape_output`, `run_gamess`).
GAMESS is the only external oracle for the renormalised R/CR-CC(T)
family (Psi4 does not implement them).  This module generates the
`cctyp=cr-cc` input decks and scrapes all six variant energies plus the
D[T]/D(T) denominators from GAMESS output — usable wherever a GAMESS
binary exists (none ships in this environment, so the scraper doubles as
a parser for archived .out files).
"""

from __future__ import annotations

import subprocess as sp
from pathlib import Path

import numpy as np

SCRAPE = [
    ("REFERENCE ENERGY:", "tail"),
    ("MBPT(2) ENERGY:", "corr"),
    (" CCSD    ENERGY:", "corr"),
    (" CCSD[T] ENERGY:", "corr"),
    (" CCSD(T) ENERGY:", "corr"),
    (" R-CCSD[T] ENERGY:", "corr"),
    (" R-CCSD(T) ENERGY:", "corr"),
    ("CR-CCSD[T] ENERGY:", "corr"),
    ("CR-CCSD(T) ENERGY:", "corr"),
    ("T1 DIAGNOSTIC", "tail"),
    (" R-CCSD[T] DENOMINATOR", "tail"),
    (" R-CCSD(T) DENOMINATOR", "tail"),
]


def generate_input(bl: float, dirname: str | Path, calc_name: str, basis: str,
                   symbol: str = "F", group: str = "dnh 2") -> Path:
    """Diatomic CR-CC input deck (run_gamess.py:8-22)."""
    geom_string = f"\n{group}\n\n{symbol}\n{symbol} 1 {bl}\n"
    path = Path(dirname) / f"{calc_name}.inp"
    with open(path, "w") as f:
        f.write(
            " $contrl scftyp=rhf coord=zmt runtyp=energy units=angs"
            " cctyp=cr-cc ispher=1 $end\n"
        )
        f.write(" $system mwords=100 memddi=500 $end\n")
        f.write(" $guess  guess=huckel $end\n")
        f.write(" $ccinp  maxcc=100 ncore=0 $end\n")
        f.write(f" $basis  {basis} $end\n")
        f.write(" $data\n")
        f.write(geom_string)
        f.write(" $end")
    return path


def scrape_output(lines) -> np.ndarray:
    """Extract the 12-value energy vector (run_gamess.py:31-59)."""
    energy = np.zeros(12)
    for line in lines:
        for i, (label, mode) in enumerate(SCRAPE):
            if label in line:
                if mode == "tail":
                    energy[i] = float(line.split(" ")[-1])
                else:
                    energy[i] = float(line.split("   CORR.E")[0].split(" ")[-1])
    return energy


def run_gamess(bl, gamess_dir, directory, calc_name, basis, symbol="F"):
    generate_input(bl, directory, calc_name, basis, symbol=symbol)
    out = sp.check_output(
        f"{gamess_dir} {calc_name} 00 1 1 1", cwd=directory, shell=True
    ).decode("utf-8").split("\n")
    (Path(directory) / f"{calc_name}.out").write_text("\n".join(out))
    return scrape_output(out)
